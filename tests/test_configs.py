"""Engine configuration axes: bfloat16 storage, high-dimensional vectors (multi-lane
padding), metric defaults — the MSMARCO/OpenAI-1536d and DEEP-bf16 configs of
BASELINE.md exercised functionally."""

import jax.numpy as jnp
import numpy as np
import pytest

from mlvectordb_tpu import QueryProcessor, VectorDTO
from mlvectordb_tpu.config import EngineConfig


def dto(vals, meta=None, vid=None):
    return VectorDTO(values=vals, metadata=meta, id=vid)


@pytest.fixture
def bf16_config():
    return EngineConfig(
        dtype="bfloat16",
        initial_capacity=64,
        capacity_multiple=32,
        db_tile=128,
        query_buckets=(4, 16, 64),
        k_buckets=(8, 32),
    )


def test_bf16_storage_end_to_end(bf16_config, rng):
    qp = QueryProcessor(config=bf16_config)
    vs = qp.upsert_many(
        [dto(rng.standard_normal(32).astype(np.float32), {"i": i}) for i in range(64)], "ns"
    )
    ns = qp.storage.namespace("ns")
    import jax.numpy as jnp

    assert ns.device_state().data.dtype == jnp.bfloat16
    # planted exact-match neighbour must rank first despite bf16 quantization
    res = qp.find_similar(dto(vs[17].values), top_k=3, namespace="ns", metric="cosine")
    assert res[0]["id"] == vs[17].id
    assert res[0]["score"] > 0.99
    # host mirror returns the ORIGINAL float32 values, not the bf16-rounded rows
    got = qp.storage.read(vs[17].id, "ns")
    np.testing.assert_array_equal(got.values, vs[17].values)
    # storage accounting reflects 2-byte rows
    f32_qp = QueryProcessor(config=EngineConfig(
        initial_capacity=64, capacity_multiple=32))
    f32_qp.upsert_many([dto(v.values) for v in vs], "ns")
    assert qp.storage.storage_size < f32_qp.storage.storage_size


@pytest.mark.parametrize("dim", [200, 384, 1536])
def test_high_dimensional_vectors(small_config, rng, dim):
    qp = QueryProcessor(config=small_config)
    vs = qp.upsert_many(
        [dto(rng.standard_normal(dim).astype(np.float32)) for _ in range(40)], "ns"
    )
    ns = qp.storage.namespace("ns")
    assert ns.dpad % 128 == 0 and ns.dpad >= dim
    res = qp.find_similar(dto(vs[7].values), top_k=5, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[7].id
    assert res[0]["score"] == pytest.approx(0.0, abs=1e-3)
    assert res[0]["values"].shape == (dim,)

    # oracle parity at high dim
    q = rng.standard_normal(dim).astype(np.float32)
    res = qp.find_similar(dto(q), top_k=5, namespace="ns", metric="cosine")
    db = np.stack([v.values for v in vs])
    sims = db @ q / (np.linalg.norm(db, axis=1) * np.linalg.norm(q))
    assert {r["id"] for r in res} == {vs[i].id for i in np.argsort(-sims)[:5]}


def test_default_metric_config(rng):
    cfg = EngineConfig(default_metric="cosine", initial_capacity=64,
                       capacity_multiple=32)
    qp = QueryProcessor(config=cfg)
    qp.upsert_many([dto([1.0, 0.0]), dto([0.0, 1.0])], "ns")
    res = qp.find_similar(dto([1.0, 0.0]), top_k=2, namespace="ns")  # no metric arg
    # cosine => higher-better ordering
    assert res[0]["score"] == pytest.approx(1.0, abs=1e-6)
    assert res[0]["score"] >= res[1]["score"]


def test_metric_aliases_through_engine(small_config, rng):
    qp = QueryProcessor(config=small_config)
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(10)], "ns")
    q = dto(vs[0].values)
    for alias, canon in (("euclidean", "l2"), ("dot", "ip"), ("inner_product", "ip")):
        a = qp.find_similar(q, top_k=3, namespace="ns", metric=alias)
        c = qp.find_similar(q, top_k=3, namespace="ns", metric=canon)
        assert [r["id"] for r in a] == [r["id"] for r in c]


def test_sweep_mirror_end_to_end(rng, oracle):
    """sweep_dtype engine config: results stay oracle-exact through mutations (the
    store maintains the mirror through every path; capacities of two sweep tiles or
    more take the certified sweep, smaller ones the scan)."""
    from mlvectordb_tpu import QueryProcessor, VectorDTO
    from mlvectordb_tpu.config import EngineConfig

    cfg = EngineConfig(
        initial_capacity=64, capacity_multiple=32, sweep_dtype="bfloat16",
        query_buckets=(4, 16), k_buckets=(8, 32),
    )
    qp = QueryProcessor(config=cfg)
    vs = qp.upsert_many(
        [VectorDTO(rng.standard_normal(16).astype(np.float32), {"i": i}) for i in range(120)],
        "ns",
    )
    qp.delete([vs[5].id, vs[6].id], "ns")
    db = np.stack([v.values for i, v in enumerate(vs) if i not in (5, 6)])
    ids = [v.id for i, v in enumerate(vs) if i not in (5, 6)]
    q = rng.standard_normal(16).astype(np.float32)
    _, oidx = oracle(q[None, :], db, 5, "l2")
    got = qp.find_similar(VectorDTO(q), top_k=5, namespace="ns", metric="l2")
    assert [r["id"] for r in got] == [ids[i] for i in oidx[0]]
    st = qp.storage.namespace("ns").device_state()
    # below one SWEEP_TILE of capacity the window-major mirror doesn't exist (the
    # fused kernel disengages there anyway)
    assert st.data_t is None

    # at tile-aligned capacity the mirror exists, in sweep layout, tracking mutations
    from mlvectordb_tpu.ops.pallas_knn_t import to_sweep_layout

    cfg2 = EngineConfig(
        initial_capacity=4096, capacity_multiple=4096, sweep_dtype="bfloat16",
        query_buckets=(4, 16), k_buckets=(8, 32),
    )
    qp2 = QueryProcessor(config=cfg2)
    vs2 = qp2.upsert_many(
        [VectorDTO(rng.standard_normal(16).astype(np.float32), {"i": i}) for i in range(50)],
        "ns",
    )
    qp2.delete([vs2[3].id], "ns")
    qp2.upsert_many([VectorDTO(rng.standard_normal(16).astype(np.float32), id=vs2[7].id)], "ns")
    st2 = qp2.storage.namespace("ns").device_state()
    assert st2.data_t is not None and st2.data_t.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(st2.data_t),
        np.asarray(to_sweep_layout(st2.data, dtype=jnp.bfloat16)),
    )


def test_compact_rebuilds_sweep_err(rng):
    """Mixed f32-store/bf16-sweep config: compact() must rebuild the per-row
    bf16-rounding norms alongside the mirror — publishing a stale pre-compaction
    _sweep_err feeds wrong bounds into the exactness certificate (ADVICE r3 high:
    after a 16384->4096 compact the snapshot carried a 16384-length sweep_err)."""
    from mlvectordb_tpu.store.namespace import NamespaceStore

    cfg = EngineConfig(
        initial_capacity=4096, capacity_multiple=4096, sweep_dtype="bfloat16",
        sweep_resid=False,  # plain-sweep_err semantics; the resid path has its own test
    )
    ns = NamespaceStore("ns", cfg)
    ids = ns.bulk_upsert(rng.standard_normal((16384, 16)).astype(np.float32))
    st = ns.device_state()
    assert st.sweep_err is not None and st.sweep_err.shape == (16384,)

    ns.delete(ids[4096:])  # tombstone ratio trips the in-delete compaction
    st = ns.device_state()
    assert ns.capacity == 4096
    assert st.sweep_err is not None and st.sweep_err.shape == (ns.capacity,)
    # the published norms must match a fresh recompute from the compacted rows
    np.testing.assert_allclose(
        np.asarray(st.sweep_err), np.asarray(ns._build_sweep_err()), rtol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(st.sweep_err), np.asarray(ns._sweep_err))


def test_resid_mirror_tracks_mutations(rng):
    """Residual-corrected mixed config: the int8 codes, scales, and error norms must
    equal a fresh whole-store quantization after every mutation path (scatter upsert,
    overwrite, delete+compact, offload/restore)."""
    from mlvectordb_tpu.ops.pallas_knn_t import quantize_resid
    from mlvectordb_tpu.store.namespace import NamespaceStore

    cfg = EngineConfig(
        initial_capacity=4096, capacity_multiple=4096, sweep_dtype="bfloat16",
    )
    ns = NamespaceStore("ns", cfg)

    def check():
        st = ns.device_state()
        assert st.sweep_resid is not None and st.sweep_resid.dtype == jnp.int8
        resid, rscale, e2, e1 = quantize_resid(st.data)
        np.testing.assert_array_equal(np.asarray(st.sweep_resid), np.asarray(resid))
        np.testing.assert_allclose(np.asarray(st.sweep_rscale), np.asarray(rscale), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(st.sweep_err), np.asarray(e2), rtol=1e-4, atol=1e-9)
        np.testing.assert_allclose(np.asarray(st.sweep_err1), np.asarray(e1), rtol=1e-4, atol=1e-9)

    ids = ns.bulk_upsert(rng.standard_normal((5000, 16)).astype(np.float32) * 3.0)
    check()
    # overwrite some rows in place (per-vector path)
    from mlvectordb_tpu.store.vector import Vector

    ns.upsert([Vector(rng.standard_normal(16).astype(np.float32), {}, id=ids[7])])
    check()
    # capacity growth
    ns.bulk_upsert(rng.standard_normal((4000, 16)).astype(np.float32))
    check()
    # delete enough to trip compaction
    ns.delete(ids[:3000])
    check()
    # offload / page back in
    assert ns.offload()
    assert ns.ensure_resident()
    check()

    # sweep_resid=False opts out entirely
    ns2 = NamespaceStore("ns2", EngineConfig(
        initial_capacity=4096, capacity_multiple=4096, sweep_dtype="bfloat16",
        sweep_resid=False,
    ))
    ns2.bulk_upsert(rng.standard_normal((4096, 16)).astype(np.float32))
    st2 = ns2.device_state()
    assert st2.sweep_resid is None and st2.sweep_err is not None


def test_int8_resid_mirror_tracks_mutations(rng):
    """Two-level int8 sweep (sweep_dtype="int8" + sweep_resid, the default): codes,
    scales, and error norms for BOTH streams must equal a fresh whole-store
    quantization after every mutation path."""
    from mlvectordb_tpu.store.namespace import NamespaceStore

    cfg = EngineConfig(
        initial_capacity=4096, capacity_multiple=4096, sweep_dtype="int8",
    )
    ns = NamespaceStore("ns", cfg)

    from mlvectordb_tpu.ops.pallas_knn_t import sweep_cols_for_rows

    def check():
        # Exact code equality across mutation paths is NOT guaranteed (the scatter
        # and the wholesale rebuild are different jit programs, and XLA's FMA
        # fusion can flip round() by one unit near ties).  What the certificate's
        # soundness needs is that the PUBLISHED error norms bound the PUBLISHED
        # codes' true reconstruction error — that is what this pins, in f64.
        st = ns.device_state()
        assert st.data_t is not None and st.data_t.dtype == jnp.int8
        assert st.sweep_resid is not None and st.sweep_resid.dtype == jnp.int8
        data = np.asarray(st.data, np.float64)
        cols = sweep_cols_for_rows(np.arange(data.shape[0]))
        z1 = np.asarray(st.data_t, np.float64)[:, cols].T
        z2 = np.asarray(st.sweep_resid, np.float64)[:, cols].T
        s1 = np.asarray(st.sweep_rscale, np.float64)[:, None]
        s2 = np.asarray(st.sweep_rscale2, np.float64)[:, None]
        e2 = np.asarray(st.sweep_err, np.float64)
        e1 = np.asarray(st.sweep_err1, np.float64)
        true_e2 = np.linalg.norm(data - s1 * z1 - s2 * z2, axis=1)
        true_e1 = np.linalg.norm(data - s1 * z1, axis=1)
        # published bounds must cover the actual error (small atol: the published
        # norms were accumulated in f32)
        assert np.all(true_e2 <= e2 * (1 + 1e-3) + 1e-7), "sweep_err understates the codes' error"
        np.testing.assert_allclose(true_e1, e1, rtol=1e-3, atol=1e-7)
        live = e1 > 1e-12
        assert np.all(e2[live] <= e1[live] * 0.02 + 1e-12), "resid codes should kill ~99% of the band"

    ids = ns.bulk_upsert(rng.standard_normal((5000, 16)).astype(np.float32) * 2.0)
    check()
    from mlvectordb_tpu.store.vector import Vector

    ns.upsert([Vector(rng.standard_normal(16).astype(np.float32), {}, id=ids[7])])
    check()
    ns.bulk_upsert(rng.standard_normal((4000, 16)).astype(np.float32))  # growth
    check()
    ns.delete(ids[:3000])  # trips compaction
    check()
    assert ns.offload()
    assert ns.ensure_resident()
    check()


def test_int8_sweep_config_end_to_end(rng, oracle):
    """sweep_dtype="int8": the store maintains codes + dequant scales + error norms
    through every mutation path, and engine results stay oracle-exact (consistency is
    what this pins — the certified int8 path is covered in tests/test_pallas_t.py)."""
    from mlvectordb_tpu.ops.pallas_knn_t import quantize_int8
    from mlvectordb_tpu.store.namespace import NamespaceStore

    cfg = EngineConfig(
        initial_capacity=4096, capacity_multiple=4096, sweep_dtype="int8",
        sweep_resid=False,
    )
    ns = NamespaceStore("ns", cfg)

    def check():
        st = ns.device_state()
        assert st.data_t is not None and st.data_t.dtype == jnp.int8
        codes, rscale, err = quantize_int8(st.data)
        np.testing.assert_array_equal(np.asarray(st.data_t), np.asarray(codes))
        np.testing.assert_allclose(np.asarray(st.sweep_rscale), np.asarray(rscale), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(st.sweep_err), np.asarray(err), rtol=1e-4, atol=1e-9)
        assert st.sweep_resid is None

    ids = ns.bulk_upsert(rng.standard_normal((5000, 16)).astype(np.float32) * 2.0)
    check()
    ns.bulk_upsert(rng.standard_normal((4000, 16)).astype(np.float32))  # growth
    check()
    ns.delete(ids[:3000])  # trips compaction
    check()
    assert ns.offload() and ns.ensure_resident()
    check()

    # engine end-to-end stays oracle-exact with this config
    qp = QueryProcessor(config=cfg)
    vals = rng.standard_normal((4096, 16)).astype(np.float32)
    got_ids = qp.bulk_load(vals, "ns")
    q = rng.standard_normal(16).astype(np.float32)
    _, oidx = oracle(q[None, :], vals, 5, "l2")
    got = qp.find_similar(VectorDTO(q), top_k=5, namespace="ns", metric="l2")
    assert [r["id"] for r in got] == [got_ids[i] for i in oidx[0]]
