"""Distributed-layer tests on the host-simulated 8-device CPU mesh (conftest forces
XLA_FLAGS=--xla_force_host_platform_device_count=8 — the reference has no distributed
tests to port because it has no distribution; SURVEY.md §2.2, §4)."""

import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlvectordb_tpu import VectorDTO
from mlvectordb_tpu.parallel import (
    ReplicationManager,
    ShardingManager,
    build_mesh,
    make_distributed_processor,
)
from mlvectordb_tpu.ops.topk import exact_knn

pytestmark = pytest.mark.usefixtures("eight_devices")


def dto(vals, meta=None, vid=None):
    return VectorDTO(values=vals, metadata=meta, id=vid)


@pytest.fixture
def mesh24():
    return build_mesh(2, 4)


def test_mesh_shapes():
    m = build_mesh(2, 4)
    assert m.shape == {"replica": 2, "shard": 4}
    m = build_mesh(1)
    assert m.shape == {"replica": 1, "shard": 8}
    with pytest.raises(ValueError):
        build_mesh(3)


def test_shard_routing_deterministic(mesh24):
    sm = ShardingManager(mesh24)
    assert sm.all_shards() == [0, 1, 2, 3]
    vid = uuid.uuid4()
    assert sm.shard_for_id(vid) == sm.shard_for_id(vid)
    assert 0 <= sm.shard_for_id(vid) < 4
    # distribution sanity: 256 ids spread over all shards
    counts = [0] * 4
    for _ in range(256):
        counts[sm.shard_for_id(uuid.uuid4())] += 1
    assert all(c > 20 for c in counts)


def test_sharded_knn_matches_single_device(mesh24, rng, oracle):
    sm = ShardingManager(mesh24)
    N, D, B, K = 1024, 64, 8, 5
    db = rng.standard_normal((N, D), dtype=np.float32)
    q = rng.standard_normal((B, D), dtype=np.float32)
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    valid = np.ones(N, bool)

    data_s, valid_s, sq_s = sm.place_database(
        jnp.asarray(db), jnp.asarray(valid), jnp.asarray(sq)
    )
    d, i = sm.sharded_knn(jnp.asarray(q), data_s, valid_s, sq_s, k=K, metric="l2", db_tile=256)

    o_dist, o_idx = oracle(q, db, K, "l2")
    np.testing.assert_allclose(np.asarray(d), o_dist, rtol=2e-4, atol=2e-4)
    for b in range(B):
        assert set(np.asarray(i)[b].tolist()) == set(o_idx[b].tolist())


def test_sharded_knn_respects_tombstones(mesh24, rng):
    sm = ShardingManager(mesh24)
    N, D = 512, 32
    db = rng.standard_normal((N, D), dtype=np.float32)
    sq = (db ** 2).sum(-1)
    q = db[:4] + 0.001
    valid = np.ones(N, bool)
    valid[0] = False
    data_s, valid_s, sq_s = sm.place_database(
        jnp.asarray(db), jnp.asarray(valid), jnp.asarray(sq)
    )
    d, i = sm.sharded_knn(jnp.asarray(q), data_s, valid_s, sq_s, k=3, metric="l2", db_tile=128)
    assert 0 not in np.asarray(i)[0].tolist()


def test_distributed_processor_end_to_end(rng, small_config):
    qp = make_distributed_processor(2, 4, small_config)
    vs = qp.upsert_many(
        [dto(rng.standard_normal(16).astype(np.float32), {"i": i}) for i in range(200)], "ns"
    )
    assert qp.get_namespace_count("ns") == 200

    # exact-match search through the full sharded stack
    res = qp.find_similar(dto(vs[42].values), top_k=3, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[42].id
    assert res[0]["score"] == pytest.approx(0.0, abs=1e-5)

    # cross-check against numpy oracle
    q = rng.standard_normal(16).astype(np.float32)
    res = qp.find_similar(dto(q), top_k=10, namespace="ns", metric="cosine")
    db = np.stack([v.values for v in vs])
    sims = db @ q / (np.linalg.norm(db, axis=1) * np.linalg.norm(q))
    oracle_ids = {vs[i].id for i in np.argsort(-sims)[:10]}
    assert {r["id"] for r in res} == oracle_ids

    # delete flows through the sharded store
    removed = qp.delete([vs[42].id], "ns")
    assert removed == [vs[42].id]
    res = qp.find_similar(dto(vs[42].values), top_k=3, namespace="ns", metric="l2")
    assert vs[42].id not in [r["id"] for r in res]

    # filtered (hybrid) search over shards
    res = qp.find_similar(dto(q), top_k=50, namespace="ns", filter={"i": {"$lt": 20}})
    assert len(res) == 20 or len(res) == 19  # 42 not in range; 0..19 minus any deleted
    assert all(r["metadata"]["i"] < 20 for r in res)


def test_distributed_upsert_overwrites_in_place(rng, small_config):
    qp = make_distributed_processor(1, 8, small_config)
    vid = uuid.uuid4()
    qp.upsert_many([dto([1.0, 0.0, 0.0, 0.0], {"v": 1}, vid)], "ns")
    qp.upsert_many([dto([0.0, 0.0, 0.0, 1.0], {"v": 2}, vid)], "ns")
    assert qp.get_namespace_count("ns") == 1
    res = qp.find_similar(dto([0.0, 0.0, 0.0, 1.0]), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vid and res[0]["score"] == pytest.approx(0.0, abs=1e-6)


def test_sharded_capacity_growth(rng, small_config):
    qp = make_distributed_processor(1, 4, small_config)
    vs = qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32)) for _ in range(50)], "ns"
    )
    ns = qp.storage.namespace("ns")
    cap0 = ns.capacity
    vs += qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32)) for _ in range(500)], "ns"
    )
    assert ns.capacity > cap0
    # data survives growth: every sampled vector still retrievable and searchable
    for v in vs[::83]:
        got = qp.storage.read(v.id, "ns")
        np.testing.assert_array_equal(got.values, v.values)
        res = qp.find_similar(dto(v.values), top_k=1, namespace="ns", metric="l2")
        assert res[0]["id"] == v.id


def test_sharded_compaction_preserves_search(rng, small_config):
    qp = make_distributed_processor(1, 4, small_config)
    vs = qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32)) for _ in range(100)], "ns"
    )
    qp.delete([v.id for v in vs[:60]], "ns")  # triggers per-shard compaction
    ns = qp.storage.namespace("ns")
    assert ns._tombstones == 0
    res = qp.find_similar(dto(vs[80].values), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[80].id
    assert qp.get_namespace_count("ns") == 40


def test_replication_reconcile_consistent(mesh24, rng):
    rm = ReplicationManager(mesh24)
    sm = ShardingManager(mesh24)
    assert rm.members() == [0, 1]
    db = rng.standard_normal((256, 32), dtype=np.float32)
    valid = np.ones(256, bool)
    data_s, valid_s, _ = sm.place_database(
        jnp.asarray(db), jnp.asarray(valid), jnp.asarray((db ** 2).sum(-1))
    )
    report = rm.reconcile(data_s, valid_s)
    assert report["consistent"] is True
    assert len(report["fingerprints"]) == 2
    assert report["fingerprints"][0] == report["fingerprints"][1]


def test_replication_detects_divergence(mesh24, rng):
    """Forge per-device buffers that differ between replicas; reconcile must flag it."""
    rm = ReplicationManager(mesh24)
    N, D, S = 256, 32, 4
    base = rng.standard_normal((N, D), dtype=np.float32)
    corrupted = base.copy()
    corrupted[0, 0] += 100.0  # replica 1's copy diverges

    from jax.sharding import NamedSharding, PartitionSpec as P

    spec2d = NamedSharding(mesh24, P("shard", None))
    spec1d = NamedSharding(mesh24, P("shard"))
    per = N // S
    bufs = []
    for (r, s), dev in np.ndenumerate(np.array(mesh24.devices)):
        src = base if r == 0 else corrupted
        bufs.append(jax.device_put(src[s * per : (s + 1) * per], dev))
    data = jax.make_array_from_single_device_arrays((N, D), spec2d, bufs)
    vb = [
        jax.device_put(np.ones(per, bool), dev)
        for (r, s), dev in np.ndenumerate(np.array(mesh24.devices))
    ]
    valid = jax.make_array_from_single_device_arrays((N,), spec1d, vb)

    report = rm.reconcile(data, valid)
    assert report["consistent"] is False
    assert report["divergent_replicas"] == [1]


def _forge_divergent(mesh24, base, corrupted):
    """Build a [N, D] array sharded P('shard', None) whose replica-1 copies hold
    ``corrupted`` instead of ``base`` (simulated silent divergence)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    N, D = base.shape
    S = mesh24.shape["shard"]
    per = N // S
    spec2d = NamedSharding(mesh24, P("shard", None))
    spec1d = NamedSharding(mesh24, P("shard"))
    bufs, vb = [], []
    for (r, s), dev in np.ndenumerate(np.array(mesh24.devices)):
        src = base if r == 0 else corrupted
        bufs.append(jax.device_put(src[s * per : (s + 1) * per], dev))
        vb.append(jax.device_put(np.ones(per, bool), dev))
    data = jax.make_array_from_single_device_arrays((N, D), spec2d, bufs)
    valid = jax.make_array_from_single_device_arrays((N,), spec1d, vb)
    return data, valid


def test_replication_repair_restores_consistency(mesh24, rng):
    """VERDICT r2 #5: repair re-broadcasts the healthy (majority/lowest) replica's
    rows on device and fingerprints must agree afterwards."""
    rm = ReplicationManager(mesh24)
    base = rng.standard_normal((256, 32), dtype=np.float32)
    corrupted = base.copy()
    corrupted[5, :] += 100.0
    data, valid = _forge_divergent(mesh24, base, corrupted)

    data2, valid2, report = rm.repair(data, valid)
    assert report["repaired"] is True
    assert report["source"] == 0  # tie between 2 fingerprints -> lowest replica id
    assert report["consistent_after"] is True
    assert rm.reconcile(data2, valid2)["consistent"] is True
    np.testing.assert_allclose(np.asarray(jax.device_get(data2)), base)
    # consistent input is a no-op
    _d, _v, rep2 = rm.repair(data2, valid2)
    assert rep2["repaired"] is False


def test_store_reconcile_and_repair_end_to_end(rng, small_config):
    """Corrupt one replica's device rows inside a live sharded store; repair must
    restore fingerprint equality AND exact search results."""
    qp = make_distributed_processor(2, 4, small_config)
    vs = qp.upsert_many(
        [dto(rng.standard_normal(16).astype(np.float32)) for _ in range(64)], "ns"
    )
    ns = qp.storage.namespace("ns")
    rm = qp.replication_manager
    host = np.asarray(jax.device_get(ns._data))
    bad = host.copy()
    bad[:4] += 50.0  # replica 1 silently diverges on a few rows
    forged, _ = _forge_divergent(rm.mesh, host, bad)
    ns._data = forged
    ns._publish()

    report = ns.reconcile_and_repair(rm)
    assert report["repaired"] is True and report["consistent_after"] is True
    assert rm.reconcile(ns._data, ns._valid)["consistent"] is True
    res = qp.find_similar(dto(vs[17].values), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[17].id and res[0]["score"] == 0.0
    # second call reports consistent without touching state
    v0 = ns.version
    assert ns.reconcile_and_repair(rm)["repaired"] is False
    assert ns.version == v0


def test_sharded_compaction_preserves_ivf(rng, small_config):
    from mlvectordb_tpu import VectorDTO as V

    qp = make_distributed_processor(1, 4, small_config)
    vs = qp.upsert_many(
        [V(rng.standard_normal(8).astype(np.float32)) for _ in range(100)], "ns"
    )
    qp.build_ivf("ns", n_clusters=4)
    qp.delete([v.id for v in vs[:60]], "ns")  # triggers per-shard compaction
    ns = qp.storage.namespace("ns")
    assert ns._tombstones == 0 and ns.ivf is not None
    res = qp.find_similar(VectorDTO(values=vs[80].values), top_k=1, namespace="ns", nprobe=4)
    assert res[0]["id"] == vs[80].id


def test_sharded_store_maintains_transposed_mirror(rng, oracle):
    """sweep_dtype on a sharded namespace: the [D, cap] window-major mirror is sharded
    on its column axis (shard-locally permuted), tracks every mutation class, and
    sharded_search stays oracle-exact."""
    from mlvectordb_tpu.config import EngineConfig
    from mlvectordb_tpu.ops.pallas_knn_t import to_sweep_layout

    cfg = EngineConfig(
        initial_capacity=4096, capacity_multiple=4096, db_tile=64,
        query_buckets=(8, 64), k_buckets=(8, 32), sweep_dtype="float32",
    )
    qp = make_distributed_processor(n_replicas=2, n_shards=4, config=cfg)
    vs = qp.upsert_many(
        [dto(rng.standard_normal(16).astype(np.float32), {"i": i}) for i in range(200)],
        "ns",
    )
    ns = qp.storage.namespace("ns")
    st = ns.device_state()
    assert st.data_t is not None

    def check(st):
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(st.data_t)),
            np.asarray(jax.device_get(
                to_sweep_layout(st.data, shard_cap=ns.shard_capacity)
            )),
        )

    check(st)
    from jax.sharding import PartitionSpec as P

    assert st.data_t.sharding.spec == P(None, "shard")

    # growth (per-shard 4096 -> 8192 columns) keeps the mirror consistent
    qp.bulk_load(rng.standard_normal((18000, 16)).astype(np.float32), "ns")
    assert ns.shard_capacity > 4096 and ns.shard_capacity % 4096 == 0
    check(ns.device_state())

    # search through the mirror-passing sharded path stays oracle-exact
    qp.delete([vs[3].id], "ns")
    live = [v for v in qp.get_namespace_vectors("ns")]
    db = np.stack([v.values for v in live])
    q = rng.standard_normal(16).astype(np.float32)
    _, oidx = oracle(q[None, :], db, 5, "l2")
    got = qp.find_similar(dto(q), top_k=5, namespace="ns", metric="l2")
    assert [r["id"] for r in got] == [live[i].id for i in oidx[0]]


def test_sharded_ivf_matches_single_device_oracle(rng, small_config):
    """Per-shard IVF (VERDICT r2 #2): the cluster-sharded probe search must return
    exactly what the single-device IVF kernel returns on the SAME generation arrays,
    with identical nprobe semantics, and the inverted lists must actually be spread
    over the mesh's shard axis."""
    from jax.sharding import PartitionSpec as P

    from mlvectordb_tpu.store.ivf import _ivf_search

    qp = make_distributed_processor(2, 4, small_config)
    vs = qp.upsert_many(
        [dto(rng.standard_normal(16).astype(np.float32), {"i": i}) for i in range(400)],
        "ns",
    )
    stats = qp.build_ivf("ns", n_clusters=8, seed=3)
    assert stats["sharded"] is True and stats["shards"] == 4
    ns = qp.storage.namespace("ns")
    g = ns.ivf._gen

    # memory is cluster-sharded: [C, L, Dp] split over 'shard', 2 clusters per shard
    assert g.data3.sharding.spec == P("shard", None, None)
    assert g.valid3.sharding.spec == P("shard", None)
    shard_bytes = {
        s.data.nbytes for s in g.data3.addressable_shards
    }
    assert shard_bytes == {g.data3.nbytes // 4}

    # oracle: the single-device probe kernel on gathered copies of the same generation
    B, k = 8, 10
    q = np.zeros((B, ns.dpad), np.float32)
    q[:, :16] = rng.standard_normal((B, 16)).astype(np.float32)
    for nprobe in (1, 3, 8):
        d_sh, i_sh = qp.sharding_manager.sharded_ivf_probe(
            jnp.asarray(q), g.centroids, g.cnorms, g.data3, g.valid3, g.sqn3,
            k=k, metric="l2", nprobe=nprobe,
        )
        d_1, i_1 = _ivf_search(
            jnp.asarray(q),
            jnp.asarray(np.asarray(jax.device_get(g.centroids))),
            jnp.asarray(np.asarray(jax.device_get(g.cnorms))),
            jnp.asarray(np.asarray(jax.device_get(g.data3))),
            jnp.asarray(np.asarray(jax.device_get(g.valid3))),
            jnp.asarray(np.asarray(jax.device_get(g.sqn3))),
            k=k, metric="l2", nprobe=nprobe,
        )
        d_sh, i_sh = np.asarray(d_sh), np.asarray(i_sh)
        d_1, i_1 = np.asarray(d_1), np.asarray(i_1)
        from mlvectordb_tpu.ops.distances import MASKED

        for b in range(B):
            live_sh = d_sh[b] < MASKED / 2
            live_1 = d_1[b] < MASKED / 2
            assert set(i_sh[b][live_sh]) == set(i_1[b][live_1]), (nprobe, b)
            np.testing.assert_allclose(
                np.sort(d_sh[b][live_sh]), np.sort(d_1[b][live_1]), rtol=1e-5
            )

    # end-to-end engine path: nprobe=C probes everything => exact => oracle ids
    qv = rng.standard_normal(16).astype(np.float32)
    res = qp.find_similar(dto(qv), top_k=10, namespace="ns", metric="l2", nprobe=8)
    db = np.stack([v.values for v in vs])
    oracle_ids = {vs[i].id for i in np.argsort(((db - qv) ** 2).sum(-1))[:10]}
    assert {r["id"] for r in res} == oracle_ids

    # incremental add/delete keep the sharded layout and stay searchable
    new = qp.upsert_many(
        [dto(rng.standard_normal(16).astype(np.float32)) for _ in range(16)], "ns"
    )
    qp.delete([vs[0].id], "ns")
    g2 = ns.ivf._gen
    assert g2.data3.sharding.spec == P("shard", None, None)
    res = qp.find_similar(dto(new[0].values), top_k=1, namespace="ns", nprobe=8)
    assert res[0]["id"] == new[0].id


def test_sharded_ivf_snapshot_roundtrip(tmp_path, rng, small_config):
    """Sharded IVF persists and restores with the cluster sharding re-applied."""
    from jax.sharding import PartitionSpec as P

    qp = make_distributed_processor(1, 8, small_config)
    qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32)) for _ in range(300)], "ns"
    )
    qp.build_ivf("ns", n_clusters=16, seed=1)
    before = qp.find_similar(
        dto(rng.standard_normal(8).astype(np.float32)), top_k=5, namespace="ns", nprobe=4
    )
    qp.save(str(tmp_path / "snap"))

    from mlvectordb_tpu.engine.query_processor import QueryProcessor
    from mlvectordb_tpu.engine.persist import load_storage
    from mlvectordb_tpu.parallel import ShardingManager, build_mesh
    from mlvectordb_tpu.parallel.store import ShardedNamespaceStore
    from mlvectordb_tpu.store.storage import StorageEngine

    sm = ShardingManager(build_mesh(1, 8))
    storage = StorageEngine(
        small_config,
        namespace_factory=lambda name: ShardedNamespaceStore(name, sm, small_config),
    )
    qp2 = QueryProcessor(
        load_storage(str(tmp_path / "snap"), small_config, storage=storage), small_config
    )
    ns2 = qp2.storage.namespace("ns")
    assert ns2.ivf is not None and ns2.ivf._gen.data3.sharding.spec == P("shard", None, None)
    after = qp2.find_similar(
        dto(np.asarray(before[0]["values"], np.float32)), top_k=5, namespace="ns", nprobe=4
    )
    assert after[0]["id"] == before[0]["id"] or len(after) == 5


def test_sharded_bulk_load_across_growths_keeps_every_row(rng):
    """Bulk loads in batches much smaller than the final shard capacity grow the store
    several times; every row must keep its own slot (a grown region handed out twice
    overwrote rows) and stay searchable."""
    from mlvectordb_tpu.config import EngineConfig

    qp = make_distributed_processor(
        1, 4, EngineConfig(initial_capacity=64, capacity_multiple=32))
    X = rng.standard_normal((4096, 16)).astype(np.float32)
    ids = qp.bulk_load(X, "g", batch_rows=128)
    ns = qp.storage.namespace("g")
    slots = np.array([ns._id_to_slot[i] for i in ids])
    assert len(set(slots.tolist())) == len(ids)
    st = ns.device_state()
    np.testing.assert_array_equal(np.asarray(st.data)[slots, :16], X)
    assert int(np.asarray(st.valid).sum()) == len(ids)
    hits = qp.find_similar_batch([dto(X[i]) for i in range(0, 4096, 512)], top_k=1,
                                 namespace="g", metric="l2")
    assert [h[0]["id"] for h in hits] == [ids[i] for i in range(0, 4096, 512)]
