"""Storage-engine semantics, ported 1:1 from the reference suite
(reference tests/test_storage_engine_in_memory.py — 17 tests, SURVEY.md §4) plus the
overwrite-by-id test the reference had to comment out (:46-57) because its Vector always
mints a fresh uuid4.
"""

import uuid

import numpy as np
import pytest

from mlvectordb_tpu.store import StorageEngine, Vector


@pytest.fixture
def storage(small_config):
    return StorageEngine(small_config)


def vec(vals, meta=None, vid=None):
    return Vector(vals, meta, id=vid)


def test_initial_state(storage):
    assert storage.total_vectors == 0
    assert storage.storage_size == 0
    assert storage.list_namespaces() == []


def test_write_read_roundtrip_float32(storage):
    v = vec([1.5, 2.5, 3.5], {"tag": "a"})
    storage.write(v, "ns")
    got = storage.read(v.id, "ns")
    assert got is not None
    assert got.values.dtype == np.float32
    np.testing.assert_array_equal(got.values, np.asarray([1.5, 2.5, 3.5], np.float32))
    assert got.metadata == {"tag": "a"}
    assert got.id == v.id


def test_overwrite_by_id_updates_values_and_metadata(storage):
    """True upsert — impossible in the reference (its commented-out test,
    test_storage_engine_in_memory.py:46-57)."""
    vid = uuid.uuid4()
    storage.write(vec([1.0, 2.0], {"v": 1}, vid), "ns")
    storage.write(vec([9.0, 8.0], {"v": 2}, vid), "ns")
    got = storage.read(vid, "ns")
    np.testing.assert_array_equal(got.values, np.asarray([9.0, 8.0], np.float32))
    assert got.metadata == {"v": 2}
    assert storage.total_vectors == 1


def test_batch_write(storage):
    vs = [vec(np.arange(4, dtype=np.float32) + i) for i in range(5)]
    storage.write_vectors(vs, "ns")
    assert storage.total_vectors == 5
    for v in vs:
        got = storage.read(v.id, "ns")
        np.testing.assert_array_equal(got.values, v.values)


def test_read_missing_returns_none(storage):
    assert storage.read(uuid.uuid4(), "ns") is None
    storage.write(vec([1.0]), "ns")
    assert storage.read(uuid.uuid4(), "ns") is None


def test_batch_read_with_missing_slot(storage):
    v1, v2 = vec([1.0, 0.0]), vec([0.0, 1.0])
    storage.write_vectors([v1, v2], "ns")
    missing = uuid.uuid4()
    got = storage.read_vectors([v1.id, missing, v2.id], "ns")
    assert got[0].id == v1.id
    assert got[1] is None
    assert got[2].id == v2.id


def test_delete_semantics_and_empty_namespace_gc(storage):
    v1, v2 = vec([1.0]), vec([2.0])
    storage.write_vectors([v1, v2], "ns")
    assert storage.delete(v1.id, "ns") is True
    assert storage.delete(v1.id, "ns") is False  # already gone
    assert storage.read(v1.id, "ns") is None
    assert "ns" in storage.list_namespaces()
    assert storage.delete(v2.id, "ns") is True
    # emptied namespace is garbage-collected (reference storage_engine_in_memory.py:49-50)
    assert "ns" not in storage.list_namespaces()


def test_exists_scans_all_namespaces(storage):
    v = vec([1.0, 2.0])
    storage.write(v, "ns-b")
    assert storage.exists(v.id)
    assert not storage.exists(uuid.uuid4())


def test_clear_all(storage):
    storage.write(vec([1.0]), "a")
    storage.write(vec([2.0]), "b")
    storage.clear_all()
    assert storage.total_vectors == 0
    assert storage.list_namespaces() == []


def test_namespace_listing_map_delete(storage):
    va, vb = vec([1.0, 2.0]), vec([3.0, 4.0])
    storage.write(va, "a")
    storage.write(vb, "b")
    assert sorted(storage.list_namespaces()) == ["a", "b"]
    nm = storage.namespace_map
    assert [v.id for v in nm["a"]] == [va.id]
    assert [v.id for v in nm["b"]] == [vb.id]
    assert storage.delete_namespace("a") is True
    assert storage.delete_namespace("a") is False
    assert storage.list_namespaces() == ["b"]


def test_storage_info_shape(storage):
    storage.write(vec([1.0, 2.0]), "ns")
    info = storage.get_storage_info()
    for key in (
        "storage_type",
        "total_vectors",
        "storage_size_bytes",
        "namespaces",
        "vectors_per_namespace",
        "namespace_count",
    ):
        assert key in info
    assert info["total_vectors"] == 1
    assert info["vectors_per_namespace"] == {"ns": 1}
    assert info["namespace_count"] == 1


def test_storage_size_monotonic(storage):
    storage.write(vec(np.ones(8, np.float32)), "ns")
    s1 = storage.storage_size
    # grow beyond initial capacity to force a re-alloc
    storage.write_vectors([vec(np.ones(8, np.float32)) for _ in range(200)], "ns")
    assert storage.storage_size >= s1
    assert storage.total_vectors == 201


def test_cross_namespace_isolation(storage):
    vid = uuid.uuid4()
    storage.write(vec([1.0, 2.0], None, vid), "a")
    assert storage.read(vid, "b") is None
    assert storage.read(vid, "a") is not None


def test_vector_eq_and_id_uniqueness():
    v1 = Vector([1.0, 2.0], {"x": 1})
    v2 = Vector([1.0, 2.0], {"x": 1})
    assert v1 != v2  # different minted ids
    assert v1 == Vector([1.0, 2.0], {"x": 1}, id=v1.id)
    assert v1 != Vector([1.0, 3.0], {"x": 1}, id=v1.id)


def test_deep_metadata_fidelity(storage):
    meta = {"a": {"b": [1, 2, {"c": None}]}, "d": None, "e": [True, "s"]}
    v = vec([1.0], meta)
    storage.write(v, "ns")
    assert storage.read(v.id, "ns").metadata == meta


def test_query_by_metadata(storage):
    v1 = vec([1.0, 0.0], {"color": "red", "n": 1})
    v2 = vec([0.0, 1.0], {"color": "blue", "n": 2})
    storage.write_vectors([v1, v2], "ns")
    got = storage.query_by_metadata({"color": "red"}, "ns")
    assert [v.id for v in got] == [v1.id]
    got = storage.query_by_metadata({"n": {"$gte": 1}}, "ns")
    assert {v.id for v in got} == {v1.id, v2.id}


def test_iterate_vectors(storage):
    vs = [vec([float(i)]) for i in range(3)]
    storage.write_vectors(vs, "ns")
    assert {v.id for v in storage.iterate_vectors("ns")} == {v.id for v in vs}
    assert list(storage.iterate_vectors("missing")) == []


def test_dimension_mismatch_rejected(storage):
    storage.write(vec([1.0, 2.0]), "ns")
    with pytest.raises(ValueError):
        storage.write(vec([1.0, 2.0, 3.0]), "ns")


def test_capacity_growth_preserves_data(storage, rng):
    vs = [vec(rng.standard_normal(16).astype(np.float32)) for _ in range(300)]
    storage.write_vectors(vs, "ns")  # forces several power-of-two growths from 64
    for v in vs[::37]:
        np.testing.assert_array_equal(storage.read(v.id, "ns").values, v.values)


def test_host_mirror_disabled_reads_from_device(small_config, rng):
    """host_mirror=False: reads fetch rows from HBM instead of the host copy —
    halves host memory for read-light deployments."""
    storage = StorageEngine(small_config, host_mirror=False)
    vs = [vec(rng.standard_normal(16).astype(np.float32), {"i": i}) for i in range(30)]
    storage.write_vectors(vs, "ns")
    got = storage.read(vs[7].id, "ns")
    np.testing.assert_allclose(got.values, vs[7].values, rtol=1e-6)
    assert got.metadata == {"i": 7}
    assert got.values.shape == (16,)
    # batch read + iterate work through the device-fetch path too
    got2 = storage.read_vectors([vs[1].id, vs[2].id], "ns")
    np.testing.assert_allclose(got2[0].values, vs[1].values, rtol=1e-6)
    assert {v.id for v in storage.iterate_vectors("ns")} == {v.id for v in vs}


def test_host_mirror_disabled_through_engine(small_config, rng):
    from mlvectordb_tpu import QueryProcessor, VectorDTO

    storage = StorageEngine(small_config, host_mirror=False)
    qp = QueryProcessor(storage, small_config)
    vs = qp.upsert_many(
        [VectorDTO(rng.standard_normal(8).astype(np.float32), {"i": i}) for i in range(20)], "ns"
    )
    res = qp.find_similar(VectorDTO(vs[3].values), top_k=2, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[3].id
    np.testing.assert_allclose(res[0]["values"], vs[3].values, rtol=1e-6)
    # delete + compaction keep working without host copies
    qp.delete([v.id for v in vs[:15]], "ns")
    res = qp.find_similar(VectorDTO(vs[17].values), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[17].id


def test_sweep_mirror_tracks_store(rng):
    """config.sweep_dtype maintains a transposed mirror that must equal data.T after
    every mutation class: upsert, overwrite, bulk load, growth, delete+compaction."""
    import jax
    import numpy as np
    from mlvectordb_tpu.config import EngineConfig
    from mlvectordb_tpu.store.namespace import NamespaceStore
    from mlvectordb_tpu.store.vector import Vector

    from mlvectordb_tpu.ops.pallas_knn_t import to_sweep_layout

    cfg = EngineConfig(
        initial_capacity=4096, capacity_multiple=4096, sweep_dtype="float32",
    )
    ns = NamespaceStore("m", cfg)

    def check():
        st = ns.device_state()
        assert st.data_t is not None
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(st.data_t)),
            np.asarray(jax.device_get(to_sweep_layout(st.data))),
        )

    vs = [Vector(rng.standard_normal(8).astype(np.float32), {"i": i}) for i in range(20)]
    ns.upsert(vs)
    check()
    ns.upsert([Vector(rng.standard_normal(8).astype(np.float32), {}, id=vs[3].id)])
    check()
    ns.bulk_upsert(rng.standard_normal((5000, 8)).astype(np.float32))  # forces growth
    assert ns.capacity == 8192
    check()
    ns.delete([v.id for v in vs[:10]])
    check()
    ns.compact()
    check()

    # disabled by default
    ns2 = NamespaceStore("n", EngineConfig())
    ns2.upsert(vs[:2])
    assert ns2.device_state().data_t is None
