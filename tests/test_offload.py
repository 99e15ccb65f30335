"""HBM offload tier: cold namespaces vacate device memory, page back on first touch."""

import numpy as np
import pytest

from mlvectordb_tpu import QueryProcessor, VectorDTO


def dto(vals, meta=None, vid=None):
    return VectorDTO(values=vals, metadata=meta, id=vid)


@pytest.fixture
def qp(small_config):
    return QueryProcessor(config=small_config)


def test_offload_frees_device_and_search_pages_in(qp, rng, oracle):
    vs = qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32), {"i": i}) for i in range(50)], "cold"
    )
    ns = qp.storage.namespace("cold")
    assert qp.offload_namespace("cold") is True
    assert ns.offloaded and ns._data is None and ns._state is None
    assert qp.offload_namespace("cold") is False  # already offloaded
    assert qp.offload_namespace("ghost") is False

    # host-table reads work while offloaded (no page-in)
    got = qp.storage.read(vs[7].id, "cold")
    assert got is not None and got.metadata == {"i": 7}
    assert ns.offloaded

    # first search transparently pages back in; results oracle-exact
    q = rng.standard_normal(8).astype(np.float32)
    db = np.stack([v.values for v in vs])
    _, oidx = oracle(q[None, :], db, 5, "l2")
    res = qp.find_similar(dto(q), top_k=5, namespace="cold", metric="l2")
    assert [r["id"] for r in res] == [vs[i].id for i in oidx[0]]
    assert not ns.offloaded


def test_offload_then_write_pages_in_without_data_loss(qp, rng):
    vs = qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32)) for _ in range(30)], "cold"
    )
    qp.offload_namespace("cold")
    # a write while offloaded must restore first (NOT reallocate fresh zeros)
    extra = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32))], "cold")
    assert qp.get_namespace_count("cold") == 31
    res = qp.find_similar(dto(vs[3].values), top_k=1, namespace="cold", metric="l2")
    assert res[0]["id"] == vs[3].id and res[0]["score"] < 1e-6
    res = qp.find_similar(dto(extra[0].values), top_k=1, namespace="cold", metric="l2")
    assert res[0]["id"] == extra[0].id


def test_offload_with_sweep_mirror_rebuilds_it(rng):
    from mlvectordb_tpu.config import EngineConfig

    cfg = EngineConfig(initial_capacity=4096, capacity_multiple=4096,
                       sweep_dtype="float32")
    qp = QueryProcessor(config=cfg)
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(20)], "ns")
    ns = qp.storage.namespace("ns")
    qp.offload_namespace("ns")
    assert ns._data_t is None
    qp.restore_namespace("ns")
    st = ns.device_state()
    import jax
    from mlvectordb_tpu.ops.pallas_knn_t import to_sweep_layout
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(st.data_t)),
        np.asarray(jax.device_get(to_sweep_layout(st.data))),
    )


def test_storage_info_reports_offloaded(qp, rng):
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(5)], "a")
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(5)], "b")
    qp.offload_namespace("a")
    info = qp.get_storage_info()
    assert info["offloaded_namespaces"] == ["a"]
    assert info["total_vectors"] == 10  # counts unaffected
    assert qp.restore_namespace("a") is True
    assert qp.get_storage_info()["offloaded_namespaces"] == []


def test_sharded_offload_restores_shardings(rng):
    import jax
    from jax.sharding import PartitionSpec as P

    from mlvectordb_tpu.config import EngineConfig
    from mlvectordb_tpu.parallel import make_distributed_processor

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    cfg = EngineConfig(initial_capacity=64, capacity_multiple=32, db_tile=64,
                       query_buckets=(8, 64), k_buckets=(8, 32))
    qp = make_distributed_processor(n_replicas=2, n_shards=4, config=cfg)
    vs = qp.upsert_many([dto(rng.standard_normal(16).astype(np.float32)) for _ in range(100)], "ns")
    qp.offload_namespace("ns")
    res = qp.find_similar(dto(vs[5].values), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[5].id
    st = qp.storage.namespace("ns").device_state()
    assert st.data.sharding.spec == P("shard", None)


def test_offload_rest_endpoints(small_config, rng):
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from mlvectordb_tpu.api.rest_api import RestAPI

    async def runner():
        qp = QueryProcessor(config=small_config)
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING")
        client = TestClient(TestServer(api.app))
        await client.start_server()
        try:
            qp.upsert_many([dto(rng.standard_normal(4).astype(np.float32)) for _ in range(4)], "ns")
            r = await client.post("/namespaces/offload?namespace=ns")
            assert r.status == 200
            info = await (await client.get("/storage/info")).json()
            assert info["offloaded_namespaces"] == ["ns"]
            r = await client.post("/namespaces/offload?namespace=ns")
            assert r.status == 404  # already offloaded
            r = await client.post("/namespaces/restore?namespace=ns")
            assert r.status == 200
            info = await (await client.get("/storage/info")).json()
            assert info["offloaded_namespaces"] == []
        finally:
            await client.close()

    asyncio.run(runner())
