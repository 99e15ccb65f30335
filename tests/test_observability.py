"""Tracing spans, deep health, and their REST surface (SURVEY.md §5.1, §5.3 — subsystems
the reference lacks entirely)."""

import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from mlvectordb_tpu import QueryProcessor, VectorDTO
from mlvectordb_tpu.api.rest_api import RestAPI
from mlvectordb_tpu.utils.health import check_store_invariants, deep_health, probe_device
from mlvectordb_tpu.utils.tracing import RECORDER, SpanRecorder, trace_span


def test_span_recorder_aggregates():
    rec = SpanRecorder(max_spans=4)
    rec.record("x", 0.0, 0.010, {})
    rec.record("x", 0.0, 0.030, {})
    rec.record("y", 0.0, 0.005, {"k": 1})
    s = rec.summary()
    assert s["x"]["count"] == 2
    assert s["x"]["avg_ms"] == pytest.approx(20.0)
    assert s["x"]["max_ms"] == pytest.approx(30.0)
    assert rec.recent()[-1]["name"] == "y"
    assert rec.recent()[-1]["k"] == 1


def test_engine_emits_spans(small_config, rng):
    RECORDER.clear()
    qp = QueryProcessor(config=small_config)
    qp.upsert_many(
        [VectorDTO(rng.standard_normal(8).astype(np.float32), {"i": i}) for i in range(20)],
        "ns",
    )
    qp.find_similar(VectorDTO(rng.standard_normal(8).astype(np.float32)), 3, "ns")
    qp.find_similar(
        VectorDTO(rng.standard_normal(8).astype(np.float32)), 3, "ns",
        filter={"i": {"$lt": 5}},
    )
    qp.delete([], "ns")
    s = RECORDER.summary()
    for name in ("upsert", "knn_kernel", "hydrate", "filter_mask", "delete"):
        assert name in s, f"missing span {name}; have {list(s)}"
    assert s["knn_kernel"]["count"] == 2


def test_probe_device_and_invariants(small_config, rng):
    p = probe_device()
    assert p["ok"] is True
    assert p["device_count"] >= 1

    qp = QueryProcessor(config=small_config)
    qp.upsert_many([VectorDTO(rng.standard_normal(4).astype(np.float32)) for _ in range(5)], "ns")
    inv = check_store_invariants(qp.storage)
    assert inv["ok"] is True

    report = deep_health(qp)
    assert report["status"] == "healthy"
    assert report["total_vectors"] == 5

    # corrupt an invariant -> degraded
    ns = qp.storage.namespace("ns")
    ns._slot_ids[0] = None
    inv = check_store_invariants(qp.storage)
    assert inv["ok"] is False


def test_rest_health_deep_and_trace(small_config):
    async def runner():
        qp = QueryProcessor(config=small_config)
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING")
        client = TestClient(TestServer(api.app))
        await client.start_server()
        try:
            resp = await client.get("/health")
            assert (await resp.json())["status"] == "healthy"

            resp = await client.get("/health?deep=1")
            assert resp.status == 200
            body = await resp.json()
            assert body["device"]["ok"] is True
            assert "native_filter_engine" in body

            await client.post(
                "/vectors?namespace=ns", json={"values": [1.0, 2.0]}
            )
            await client.post("/search?namespace=ns", json={"query": [1.0, 2.0]})
            resp = await client.get("/trace")
            body = await resp.json()
            assert "knn_kernel" in body["summary"]
            assert any(sp["name"] == "upsert" for sp in body["recent"])

            # profiler misuse -> 409, not 500
            resp = await client.post("/profile/stop")
            assert resp.status == 409
        finally:
            await client.close()

    asyncio.run(runner())


def test_capacity_planner():
    from mlvectordb_tpu.config import EngineConfig
    from mlvectordb_tpu.utils.capacity import plan_capacity

    # SIFT-1M f32 on a 16 GB device: trivially fits
    p = plan_capacity(1_000_000, 128, hbm_per_chip=16 * 1024**3)
    assert p.fits_single_chip and p.min_shards == 1
    assert p.dim_padded == 128 and p.bytes_per_vector == 512

    # MSMARCO 100M x 1536 bf16 needs several devices
    cfg = EngineConfig(dtype="bfloat16")
    p = plan_capacity(100_000_000, 1536, cfg, hbm_per_chip=95 * 1024**3)
    assert not p.fits_single_chip
    assert p.min_shards >= 4
    assert p.bytes_per_vector == 1536 * 2

    # padding is accounted (100-d pads to 128 lanes)
    p = plan_capacity(10_000, 100, hbm_per_chip=16 * 1024**3)
    assert p.dim_padded == 128


class _FakeDevice:
    def __init__(self, kind, stats=None):
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_capacity_table_knows_the_h100():
    from mlvectordb_tpu.utils.capacity import _detect_hbm

    assert _detect_hbm(_FakeDevice("NVIDIA H100 80GB HBM3")) == 80 * 10**9
    # the runtime's own limit wins when it reports one
    assert _detect_hbm(_FakeDevice("NVIDIA H100 80GB HBM3", {"bytes_limit": 123})) == 123


def test_capacity_unknown_device_is_an_error():
    from mlvectordb_tpu.utils.capacity import _detect_hbm

    with pytest.raises(ValueError, match="hbm_per_chip"):
        _detect_hbm(_FakeDevice("Some Accelerator", {}))


def test_prometheus_metrics_endpoint(small_config, rng):
    async def runner():
        qp = QueryProcessor(config=small_config)
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING")
        client = TestClient(TestServer(api.app))
        await client.start_server()
        try:
            await client.post("/vectors?namespace=ns", json={"values": [1.0, 2.0]})
            await client.post("/search?namespace=ns", json={"query": [1.0, 2.0]})
            resp = await client.get("/metrics")
            assert resp.status == 200
            assert "text/plain" in resp.headers["Content-Type"]
            text = await resp.text()
            assert 'vectordb_queries_total{type="knn"} 1' in text
            assert "vectordb_vectors_total 1" in text
            assert 'vectordb_namespace_vectors{namespace="ns"} 1' in text
            assert "# TYPE vectordb_span_avg_ms gauge" in text
        finally:
            await client.close()

    asyncio.run(runner())
