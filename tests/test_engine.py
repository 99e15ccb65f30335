"""Query-processor component tests.

Ports the reference suite's semantics (reference tests/test_query_processor.py — ranking
against a numpy oracle, namespace isolation, delete-through-the-stack, top_k clamping;
SURVEY.md §4) and extends to the widened capability surface: true upsert, range /
similarity / metadata / hybrid queries, per-metric correctness, compaction isolation,
statistics, explain, and snapshot persistence.
"""

import uuid

import numpy as np
import pytest

from mlvectordb_tpu import QueryProcessor, VectorDTO
from mlvectordb_tpu.config import HIGHER_IS_BETTER


@pytest.fixture
def qp(small_config):
    return QueryProcessor(config=small_config)


def dto(vals, meta=None, vid=None):
    return VectorDTO(values=vals, metadata=meta, id=vid)


def test_insert_lands_in_storage_with_metadata(qp):
    v = qp.insert(dto([1.0, 2.0, 3.0], {"k": "v"}), "ns")
    got = qp.storage.read(v.id, "ns")
    assert got is not None
    np.testing.assert_array_equal(got.values, np.asarray([1.0, 2.0, 3.0], np.float32))
    assert got.metadata == {"k": "v"}


def test_ranking_matches_numpy_cosine_oracle(qp, rng):
    # the reference's flagship test (test_query_processor.py:52-67), kept approx-equal
    np.random.seed(42)
    vecs = [dto(rng.standard_normal(10).astype(np.float32)) for _ in range(100)]
    inserted = qp.upsert_many(vecs, "ns")
    q = rng.standard_normal(10).astype(np.float32)

    res = qp.find_similar(dto(q), top_k=5, namespace="ns", metric="cosine")
    db = np.stack([v.values for v in inserted])
    sims = db @ q / (np.linalg.norm(db, axis=1) * np.linalg.norm(q))
    order = np.argsort(-sims)[:5]
    expected = [(inserted[i].id, sims[i]) for i in order]

    assert len(res) == 5
    for r, (eid, escore) in zip(res, expected):
        assert r["id"] == eid
        assert r["score"] == pytest.approx(float(escore), rel=1e-4)
    # scores sorted best-first (cosine: higher is better)
    scores = [r["score"] for r in res]
    assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine", "euclidean", "dot"])
def test_metric_actually_selects_distance(qp, rng, oracle, metric):
    """Unlike the reference — whose metric arg only flips a sign convention while the
    hnswlib space stays frozen (SURVEY.md §3.3) — metric here selects the real distance."""
    from mlvectordb_tpu.config import canonical_metric

    m = canonical_metric(metric)
    vecs = [dto(rng.standard_normal(16).astype(np.float32)) for _ in range(50)]
    inserted = qp.upsert_many(vecs, "ns")
    q = rng.standard_normal(16).astype(np.float32)
    res = qp.find_similar(dto(q), top_k=7, namespace="ns", metric=metric)

    db = np.stack([v.values for v in inserted])
    o_dist, o_idx = oracle(q[None], db, 7, m)
    expected_ids = [inserted[i].id for i in o_idx[0]]
    assert [r["id"] for r in res] == expected_ids
    for r, d in zip(res, o_dist[0]):
        want = 1.0 - d if HIGHER_IS_BETTER[m] else d
        assert r["score"] == pytest.approx(float(want), rel=2e-3, abs=2e-3)


def test_namespace_isolation_through_stack(qp, rng):
    a = qp.insert(dto([1.0, 0.0]), "a")
    qp.insert(dto([1.0, 0.0]), "b")
    res = qp.find_similar(dto([1.0, 0.0]), top_k=10, namespace="a", metric="l2")
    assert [r["id"] for r in res] == [a.id]


def test_missing_namespace_returns_empty(qp):
    assert qp.find_similar(dto([1.0, 2.0]), namespace="nope") == []


def test_delete_removes_from_storage_and_search(qp, rng):
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(20)], "ns")
    victim = vs[3]
    removed = qp.delete([victim.id], "ns")
    assert removed == [victim.id]
    assert qp.storage.read(victim.id, "ns") is None
    res = qp.find_similar(dto(victim.values), top_k=20, namespace="ns")
    assert victim.id not in [r["id"] for r in res]


def test_delete_missing_ids_returns_only_removed(qp):
    v = qp.insert(dto([1.0]), "ns")
    ghost = uuid.uuid4()
    assert qp.delete([ghost, v.id], "ns") == [v.id]


def test_topk_clamped_to_corpus(qp, rng):
    qp.upsert_many([dto(rng.standard_normal(4).astype(np.float32)) for _ in range(5)], "ns")
    res = qp.find_similar(dto(rng.standard_normal(4).astype(np.float32)), top_k=50, namespace="ns")
    assert len(res) == 5
    # best-first for l2 default: ascending distance
    scores = [r["score"] for r in res]
    assert scores == sorted(scores)


def test_uuid_results_on_larger_corpus(qp, rng):
    qp.upsert_many([dto(rng.standard_normal(10).astype(np.float32)) for _ in range(100)], "ns")
    res = qp.find_similar(dto(rng.standard_normal(10).astype(np.float32)), top_k=5, namespace="ns")
    assert len(res) == 5
    for r in res:
        assert isinstance(r["id"], uuid.UUID)
        assert isinstance(r["score"], float)
        assert r["values"].shape == (10,)


def test_true_upsert_overwrites_and_search_sees_new_values(qp):
    vid = uuid.uuid4()
    qp.upsert_many([dto([1.0, 0.0, 0.0], {"v": 1}, vid)], "ns")
    qp.upsert_many([dto([0.0, 0.0, 1.0], {"v": 2}, vid)], "ns")
    assert qp.get_namespace_count("ns") == 1
    res = qp.find_similar(dto([0.0, 0.0, 1.0]), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vid
    assert res[0]["score"] == pytest.approx(0.0, abs=1e-6)
    assert res[0]["metadata"] == {"v": 2}


def test_batched_search_matches_single(qp, rng):
    qp.upsert_many([dto(rng.standard_normal(12).astype(np.float32)) for _ in range(64)], "ns")
    qs = [dto(rng.standard_normal(12).astype(np.float32)) for _ in range(9)]
    batched = qp.find_similar_batch(qs, top_k=4, namespace="ns", metric="cosine")
    for q, b in zip(qs, batched):
        single = qp.find_similar(q, top_k=4, namespace="ns", metric="cosine")
        assert [r["id"] for r in single] == [r["id"] for r in b]


def test_range_search_l2(qp):
    qp.upsert_many([dto([float(i), 0.0]) for i in range(10)], "ns")
    hits = qp.range_search(dto([0.0, 0.0]), radius=4.5, namespace="ns", metric="l2")
    # squared distances: 0,1,4 <= 4.5
    assert len(hits) == 3
    assert [h["score"] for h in hits] == sorted(h["score"] for h in hits)


def test_similarity_threshold_search(qp):
    qp.upsert_many([dto([1.0, 0.0]), dto([0.0, 1.0]), dto([0.7071, 0.7071])], "ns")
    hits = qp.similarity_search(dto([1.0, 0.0]), threshold=0.5, namespace="ns")
    assert len(hits) == 2  # itself (sim 1.0) and the 45-degree vector (~0.707)
    assert all(h["score"] >= 0.5 for h in hits)


def test_metadata_filtered_hybrid_search(qp, rng):
    red, blue = [], []
    for i in range(30):
        color = "red" if i % 2 == 0 else "blue"
        v = qp.insert(dto(rng.standard_normal(8).astype(np.float32), {"color": color, "i": i}), "ns")
        (red if color == "red" else blue).append(v)
    q = dto(rng.standard_normal(8).astype(np.float32))
    res = qp.find_similar(q, top_k=30, namespace="ns", filter={"color": "red"})
    assert len(res) == 15
    assert {r["id"] for r in res} == {v.id for v in red}
    res = qp.find_similar(q, top_k=5, namespace="ns", filter={"i": {"$lt": 4}})
    assert {r["id"] for r in res} <= {v.id for v in red + blue if v.metadata["i"] < 4}
    assert len(res) == 4


def test_query_by_metadata_endpoint_shape(qp):
    v = qp.insert(dto([1.0], {"tag": "x"}), "ns")
    res = qp.query_by_metadata({"tag": "x"}, "ns")
    assert [r["id"] for r in res] == [v.id]
    assert res[0]["score"] == 0.0


def test_compaction_is_per_namespace(qp, rng, small_config):
    """The reference's rebuild wipes other namespaces' indexes (SURVEY.md §3.4).
    Deleting enough to trigger compaction in 'a' must leave 'b' searchable."""
    a = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(40)], "a")
    b = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(40)], "b")
    # delete 30/40 in a -> tombstone ratio >= rebuild_threshold -> compaction
    qp.delete([v.id for v in a[:30]], "a")
    ns_a = qp.storage.namespace("a")
    assert ns_a._tombstones == 0  # compaction ran and reset the counter
    res_b = qp.find_similar(dto(b[0].values), top_k=1, namespace="b", metric="l2")
    assert res_b[0]["id"] == b[0].id
    res_a = qp.find_similar(dto(a[35].values), top_k=1, namespace="a", metric="l2")
    assert res_a[0]["id"] == a[35].id


def test_explain_and_statistics(qp, rng):
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(10)], "ns")
    plan = qp.explain_query(dto(np.zeros(8, np.float32)), top_k=3, namespace="ns")
    assert plan["exact"] is True and plan["expected_recall"] == 1.0
    assert plan["k_effective"] == 3 and plan["live_vectors"] == 10
    qp.find_similar(dto(rng.standard_normal(8).astype(np.float32)), top_k=3, namespace="ns")
    qp.range_search(dto(rng.standard_normal(8).astype(np.float32)), 1.0, "ns")
    stats = qp.get_statistics()
    assert stats["total_queries"] == 2
    assert stats["queries_by_type"] == {"knn": 1, "range": 1}


def test_snapshot_roundtrip(qp, rng, tmp_path, small_config):
    vs = qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32), {"i": i}) for i in range(25)], "ns"
    )
    qp.insert(dto([1.0, 2.0], {"other": True}), "ns2")
    qp.save(str(tmp_path / "snap"))

    qp2 = QueryProcessor.load(str(tmp_path / "snap"), small_config)
    assert sorted(qp2.list_namespaces()) == ["ns", "ns2"]
    assert qp2.get_namespace_count("ns") == 25
    got = qp2.storage.read(vs[7].id, "ns")
    np.testing.assert_array_equal(got.values, vs[7].values)
    assert got.metadata == {"i": 7}
    res = qp2.find_similar(dto(vs[3].values), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[3].id


def test_rest_helper_surface(qp):
    v = qp.insert(dto([1.0, 2.0], {"m": 1}), "ns")
    assert qp.list_namespaces() == ["ns"]
    assert qp.get_namespace_count("ns") == 1
    assert qp.get_namespace_count("missing") == 0
    vecs = qp.get_namespace_vectors("ns")
    assert [x.id for x in vecs] == [v.id]
    info = qp.get_storage_info()
    assert info["total_vectors"] == 1


def test_auto_snapshot_roundtrip(qp, rng, tmp_path, small_config):
    import time

    vs = qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32), {"i": i}) for i in range(10)], "ns"
    )
    snap = str(tmp_path / "auto")
    qp.start_auto_snapshot(snap, interval_s=0.2)
    try:
        deadline = time.time() + 10
        import os
        while not os.path.isdir(snap) and time.time() < deadline:
            time.sleep(0.05)
        assert os.path.isdir(snap)
        # mutate and wait for a second snapshot generation
        qp.insert(dto([9.0] * 8, {"late": True}), "ns")
        count0 = qp.get_statistics()["queries_by_type"].get("auto_snapshot", 0)
        deadline = time.time() + 10
        while (
            qp.get_statistics()["queries_by_type"].get("auto_snapshot", 0) <= count0
            and time.time() < deadline
        ):
            time.sleep(0.05)
    finally:
        qp.stop_auto_snapshot()

    qp2 = QueryProcessor.load(snap, small_config)
    assert qp2.get_namespace_count("ns") == 11
    res = qp2.find_similar(dto([9.0] * 8), top_k=1, namespace="ns", metric="l2")
    assert res[0]["metadata"] == {"late": True}

    with pytest.raises(RuntimeError):
        qp.start_auto_snapshot(snap, 0.2)
        qp.start_auto_snapshot(snap, 0.2)
    qp.stop_auto_snapshot()


def test_warmup_precompiles_buckets(qp, rng):
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(30)], "ns")
    ns = qp.storage.namespace("ns")
    version, capacity, hw = ns.version, ns.capacity, ns._high_water
    # no tombstones yet: auto mode warms the fast live-prefix variant only — the
    # masked kernel is unreachable for plain kNN traffic here (VERDICT r3 #5)
    ran = qp.warmup("ns", ks=(3,), batches=(1, 16), metrics=("l2",))
    assert ran == 2  # 2 distinct batch buckets x fast variant
    # filtered-query deployments opt the masked variant in explicitly
    assert qp.warmup("ns", ks=(3,), batches=(1, 16), metrics=("l2",), include_masked=True) == 4
    # batches that land in the SAME bucket compile the same program: deduped
    assert qp.warmup("ns", ks=(3,), batches=(1, 4), metrics=("l2",)) == 1
    # warmup is strictly side-effect-free: no sentinel insert/delete/compaction
    assert qp.get_namespace_count("ns") == 30
    assert (ns.version, ns.capacity, ns._high_water) == (version, capacity, hw)
    assert qp.warmup("missing") == 0
    # detail mode: per-program compile-seconds report (the /warmup bill)
    ran, report = qp.warmup("ns", ks=(3,), batches=(1,), metrics=("l2",),
                            detail=True, include_masked=True)
    assert ran == 2 and set(report) == {"b4_k8_l2_fast", "b4_k8_l2_masked"}
    assert all(isinstance(v, float) for v in report.values())
    assert qp.warmup("missing", detail=True) == (0, {})
    # tombstones present: serving dispatches the masked variant, so auto warms it
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32))], "ns")
    qp.delete([vs[0].id], "ns")
    if qp.storage.namespace("ns")._high_water != qp.get_namespace_count("ns"):
        assert qp.warmup("ns", ks=(3,), batches=(1,), metrics=("l2",)) == 2


def test_result_cache_not_resurrected_across_namespace_incarnations(qp, rng):
    """GC-pop + recreate restarts version numbering at the same values; the result
    cache must key on the store's incarnation, not (name, version) (ADVICE r1 #1)."""
    q = rng.standard_normal(8).astype(np.float32)
    a = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(4)], "ns")
    first = qp.find_similar(dto(q), top_k=2, namespace="ns", metric="l2")
    assert first
    qp.delete([v.id for v in a], "ns")          # last delete GC-pops the namespace
    assert "ns" not in qp.storage.list_namespaces()
    b = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(4)], "ns")
    second = qp.find_similar(dto(q), top_k=2, namespace="ns", metric="l2")
    new_ids = {v.id for v in b}
    assert all(r["id"] in new_ids for r in second), "stale incarnation served from cache"


def test_result_cache_miss_path_returns_independent_copies(qp, rng):
    """Mutating the FIRST (cache-miss) response must not poison later hits
    (ADVICE r1 #3 — the hit path copied, the store path did not)."""
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32), {"tag": i}) for i in range(4)], "ns")
    q = rng.standard_normal(8).astype(np.float32)
    miss = qp.find_similar(dto(q), top_k=2, namespace="ns", metric="l2")
    miss[0]["score"] = -12345.0
    miss[0]["metadata"] = {"poisoned": True}
    hit = qp.find_similar(dto(q), top_k=2, namespace="ns", metric="l2")
    assert hit[0]["score"] != -12345.0
    assert hit[0]["metadata"] != {"poisoned": True}


def test_search_uses_snapshot_counters_not_live_attributes(qp, rng):
    """A reader pairing an OLD data snapshot with a NEW high-water mark would admit
    never-written all-zero rows (l2 dist |q|^2 = 0 for a zero query) (ADVICE r1 #2)."""
    qp.upsert_many([dto((rng.standard_normal(8) + 5.0).astype(np.float32)) for _ in range(6)], "ns")
    ns = qp.storage.namespace("ns")
    # simulate the torn interleaving mid-upsert: host tables (_id_to_slot, _high_water)
    # already advanced, device scatter/_publish still pending — live_count == high_water
    # again, so the buggy live-attribute read would turn the live-prefix fast path ON
    # over the OLD snapshot, admitting 7 never-written all-zero rows
    import uuid as uuid_mod

    fakes = {uuid_mod.uuid4(): ns._high_water + i for i in range(7)}
    ns._id_to_slot.update(fakes)
    ns._high_water += 7
    try:
        res = qp.find_similar(dto(np.zeros(8, np.float32)), top_k=3, namespace="ns", metric="l2")
        assert len(res) == 3
        assert all(r["score"] > 1.0 for r in res), "phantom zero-row admitted into top-k"
    finally:
        for vid in fakes:
            ns._id_to_slot.pop(vid)
        ns._high_water -= 7


def test_bulk_load_matches_per_vector_path(qp, rng, small_config):
    vals = rng.standard_normal((300, 8)).astype(np.float32)
    metas = [{"i": i} for i in range(300)]
    ids = qp.bulk_load(vals, "ns", metadatas=metas)
    assert len(ids) == 300 and qp.get_namespace_count("ns") == 300
    # content identical to what upsert_many would produce
    got = qp.storage.read(ids[137], "ns")
    np.testing.assert_array_equal(got.values, vals[137])
    assert got.metadata == {"i": 137}
    # searchable + filterable immediately
    res = qp.find_similar(dto(vals[42]), top_k=1, namespace="ns", metric="l2")
    # abs tolerance covers f32 rounding of the expanded form (qn + qn - 2*qn ~ ulp-scale)
    assert res[0]["id"] == ids[42] and res[0]["score"] == pytest.approx(0.0, abs=1e-4)
    res = qp.find_similar(dto(vals[10]), top_k=5, namespace="ns", filter={"i": {"$lt": 5}})
    assert all(r["metadata"]["i"] < 5 for r in res) and len(res) == 5

    # explicit-id bulk overwrite
    qp.bulk_load(np.ones((1, 8), np.float32), "ns", ids=[ids[0]], metadatas=[{"new": 1}])
    assert qp.get_namespace_count("ns") == 300
    assert qp.storage.read(ids[0], "ns").metadata == {"new": 1}

    # multi-batch path
    ids2 = qp.bulk_load(rng.standard_normal((100, 8)).astype(np.float32), "ns2", batch_rows=32)
    assert len(ids2) == 100 and qp.get_namespace_count("ns2") == 100


def test_bulk_load_keeps_ivf_in_sync(qp, rng):
    vals = rng.standard_normal((100, 8)).astype(np.float32)
    qp.bulk_load(vals, "ns")
    qp.build_ivf("ns", n_clusters=4)
    new_vals = rng.standard_normal((20, 8)).astype(np.float32)
    new_ids = qp.bulk_load(new_vals, "ns")
    res = qp.find_similar(dto(new_vals[3]), top_k=1, namespace="ns", nprobe=4)
    assert res[0]["id"] == new_ids[3]


def test_result_cache_hits_and_invalidates(qp, rng):
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(20)], "ns")
    q = dto(vs[3].values)
    r1 = qp.find_similar(q, top_k=3, namespace="ns", metric="l2")
    r2 = qp.find_similar(q, top_k=3, namespace="ns", metric="l2")
    assert r2 == r1
    assert qp._result_cache_hits == 1
    assert qp.get_statistics()["queries_by_type"].get("cache_hit") == 1
    # any mutation bumps the namespace version -> implicit invalidation
    nv = qp.insert(dto(vs[3].values), "ns")  # exact duplicate, closer than everything else
    r3 = qp.find_similar(q, top_k=3, namespace="ns", metric="l2")
    assert qp._result_cache_hits == 1  # miss after mutation
    assert {r3[0]["id"], r3[1]["id"]} == {vs[3].id, nv.id}


def test_result_cache_disabled(rng, small_config):
    import dataclasses

    cfg = dataclasses.replace(small_config, result_cache_size=0)
    qp = QueryProcessor(config=cfg)
    vs = qp.upsert_many([dto(rng.standard_normal(4).astype(np.float32)) for _ in range(5)], "ns")
    q = dto(vs[0].values)
    qp.find_similar(q, 2, "ns")
    qp.find_similar(q, 2, "ns")
    assert qp._result_cache_hits == 0 and not qp._result_cache


def test_result_cache_evicts_lru_not_all(rng, small_config):
    """One query past capacity must evict only the least-recently-used entry, not
    wipe the whole cache (VERDICT r2 weak #5)."""
    import dataclasses

    from mlvectordb_tpu import QueryProcessor, VectorDTO

    cfg = dataclasses.replace(small_config, result_cache_size=3)
    qp = QueryProcessor(config=cfg)
    qp.upsert_many(
        [VectorDTO(rng.standard_normal(8).astype(np.float32)) for _ in range(30)], "ns"
    )
    queries = [rng.standard_normal(8).astype(np.float32) for _ in range(4)]
    for q in queries[:3]:
        qp.find_similar(VectorDTO(q), top_k=2, namespace="ns")
    assert len(qp._result_cache) == 3
    # touch q0 (making q1 the LRU), then insert q3 -> q1 evicted, q0/q2 retained
    hits0 = qp._result_cache_hits
    qp.find_similar(VectorDTO(queries[0]), top_k=2, namespace="ns")
    assert qp._result_cache_hits == hits0 + 1
    qp.find_similar(VectorDTO(queries[3]), top_k=2, namespace="ns")
    assert len(qp._result_cache) == 3
    hits1 = qp._result_cache_hits
    qp.find_similar(VectorDTO(queries[0]), top_k=2, namespace="ns")  # hit
    qp.find_similar(VectorDTO(queries[2]), top_k=2, namespace="ns")  # hit
    assert qp._result_cache_hits == hits1 + 2
    qp.find_similar(VectorDTO(queries[1]), top_k=2, namespace="ns")  # was evicted
    assert qp._result_cache_hits == hits1 + 2


def test_adaptive_certified_dispatch_switches_on_escalation(rng, monkeypatch):
    """Adaptive certificate tiering: namespaces start on the LIGHT single-pass
    certified program; a tier-2 escalation warms the heavy residual-corrected
    program in the background and flips dispatch to it.  The backend is faked so
    the tier sequence is scripted; results flow through the real scan."""
    import time as _time

    import jax.numpy as _jnp

    from mlvectordb_tpu import QueryProcessor, VectorDTO
    from mlvectordb_tpu.config import EngineConfig
    from mlvectordb_tpu.engine import query_processor as qp_mod
    from mlvectordb_tpu.ops.topk import exact_knn

    seen = []  # (sweep_light, report_tier) per backend call

    def fake_knn_backend(config):
        def backend(q, data, valid, sq_norms, *, k, metric, db_tile,
                    live_prefix=None, data_t=None, sweep_err=None, sweep_resid=None,
                    sweep_rscale=None, sweep_err1=None, sweep_rscale2=None,
                    report_tier=False, sweep_light=False, sweep_prep=None):
            seen.append((sweep_light, report_tier))
            d, i = exact_knn(q, data, valid, sq_norms, k=k, metric=metric,
                             db_tile=db_tile)
            if report_tier:
                # light program always "escalates" in this fake; heavy certifies
                return d, i, _jnp.int32(2 if sweep_light else 0)
            return d, i
        return backend

    monkeypatch.setattr(qp_mod, "knn_backend", fake_knn_backend)

    cfg = EngineConfig(
        initial_capacity=4096, capacity_multiple=4096, sweep_dtype="bfloat16",
        query_buckets=(4, 16), k_buckets=(8,),
    )
    qp = QueryProcessor(config=cfg)
    qp.storage.namespace("ns", create=True).bulk_upsert(
        rng.standard_normal((4096, 16)).astype(np.float32))
    st = qp.storage.namespace("ns").device_state()
    assert st.sweep_resid is not None  # both variants exist -> adaptive applies

    q = rng.standard_normal(16).astype(np.float32)
    qp.find_similar(VectorDTO(q), top_k=3, namespace="ns", metric="l2")
    assert seen[0][0] is True, "first dispatch must be the light program"
    # the escalation spawns a background heavy warm; wait for the switch
    deadline = _time.time() + 10.0
    mode_key = ("ns", "l2", False)  # unfiltered l2 traffic triggered the escalation
    while qp._cert_mode.get(mode_key) != "heavy" and _time.time() < deadline:
        _time.sleep(0.02)
    assert qp._cert_mode.get(mode_key) == "heavy", "escalation must flip dispatch to heavy"
    tiers = qp.cert_tier_counts("ns")
    assert tiers.get("light_exact_scan", 0) >= 1

    qp.find_similar(VectorDTO(q + 1.0), top_k=3, namespace="ns", metric="l2")
    assert seen[-1][0] is False, "post-switch dispatch must be the heavy program"
    assert qp.cert_tier_counts("ns").get("fast", 0) >= 1

    # explain/statistics surface the dispatch state and tier counters
    ex = qp.explain_query([0.0] * 16, namespace="ns")
    assert ex["certificate_dispatch"] == "heavy"
    stats = qp.get_statistics()
    assert "ns" in stats["exactness"]["tiers_by_namespace"]

    # the flip is PER (metric, masked-variant): the heavy warm only compiled the
    # l2 unfiltered bucket grid, so cosine traffic must stay on the (always-
    # compiled) light program instead of stalling on a cold heavy compile
    # (no explain assertion here: this cosine call escalates in the fake too and
    # spawns its own background warm, so the mode may flip at any moment after —
    # and that warm's backend call appends to ``seen`` concurrently, so the
    # cosine dispatch is read at its own index, not seen[-1])
    n_before = len(seen)
    qp.find_similar(VectorDTO(q), top_k=3, namespace="ns", metric="cosine")
    assert seen[n_before][0] is True, "cosine variant must stay light after an l2 flip"


def test_filter_prep_scoped_inside_snapshot(qp):
    """Filtered searches nest their prep under ("filter", key) INSIDE the
    snapshot's own prep dict, so prep lives and dies with the snapshot's arrays —
    a mutation publishes a fresh dict and stale filter prep can never survive it
    (version-keyed side caches have a poisoning window because writers bump
    ns.version before publishing)."""
    import numpy as np

    from mlvectordb_tpu.filters import filter_cache_key
    from mlvectordb_tpu.interfaces.vector import VectorDTO

    rng = np.random.default_rng(0)
    vs = qp.upsert_many(
        [VectorDTO(rng.standard_normal(16).astype(np.float32), {"g": i % 2})
         for i in range(64)], "f")
    ns = qp.storage.namespace("f")
    spec = {"g": 0}
    q = VectorDTO(vs[0].values)
    r1 = qp.find_similar(q, top_k=5, namespace="f", metric="euclidean", filter=spec)
    assert all(v["metadata"]["g"] == 0 for v in r1)
    state1 = ns.device_state()
    key = ("filter", filter_cache_key(spec))
    assert key in state1.prep_cache  # nested scope created by the filtered search
    qp.upsert_many([VectorDTO(rng.standard_normal(16).astype(np.float32), {"g": 0})], "f")
    state2 = ns.device_state()
    assert state2.prep_cache is not state1.prep_cache  # fresh dict per publish
    assert key not in state2.prep_cache
    r2 = qp.find_similar(q, top_k=5, namespace="f", metric="euclidean", filter=spec)
    assert all(v["metadata"]["g"] == 0 for v in r2)


def test_heavy_warm_uses_filter_scoped_prep():
    """A FILTERED escalation's background heavy-warm must fill the per-(filter,
    version) prep dict, never the snapshot's own prep cache — a masked prep built
    from the filter-ANDed liveness filed under the snapshot's keys would make later
    unfiltered tombstone-masked searches rank (and certify) against rows the old
    filter excluded (round-4 self-review finding #1)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mlvectordb_tpu.config import EngineConfig
    from mlvectordb_tpu.engine.query_processor import QueryProcessor
    from mlvectordb_tpu.ops.pallas_knn_t import SWEEP_TILE

    config = EngineConfig(sweep_dtype="bfloat16")
    qp = QueryProcessor(config=config)
    rng = np.random.default_rng(0)
    n = 2 * SWEEP_TILE
    qp.bulk_load(rng.standard_normal((n, 128)).astype(np.float32), "w")
    ns = qp.storage.namespace("w")
    state = ns.device_state()
    fmask = np.zeros(n, bool)
    fmask[: n // 2] = True
    valid = jnp.logical_and(state.valid, jnp.asarray(fmask))
    filter_prep: dict = {}

    import time as _time

    qp._warm_heavy_then_switch("w", state, 8, 8, "l2", None, valid,
                               prep_cache=filter_prep)
    deadline = _time.time() + 180
    while _time.time() < deadline:
        with qp._cert_lock:
            if not qp._heavy_warms:
                break
        _time.sleep(0.2)
    assert qp._cert_mode.get(("w", "l2", True)) == "heavy"
    assert not any(not isinstance(k2, tuple) or k2[0] != "filter"
                   for k2 in state.prep_cache), (
        "heavy warm filed filter-scoped prep under the snapshot's own keys"
    )
    assert filter_prep, "heavy warm should have populated the filter-scoped dict"
    assert all(k[2] is True for k in filter_prep)  # masked entries only
