"""Native C++ metadata-filter engine: exact semantic parity with the Python evaluator.

The native layer replaces the host-side hot loop (filter spec -> slot bitmask) the way
the reference's hnswlib replaced its distance loop (SURVEY.md §2.1) — and like the
reference's components it must be behaviourally indistinguishable from the contract:
here, bit-identical masks to filters.matches_filter over randomized metadata + specs.
"""

import random

import numpy as np
import pytest

from mlvectordb_tpu.filters import matches_filter

native = pytest.importorskip("mlvectordb_tpu.native")
if not native.available():  # pragma: no cover
    pytest.skip("native metafilter not buildable here", allow_module_level=True)


def make_store(metas):
    mc = native.MetaColumns(len(metas))
    for i, m in enumerate(metas):
        assert mc.set(i, m)
    return mc


def check(metas, spec, allow_fallback=False):
    mc = make_store(metas)
    got = mc.eval(spec)
    if got is None:
        # the native grammar deliberately rejects some Python-only semantics (e.g.
        # sequence-vs-sequence ordering) -> callers fall back to matches_filter
        assert allow_fallback, f"native unexpectedly failed to parse {spec}"
        return
    want = np.asarray([matches_filter(m or {}, spec) for m in metas])
    np.testing.assert_array_equal(got, want), (spec, metas)


METAS = [
    {},
    {"color": "red", "n": 5},
    {"color": "blue", "n": 2.5, "active": True},
    {"color": "red", "n": -1, "active": False},
    {"n": True},          # bool/number interop: True == 1
    {"n": 0},
    {"n": None},
    {"tag": "zebra"},
    {"tag": "apple", "n": 5},
    {"nested": {"a": {"b": 3}}, "arr": [1, 2, {"x": None}]},
    {"nested": {"a": {"b": "s"}}},
    {"mixed": "5"},       # string "5" vs number 5: never equal
    {"mixed": 5},
]

SPECS = [
    {"color": "red"},
    {"color": {"$ne": "red"}},
    {"n": {"$gt": 0}},
    {"n": {"$gte": 2.5}},
    {"n": {"$lt": 5}},
    {"n": {"$lte": True}},
    {"n": 1},                      # matches {"n": True}
    {"n": {"$in": [5, 2.5, "x"]}},
    {"n": {"$nin": [5]}},
    {"n": {"$exists": True}},
    {"n": {"$exists": False}},
    {"n": None},
    {"tag": {"$gt": "m"}},         # string ordering
    {"tag": {"$lt": "m"}},
    {"mixed": {"$gt": 3}},         # "5" > 3 -> TypeError -> False; 5 > 3 -> True
    {"mixed": "5"},
    {"nested.a.b": 3},
    {"nested.a.b": {"$gte": 3}},
    {"nested.a": {"b": 3}},        # complex-value equality via canonical JSON
    {"arr": [1, 2, {"x": None}]},
    {"$and": [{"color": "red"}, {"n": {"$gt": 0}}]},
    {"$or": [{"color": "blue"}, {"tag": "zebra"}]},
    {"$not": {"color": "red"}},
    {"$or": [{"$and": [{"n": {"$gte": 0}}, {"n": {"$lt": 3}}]}, {"$not": {"n": {"$exists": True}}}]},
    {"color": "red", "n": {"$gt": 0, "$lt": 10}},
    {},
]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s)[:50] for s in SPECS])
def test_parity_on_curated_cases(spec):
    check(METAS, spec)


def test_parity_randomized():
    rnd = random.Random(42)
    fields = ["a", "b", "c", "d.e"]
    values = [0, 1, -3.5, True, False, None, "x", "y", "long string", [1, 2], {"k": 1}]
    ops = ["$eq", "$ne", "$gt", "$gte", "$lt", "$lte", "$in", "$nin", "$exists"]

    def rand_meta():
        m = {}
        for f in rnd.sample(["a", "b", "c"], rnd.randint(0, 3)):
            m[f] = rnd.choice(values)
        if rnd.random() < 0.3:
            m["d"] = {"e": rnd.choice(values[:9])}
        return m

    def rand_leaf():
        f = rnd.choice(fields)
        op = rnd.choice(ops)
        if op == "$exists":
            return {f: {"$exists": rnd.choice([True, False])}}
        if op in ("$in", "$nin"):
            return {f: {op: rnd.sample(values[:9], rnd.randint(0, 3))}}
        return {f: {op: rnd.choice(values)}}

    def rand_spec(depth=0):
        r = rnd.random()
        if depth < 2 and r < 0.25:
            return {"$and": [rand_spec(depth + 1) for _ in range(rnd.randint(1, 3))]}
        if depth < 2 and r < 0.45:
            return {"$or": [rand_spec(depth + 1) for _ in range(rnd.randint(1, 3))]}
        if depth < 2 and r < 0.55:
            return {"$not": rand_spec(depth + 1)}
        return rand_leaf()

    metas = [rand_meta() for _ in range(80)]
    for _ in range(150):
        check(metas, rand_spec(), allow_fallback=True)


def test_clear_and_overwrite():
    mc = native.MetaColumns(4)
    mc.set(0, {"a": 1})
    mc.set(1, {"a": 2})
    assert mc.eval({"a": 1}).tolist() == [True, False, False, False]
    mc.set(0, {"b": 9})  # overwrite wipes previous fields
    assert mc.eval({"a": 1}).tolist() == [False, False, False, False]
    assert mc.eval({"b": 9}).tolist() == [True, False, False, False]
    mc.clear(1)
    assert mc.eval({"a": {"$exists": True}}).tolist() == [False, False, False, False]


def test_resize_preserves_data():
    mc = native.MetaColumns(2)
    mc.set(0, {"a": 1})
    mc.resize(8)
    mc.set(5, {"a": 1})
    assert mc.eval({"a": 1}).tolist() == [True, False, False, False, False, True, False, False]


def test_unknown_operator_returns_none():
    mc = make_store([{"a": 1}])
    assert mc.eval({"a": {"$regex": "x"}}) is None


def test_engine_uses_native_mask(small_config, rng):
    """Through the stack: hybrid search results identical whether or not the native
    evaluator is active for the namespace."""
    from mlvectordb_tpu import QueryProcessor, VectorDTO

    qp = QueryProcessor(config=small_config)
    vs = qp.upsert_many(
        [
            VectorDTO(rng.standard_normal(8).astype(np.float32), {"i": i, "odd": bool(i % 2)})
            for i in range(40)
        ],
        "ns",
    )
    ns = qp.storage.namespace("ns")
    assert ns.meta_columns is not None  # native mirror active
    q = VectorDTO(rng.standard_normal(8).astype(np.float32))
    native_res = qp.find_similar(q, top_k=40, namespace="ns", filter={"odd": True})

    ns.meta_columns = None  # force Python path; bust the cache via a fresh processor
    qp._filter_masks._cache.clear()
    python_res = qp.find_similar(q, top_k=40, namespace="ns", filter={"odd": True})
    assert [r["id"] for r in native_res] == [r["id"] for r in python_res]
    assert len(native_res) == 20


def test_set_many_matches_individual_sets():
    metas = [{"i": i, "grp": "x" if i % 2 else "y"} for i in range(10)]
    a = native.MetaColumns(10)
    assert a.set_many(list(range(10)), metas)
    b = make_store(metas)
    for spec in ({"grp": "x"}, {"i": {"$gte": 5}}, {"i": 3}):
        np.testing.assert_array_equal(a.eval(spec), b.eval(spec))


# ------------------------------------------------------------------ _hydrate extension


def test_hydrate_build_rows_parity_and_isolation():
    """native/hydrate.c builds the same result rows as the pure-Python fast path,
    copies metadata (mutating a result must not leak into the store tables), and
    flags rows nulled by a delete-after-snapshot."""
    mod = native.hydrate_module()
    if mod is None:  # pragma: no cover
        pytest.skip("hydrate extension not buildable here")
    import uuid

    n_slots = 32
    ids = [uuid.uuid4() for _ in range(n_slots)]
    vals = [np.arange(4, dtype=np.float32) + i for i in range(n_slots)]
    metas = [{"i": i} if i % 3 == 0 else ({} if i % 3 == 1 else None)
             for i in range(n_slots)]
    slots = [5, 0, 9, 31, 5]
    scores = [0.5, 1.0, -2.0, 3.25, 0.0]

    def python_rows(fs, fu):
        return [
            {"id": ids[s], "values": vals[s],
             "metadata": dict(m) if (m := metas[s]) else {}, "score": sc}
            for s, sc in zip(fs, fu)
        ]

    # list inputs
    rows, dropping = mod.build_rows(ids, vals, metas, slots, scores)
    want = python_rows(slots, scores)
    assert dropping == 0
    assert len(rows) == len(want)
    for r, w in zip(rows, want):
        assert r["id"] is w["id"] and r["values"] is w["values"]
        assert r["metadata"] == w["metadata"] and r["score"] == w["score"]

    # numpy buffer inputs, int32/float32 and int64/float64
    for sdt, fdt in ((np.int32, np.float32), (np.int64, np.float64)):
        rows2, _ = mod.build_rows(
            ids, vals, metas, np.asarray(slots, sdt), np.asarray(scores, fdt)
        )
        assert [r["id"] for r in rows2] == [w["id"] for w in want]
        assert [r["score"] for r in rows2] == pytest.approx([w["score"] for w in want])

    # metadata isolation: mutating a returned row cannot touch the table
    rows[0]["metadata"]["injected"] = True
    assert "injected" not in (metas[5] or {})
    # two rows hydrating the same slot get independent metadata dicts
    assert rows[0]["metadata"] is not rows[4]["metadata"]

    # delete-after-snapshot: nulled table entries flip the dropping flag
    ids[9] = None
    _rows, dropping = mod.build_rows(ids, vals, metas, slots, scores)
    assert dropping == 1

    # slot out of range is an error, not a crash
    with pytest.raises(IndexError):
        mod.build_rows(ids, vals, metas, [n_slots], [0.0])


def test_hydrate_batch_native_matches_python(rng):
    """End-to-end: _hydrate_batch with the native extension returns exactly what the
    pure-Python fallback returns."""
    from unittest import mock

    from mlvectordb_tpu import QueryProcessor, VectorDTO
    from mlvectordb_tpu.config import EngineConfig

    if native.hydrate_module() is None:  # pragma: no cover
        pytest.skip("hydrate extension not buildable here")
    qp = QueryProcessor(config=EngineConfig())
    qp.upsert_many(
        [VectorDTO(rng.standard_normal(16).astype(np.float32), {"i": i})
         for i in range(200)],
        "ns",
    )
    q = VectorDTO(rng.standard_normal(16).astype(np.float32))
    got_native = qp.find_similar(q, top_k=7, namespace="ns", metric="l2")
    qp._result_cache.clear()  # the repeat query must re-hydrate, not hit the cache
    with mock.patch(
        "mlvectordb_tpu.engine.query_processor._hydrate_native", return_value=None
    ):
        got_python = qp.find_similar(q, top_k=7, namespace="ns", metric="l2")
    assert [r["id"] for r in got_native] == [r["id"] for r in got_python]
    assert [r["score"] for r in got_native] == [r["score"] for r in got_python]
    assert [r["metadata"] for r in got_native] == [r["metadata"] for r in got_python]
