"""SearchIndex (IndexProtocol view) + the drop-in compat layer for reference users.

Ports the reference's index-level test semantics (reference tests/test_index.py —
add->search known ids, remove->tombstoned never surface, rebuild keeps namespaces
searchable; SURVEY.md §4) against the device-resident SearchIndex, then verifies that the
reference's own composition root style works via mlvectordb_tpu.compat.
"""

import numpy as np
import pytest

from mlvectordb_tpu import SearchIndex, Vector
from mlvectordb_tpu.interfaces import SearchIndexProtocol, SearchResultProtocol


@pytest.fixture(params=[2, 5, 100])
def corpus(request, rng, small_config):
    # parametrized sizes 2/5/100 mirror reference tests/test_index.py:8-17
    n = request.param
    vecs = [Vector(rng.standard_normal(16).astype(np.float32)) for _ in range(n)]
    idx = SearchIndex(space="l2", config=small_config)
    idx.add(vecs, "ns")
    return idx, vecs


def test_add_then_search_returns_known_ids(corpus, rng):
    idx, vecs = corpus
    q = vecs[0].values + rng.normal(0, 0.01, size=16).astype(np.float32)
    results = idx.search(q, k=3, namespace="ns")
    known = {v.id for v in vecs}
    assert 1 <= len(results) <= 3
    for r in results:
        assert r.vector_id in known
        assert isinstance(r.score, float) and r.score >= 0.0  # l2
        assert isinstance(r, SearchResultProtocol)
    assert results[0].vector_id == vecs[0].id


def test_remove_tombstones_never_surface(corpus):
    idx, vecs = corpus
    idx.remove([vecs[0].id], "ns")
    results = idx.search(vecs[0].values, k=len(vecs), namespace="ns")
    assert vecs[0].id not in [r.vector_id for r in results]


def test_rebuild_keeps_other_namespaces_searchable(rng, small_config):
    """The critical fix over the reference: its rebuild destroys every other namespace's
    index (SURVEY.md §3.4)."""
    idx = SearchIndex(space="l2", config=small_config)
    a = [Vector(rng.standard_normal(8).astype(np.float32)) for _ in range(20)]
    b = [Vector(rng.standard_normal(8).astype(np.float32)) for _ in range(20)]
    idx.add(a, "a")
    idx.add(b, "b")
    idx.remove([v.id for v in a[:10]], "a")
    idx.rebuild("a")
    assert not idx.is_rebuild_required("a")
    ra = idx.search(a[15].values, k=1, namespace="a")
    rb = idx.search(b[3].values, k=1, namespace="b")
    assert ra[0].vector_id == a[15].id
    assert rb[0].vector_id == b[3].id  # namespace b survived a's rebuild


def test_metric_selects_distance_at_search_time(rng, small_config):
    idx = SearchIndex(space="l2", config=small_config)
    vecs = [Vector(rng.standard_normal(8).astype(np.float32)) for _ in range(30)]
    idx.add(vecs, "ns")
    q = rng.standard_normal(8).astype(np.float32)
    cos = idx.search(q, k=5, namespace="ns", metric="cosine")
    db = np.stack([v.values for v in vecs])
    sims = db @ q / (np.linalg.norm(db, axis=1) * np.linalg.norm(q))
    expect = [vecs[i].id for i in np.argsort(-sims)[:5]]
    assert [r.vector_id for r in cos] == expect
    assert cos[0].score == pytest.approx(float(sims.max()), rel=1e-4)


def test_protocol_conformance(small_config):
    idx = SearchIndex(config=small_config)
    assert isinstance(idx, SearchIndexProtocol)


def test_compat_reference_composition_root(rng, small_config):
    """The reference's wiring style (server.py:54) runs unchanged against compat."""
    from mlvectordb_tpu.compat import (
        Index,
        QueryProcessor,
        SimpleVector,
        StorageEngineInMemory,
        Vector as CompatVector,
        VectorDTO,
    )

    qproc = QueryProcessor(StorageEngineInMemory(small_config), Index(space="cosine"))
    assert qproc.config.default_metric == "cosine"

    v = qproc.insert(VectorDTO(values=[1.0, 0.0], metadata={"m": 1}), "ns")
    qproc.upsert_many([VectorDTO(values=[0.0, 1.0])], "ns")
    res = qproc.find_similar(VectorDTO(values=[1.0, 0.0]), top_k=1, namespace="ns")
    assert res[0]["id"] == v.id
    assert res[0]["score"] == pytest.approx(1.0, abs=1e-6)  # cosine default from Index

    assert SimpleVector is CompatVector
    sv = SimpleVector([3.0, 4.0])
    assert sv.normalize().values == pytest.approx([0.6, 0.8])
    assert sv.distance(SimpleVector([3.0, 4.0]), metric="l2") == 0.0


def test_backup_restore_aliases(rng, small_config, tmp_path):
    from mlvectordb_tpu import QueryProcessor, VectorDTO

    qp = QueryProcessor(config=small_config)
    v = qp.insert(VectorDTO(values=rng.standard_normal(8).astype(np.float32)), "ns")
    qp.create_backup(str(tmp_path / "b"))
    qp.delete([v.id], "ns")
    assert qp.get_namespace_count("ns") == 0
    qp.restore_from_backup(str(tmp_path / "b"))
    assert qp.get_namespace_count("ns") == 1
    assert qp.storage.read(v.id, "ns") is not None


def test_index_search_with_filter(rng, small_config):
    idx = SearchIndex(space="l2", config=small_config)
    vecs = [
        Vector(rng.standard_normal(8).astype(np.float32), {"grp": "a" if i % 2 else "b"})
        for i in range(30)
    ]
    idx.add(vecs, "ns")
    q = rng.standard_normal(8).astype(np.float32)
    res = idx.search(q, k=30, namespace="ns", filter={"grp": "a"})
    a_ids = {v.id for v in vecs if v.metadata["grp"] == "a"}
    assert {r.vector_id for r in res} == a_ids
    assert len(res) == 15  # masked fillers never surface
