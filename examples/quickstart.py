"""Library quickstart: the whole capability surface in one script.

Run anywhere (CPU or GPU):  python examples/quickstart.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from mlvectordb_tpu import QueryProcessor, VectorDTO
from mlvectordb_tpu.utils.capacity import plan_capacity


def main():
    rng = np.random.default_rng(7)
    qp = QueryProcessor()

    # --- ingest: batch upsert with metadata ----------------------------------------
    docs = qp.upsert_many(
        [
            VectorDTO(
                rng.standard_normal(128).astype(np.float32),
                {"category": "news" if i % 2 == 0 else "blog", "rank": i},
            )
            for i in range(10_000)
        ],
        namespace="docs",
    )
    print(f"ingested {qp.get_namespace_count('docs')} vectors")

    # --- exact kNN (recall 1.0 — brute force on the device) ------------------------
    hits = qp.find_similar(VectorDTO(docs[123].values), top_k=5, namespace="docs",
                           metric="cosine")
    print(f"kNN: top hit is itself? {hits[0]['id'] == docs[123].id} "
          f"(score {hits[0]['score']:.4f})")

    # --- hybrid: metadata filter fused into the kernel -----------------------------
    q = VectorDTO(rng.standard_normal(128).astype(np.float32))
    hits = qp.find_similar(q, top_k=5, namespace="docs",
                           filter={"category": "news", "rank": {"$lt": 5000}})
    print(f"hybrid: {len(hits)} hits, all news<5000: "
          f"{all(h['metadata']['category'] == 'news' and h['metadata']['rank'] < 5000 for h in hits)}")

    # --- range / similarity / metadata queries -------------------------------------
    near = qp.range_search(VectorDTO(docs[0].values), radius=200.0, namespace="docs",
                           metric="l2")
    sim = qp.similarity_search(VectorDTO(docs[0].values), threshold=0.2, namespace="docs")
    meta = qp.query_by_metadata({"rank": {"$in": [1, 2, 3]}}, namespace="docs")
    print(f"range: {len(near)}  similarity: {len(sim)}  metadata: {len(meta)}")

    # --- true upsert + delete ------------------------------------------------------
    qp.upsert_many([VectorDTO(np.ones(128, np.float32), {"updated": True}, docs[0].id)],
                   "docs")
    print("after upsert:", qp.storage.read(docs[0].id, "docs").metadata)
    qp.delete([docs[1].id], "docs")
    print("after delete:", qp.get_namespace_count("docs"))

    # --- explain + statistics ------------------------------------------------------
    plan = qp.explain_query(q, top_k=10, namespace="docs")
    print(f"plan: backend={plan['backend']} exact={plan['exact']} "
          f"scanned={plan['scanned_slots']} slots")
    print("stats:", qp.get_statistics()["queries_by_type"])

    # --- snapshots ------------------------------------------------------------------
    with tempfile.TemporaryDirectory() as td:
        qp.save(td)
        qp2 = QueryProcessor.load(td)
        print(f"snapshot round-trip: {qp2.get_namespace_count('docs')} vectors restored")

    # --- capacity planning ----------------------------------------------------------
    p = plan_capacity(100_000_000, 1536, hbm_per_chip=80 * 10**9)  # one H100
    print(f"100M x 1536-d would need ~{p.total_bytes/1e9:.0f} GB "
          f"=> {p.min_shards} H100 shard(s)")


if __name__ == "__main__":
    main()
