"""Example client for the MLVectorDB REST API.

Covers the same client surface the reference's example advertises
(reference: examples/api_client.py:12-92) — but unlike the reference, every call here hits
a real endpoint (the reference client targets an API its server never implemented and 404s
against it — SURVEY.md §0.1).

Run the server first:  python -m mlvectordb_tpu.api.server --port 8000
Then:                  python examples/api_client.py
"""

from __future__ import annotations

import random
from typing import Any, Dict, List

import requests


class MLVectorDBClient:
    """Thin requests-based client over the REST surface."""

    def __init__(self, base_url: str = "http://localhost:8000"):
        self.base_url = base_url.rstrip("/")
        self.session = requests.Session()

    def _post(self, path: str, **kwargs) -> Dict[str, Any]:
        resp = self.session.post(f"{self.base_url}{path}", **kwargs)
        resp.raise_for_status()
        return resp.json()

    def _get(self, path: str) -> Dict[str, Any]:
        resp = self.session.get(f"{self.base_url}{path}")
        resp.raise_for_status()
        return resp.json()

    # --- core surface -------------------------------------------------------------

    def health_check(self) -> Dict[str, Any]:
        return self._get("/health")

    def insert(self, values: List[float], metadata=None, namespace="default", id=None):
        body = {"values": values, "metadata": metadata or {}}
        if id is not None:
            body["id"] = str(id)
        return self._post(f"/vectors?namespace={namespace}", json=body)

    def upsert_batch(self, vectors: List[Dict[str, Any]], namespace="default"):
        return self.session.put(
            f"{self.base_url}/vectors/batch?namespace={namespace}", json={"vectors": vectors}
        ).json()

    def search(self, query: List[float], top_k=10, metric="cosine", namespace="default", filter=None):
        body = {"query": query, "top_k": top_k, "metric": metric}
        if filter:
            body["filter"] = filter
        return self._post(f"/search?namespace={namespace}", json=body)

    def delete(self, ids: List[str], namespace="default"):
        resp = self.session.delete(
            f"{self.base_url}/vectors?namespace={namespace}", json={"ids": ids}
        )
        resp.raise_for_status()
        return resp.json()

    # --- query API ----------------------------------------------------------------

    def knn_query(self, vector: List[float], k: int, **kwargs) -> Dict[str, Any]:
        return self._post("/query/knn", json={"type": "knn", "vector": vector, "k": k, **kwargs})

    def range_query(self, vector: List[float], radius: float, **kwargs) -> Dict[str, Any]:
        return self._post(
            "/query/range", json={"type": "range", "vector": vector, "radius": radius, **kwargs}
        )

    def similarity_query(
        self, vector: List[float], threshold: float, metric: str = "cosine", **kwargs
    ) -> Dict[str, Any]:
        return self._post(
            "/query/similarity",
            json={"type": "similarity", "vector": vector, "threshold": threshold,
                  "metric": metric, **kwargs},
        )

    def metadata_query(self, filter_dict: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        return self._post(
            "/query/metadata", json={"type": "metadata", "filter": filter_dict, **kwargs}
        )

    def hybrid_query(self, vector, k, filter_dict, **kwargs) -> Dict[str, Any]:
        return self._post(
            "/query/hybrid",
            json={"type": "hybrid", "vector": vector, "k": k, "filter": filter_dict, **kwargs},
        )

    def explain_query(self, query_data: Dict[str, Any]) -> Dict[str, Any]:
        return self._post("/query/explain", json=query_data)

    def get_statistics(self) -> Dict[str, Any]:
        return self._get("/statistics")

    def get_supported_query_types(self) -> Dict[str, Any]:
        return self._get("/query-types")


def main():
    print("MLVectorDB API Client Example")
    print("=" * 40)
    client = MLVectorDBClient()
    try:
        health = client.health_check()
        print(f"\n1. Health: {health['status']} (version {health['version']})")

        print("\n2. Supported query types:")
        for qtype, desc in client.get_supported_query_types()["descriptions"].items():
            print(f"  - {qtype}: {desc}")

        rnd = random.Random(7)
        vectors = [
            {
                "values": [rnd.gauss(0, 1) for _ in range(16)],
                "metadata": {"category": "test", "active": i % 2 == 0, "i": i},
            }
            for i in range(200)
        ]
        print("\n3. Batch upsert:", client.upsert_batch(vectors, "demo")["message"])

        q = vectors[0]["values"]
        knn = client.knn_query(q, k=3, namespace="demo")
        print(
            f"\n4. KNN: {knn['total_results']} results in "
            f"{knn['execution_time_ms']:.2f}ms; best score {knn['results'][0]['score']:.4f}"
        )

        rng_res = client.range_query(q, radius=10.0, namespace="demo", metric="l2")
        print(f"5. Range: {rng_res['total_results']} within radius")

        sim = client.similarity_query(q, threshold=0.2, namespace="demo")
        print(f"6. Similarity: {sim['total_results']} above threshold")

        meta = client.metadata_query({"active": True}, namespace="demo")
        print(f"7. Metadata: {meta['total_results']} matching")

        hyb = client.hybrid_query(q, 5, {"i": {"$lt": 100}}, namespace="demo")
        print(f"8. Hybrid: {hyb['total_results']} filtered neighbours")

        plan = client.explain_query({"type": "knn", "vector": q, "k": 5, "namespace": "demo"})
        print("9. Explain steps:")
        for step in plan["execution_plan"]["steps"]:
            print(f"  - {step}")

        stats = client.get_statistics()
        print(f"10. Stats: total={stats['total_queries']}, knn={stats.get('knn_queries', 0)}")
    except requests.exceptions.ConnectionError:
        print("ERROR: could not connect — start the server with:")
        print("  python -m mlvectordb_tpu.api.server")


if __name__ == "__main__":
    main()
