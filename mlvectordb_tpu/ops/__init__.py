"""Compute kernels: distance matmuls, streaming exact top-k, the certified sweep.

  * ``topk.exact_knn`` — pure-XLA `lax.scan` over database tiles; the exact path for
    namespaces without a sweep mirror, and the certified path's terminal tier;
  * ``pallas_knn_t.exact_knn_pallas_t`` — the certified window-major sweep: a
    reduced-precision phase 1 (XLA, or the Pallas-Triton kernel in ``sweep_triton`` on
    NVIDIA GPUs), window selection, an exact f32 rescan and a per-query exactness
    certificate;
  * ``backend.knn_backend`` — picks between the two by whether the namespace keeps a
    mirror.

This replaces the reference's only native component, hnswlib's C++ HNSW graph
(reference: src/mlvectordb/implementations/index.py:1,36-37; SURVEY.md §2.1) with exact
search: recall@k is 1.0 by construction.
"""

from .distances import pairwise_distances, query_norms
from .topk import exact_knn, merge_topk

__all__ = ["pairwise_distances", "query_norms", "exact_knn", "merge_topk"]
