"""Pairwise distance computation.

Internal convention: every metric is expressed as a *distance* (lower is better):
  l2     : squared euclidean  ||q||^2 + ||d||^2 - 2 q.d     (hnswlib 'l2' space convention)
  ip     : 1 - q.d                                          (hnswlib 'ip' space convention)
  cosine : 1 - q.d / (||q|| ||d||)                          (hnswlib 'cosine' convention)

The engine converts to the reference's user-facing score convention at the edge
(reference: src/mlvectordb/implementations/index.py:121-128 — raw distance for l2/ip,
1 - dist for cosine).

All matmuls accumulate in float32 via ``preferred_element_type`` regardless of
storage dtype (bfloat16 database halves HBM traffic; accumulation stays f32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Large-but-finite sentinel for masked slots. +inf breaks top_k index selection on some
# backends; 3.0e38 is comfortably above any real squared distance while finite in f32.
# numpy scalars, NOT jnp: a module-level jnp constant initializes the JAX backend at
# import time, which pins the platform before callers (server --platform, tests) can
# override it via jax.config.
MASKED = np.float32(3.0e38)
_EPS = np.float32(1e-30)


def query_norms(q: jax.Array) -> jax.Array:
    """Squared L2 norms of a [B, D] query block, float32 [B]."""
    qf = q.astype(jnp.float32)
    return jnp.sum(qf * qf, axis=-1)


def pairwise_distances(
    q: jax.Array,          # [B, D] queries (any float dtype; D lane-padded with zeros)
    db: jax.Array,         # [N, D] database tile
    db_sq_norms: jax.Array,  # [N] precomputed squared norms of db rows (float32)
    q_sq_norms: jax.Array,   # [B] squared norms of queries (float32)
    metric: str,
) -> jax.Array:
    """[B, N] float32 distance block (lower is better). Pure function of its inputs —
    safe both at XLA level and inside Pallas kernel bodies."""
    # f32 storage gets HIGHEST precision (true f32 products, not TF32) so
    # scores are exact; bf16 storage trades score precision for halved HBM traffic and
    # accumulates in f32.
    precision = (
        jax.lax.Precision.HIGHEST if db.dtype == jnp.float32 else jax.lax.Precision.DEFAULT
    )
    dots = jax.lax.dot_general(
        q.astype(db.dtype),
        db,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )  # [B, N]
    if metric == "l2":
        d = q_sq_norms[:, None] + db_sq_norms[None, :] - 2.0 * dots
        return jnp.maximum(d, 0.0)
    if metric == "ip":
        return 1.0 - dots
    if metric == "cosine":
        denom = jnp.sqrt(jnp.maximum(q_sq_norms[:, None] * db_sq_norms[None, :], _EPS))
        return 1.0 - dots / denom
    raise ValueError(f"unknown metric {metric!r}")
