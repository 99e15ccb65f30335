"""Streaming exact k-NN: chunked distance matmul + carried top-k (pure XLA).

This is the always-correct backend: the path of namespaces without a sweep mirror, and
the certified path's terminal tier.  The database axis is tiled and scanned with
``lax.scan``; each step computes one [B, tile] distance block and folds it into a
carried [B, k] accumulator with ``lax.top_k``, so the full [B, N] distance matrix never
exists in device memory — the same blockwise trick ring-attention
uses on the KV axis, applied to the database axis (SURVEY.md §5.7).

Replaces hnswlib's graph search (reference: src/mlvectordb/implementations/index.py:91-129)
with exact search; recall@k = 1.0 by construction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .distances import MASKED, pairwise_distances, query_norms


def _fold_tile(best_d, best_i, tile_d, tile_i, k):
    """Merge a [B, T] candidate block into the carried [B, k] top-k (min-distances)."""
    cand_d = jnp.concatenate([best_d, tile_d], axis=1)
    cand_i = jnp.concatenate([best_i, tile_i], axis=1)
    if k > 256:
        # large k: one pair-sort of the candidate block per fold instead of an
        # iterative top_k (threshold chosen on earlier hardware; not yet measured
        # on a GPU)
        sd, si = jax.lax.sort((cand_d, cand_i), dimension=-1, num_keys=1)
        return sd[:, :k], si[:, :k]
    neg_top, pos = jax.lax.top_k(-cand_d, k)
    return -neg_top, jnp.take_along_axis(cand_i, pos, axis=1)


@functools.partial(jax.jit, static_argnames=("k", "metric", "db_tile"))
def exact_knn(
    q: jax.Array,         # [B, D] queries, float32, lane-padded
    data: jax.Array,      # [cap, D] database (f32 or bf16), lane-padded
    valid: jax.Array,     # [cap] bool liveness mask (False = empty slot or tombstone)
    sq_norms: jax.Array,  # [cap] float32 squared norms of data rows
    *,
    k: int,
    metric: str,
    db_tile: int = 8192,
):
    """Exact k nearest neighbours.

    Returns ``(dist [B, k] float32, idx [B, k] int32)`` sorted best-first.  Masked /
    out-of-range slots surface as ``dist >= MASKED`` with idx of some masked slot; callers
    clamp k to the live count (as the reference does,
    src/mlvectordb/implementations/index.py:103-107) so those never reach users.
    """
    cap = data.shape[0]
    tile = min(db_tile, cap)
    q32 = q.astype(jnp.float32)
    qn = query_norms(q32)

    def block(db_blk, norms_blk, valid_blk, offset):
        d = pairwise_distances(q32, db_blk, norms_blk, qn, metric)
        d = jnp.where(valid_blk[None, :], d, MASKED)
        idx = offset + jax.lax.broadcasted_iota(jnp.int32, (1, db_blk.shape[0]), 1)
        return d, jnp.broadcast_to(idx, d.shape)

    if cap <= tile:
        d, idx = block(data, sq_norms, valid, 0)
        kk = min(k, cap)
        neg_top, pos = jax.lax.top_k(-d, kk)
        best_d, best_i = -neg_top, jnp.take_along_axis(idx, pos, axis=1)
        if kk < k:  # pad out to k with masked slots
            pad_d = jnp.full((d.shape[0], k - kk), MASKED, jnp.float32)
            pad_i = jnp.zeros((d.shape[0], k - kk), jnp.int32)
            best_d = jnp.concatenate([best_d, pad_d], axis=1)
            best_i = jnp.concatenate([best_i, pad_i], axis=1)
        return best_d, best_i

    if cap % tile != 0:
        # odd tiling (only reachable with custom configs): pad to a tile multiple with
        # masked slots rather than materializing a one-shot [B, cap] distance matrix
        pad = tile - cap % tile
        data = jnp.pad(data, ((0, pad), (0, 0)))
        sq_norms = jnp.pad(sq_norms, (0, pad))
        valid = jnp.pad(valid, (0, pad))  # False => masked
        cap = cap + pad

    n_tiles = cap // tile
    data_t = data.reshape(n_tiles, tile, data.shape[1])
    norms_t = sq_norms.reshape(n_tiles, tile)
    valid_t = valid.reshape(n_tiles, tile)

    B = q.shape[0]
    init = (
        jnp.full((B, k), MASKED, jnp.float32),
        jnp.zeros((B, k), jnp.int32),
    )

    def step(carry, xs):
        best_d, best_i = carry
        db_blk, norms_blk, valid_blk, t = xs
        tile_d, tile_i = block(db_blk, norms_blk, valid_blk, t * tile)
        return _fold_tile(best_d, best_i, tile_d, tile_i, k), None

    (best_d, best_i), _ = jax.lax.scan(
        step, init, (data_t, norms_t, valid_t, jnp.arange(n_tiles, dtype=jnp.int32))
    )
    return best_d, best_i


@functools.partial(jax.jit, static_argnames=("k",))
def merge_topk(dist_a, idx_a, dist_b, idx_b, *, k: int):
    """Merge two sorted-best-first top-k lists (per query row) into one.

    Used by the cross-device reduction: shard-local top-k lists are all-gathered and
    folded with this.  Realizes the merge step the reference's README-only ShardingManager
    stub implied (SURVEY.md §2.2).
    """
    return _fold_tile(dist_a, idx_a, dist_b, idx_b, k)
