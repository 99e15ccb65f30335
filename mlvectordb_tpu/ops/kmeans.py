"""Mini-batch-free on-device k-means: the coarse quantizer for the IVF index.

Both phases are matmuls: assignment is an argmin over the [chunk, C] distance block
(the same distance computation the search kernel uses), and the centroid update is a
one-hot matmul (A^T X accumulated over chunks with lax.scan) — no scatter, no host loop.
Empty clusters are re-seeded from the rows currently farthest from their centroid, the
standard FAISS-style repair.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("chunk",))
def assign_clusters(data, valid, centroids, *, chunk: int = 65536):
    """[N] int32 nearest-centroid ids (squared-L2) + [N] f32 distances.
    Invalid rows get cluster -1."""
    N, D = data.shape
    C = centroids.shape[0]
    cn = jnp.sum(centroids.astype(jnp.float32) ** 2, axis=-1)  # [C]
    chunk = min(chunk, N)
    pad = (-N) % chunk
    data_p = jnp.pad(data, ((0, pad), (0, 0)))
    valid_p = jnp.pad(valid, (0, pad))
    nt = data_p.shape[0] // chunk

    def step(_, xs):
        rows, ok = xs
        d = (
            jnp.sum(rows.astype(jnp.float32) ** 2, axis=-1, keepdims=True)
            + cn[None, :]
            - 2.0
            * jax.lax.dot_general(
                rows, centroids.astype(rows.dtype), (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,  # no TF32 on GPUs
            )
        )  # [chunk, C]
        a = jnp.argmin(d, axis=-1).astype(jnp.int32)
        best = jnp.min(d, axis=-1)
        a = jnp.where(ok, a, -1)
        return None, (a, best)

    _, (assign, dist) = jax.lax.scan(
        step, None,
        (data_p.reshape(nt, chunk, D), valid_p.reshape(nt, chunk)),
    )
    return assign.reshape(-1)[:N], dist.reshape(-1)[:N]


@functools.partial(jax.jit, static_argnames=("m", "chunk"))
def assign_topm(data, valid, centroids, *, m: int, chunk: int = 65536):
    """[N, m] int32 ids of the m nearest centroids per row (squared-L2), the
    multi-assignment ("spilling") primitive for the IVF index.  Invalid rows get -1."""
    N, D = data.shape
    cn = jnp.sum(centroids.astype(jnp.float32) ** 2, axis=-1)
    chunk = min(chunk, N)
    pad = (-N) % chunk
    data_p = jnp.pad(data, ((0, pad), (0, 0)))
    valid_p = jnp.pad(valid, (0, pad))
    nt = data_p.shape[0] // chunk

    def step(_, xs):
        rows, ok = xs
        d = (
            cn[None, :]
            - 2.0
            * jax.lax.dot_general(
                rows, centroids.astype(rows.dtype), (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,  # no TF32 on GPUs
            )
        )  # [chunk, C]; the +|row|^2 term is rank-invariant per row and dropped
        _, top = jax.lax.top_k(-d, m)
        return None, jnp.where(ok[:, None], top.astype(jnp.int32), -1)

    _, out = jax.lax.scan(
        step, None, (data_p.reshape(nt, chunk, D), valid_p.reshape(nt, chunk))
    )
    return out.reshape(-1, m)[:N]


@functools.partial(jax.jit, static_argnames=("n_clusters", "chunk"))
def update_centroids(data, assign, *, n_clusters: int, chunk: int = 65536):
    """One k-means update step: mean of each cluster's rows via one-hot matmuls.
    Returns (centroids [C, D] f32, counts [C] f32); empty clusters keep zero rows."""
    N, D = data.shape
    chunk = min(chunk, N)
    pad = (-N) % chunk
    data_p = jnp.pad(data, ((0, pad), (0, 0)))
    assign_p = jnp.pad(assign, (0, pad), constant_values=-1)
    nt = data_p.shape[0] // chunk

    def step(carry, xs):
        sums, counts = carry
        rows, a = xs
        onehot = (a[:, None] == jnp.arange(n_clusters)[None, :]).astype(jnp.float32)
        sums = sums + jax.lax.dot_general(
            onehot, rows.astype(jnp.float32), (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,  # means need f32, not TF32
        )  # [C, D]
        counts = counts + jnp.sum(onehot, axis=0)
        return (sums, counts), None

    (sums, counts), _ = jax.lax.scan(
        step,
        (jnp.zeros((n_clusters, D), jnp.float32), jnp.zeros((n_clusters,), jnp.float32)),
        (data_p.reshape(nt, chunk, D), assign_p.reshape(nt, chunk)),
    )
    centroids = sums / jnp.maximum(counts[:, None], 1.0)
    return centroids, counts


def _init_centroids(data, live, n_clusters: int, rng, max_sample: int = 20000):
    """k-means++ (D^2 sampling) on a bounded host sample — avoids the merge/split local
    optima random init falls into on well-separated data.  Falls back to random rows when
    n_clusters is large enough that the quadratic init would dominate build time."""
    import numpy as np

    if n_clusters > 1024:
        rows = np.sort(rng.choice(live, size=n_clusters, replace=False))
        return np.asarray(jax.device_get(data[jnp.asarray(rows)]), np.float32)

    sample_idx = (
        live if len(live) <= max_sample else np.sort(rng.choice(live, max_sample, replace=False))
    )
    sample = np.asarray(jax.device_get(data[jnp.asarray(sample_idx)]), np.float32)
    n = sample.shape[0]
    chosen = np.empty((n_clusters, sample.shape[1]), np.float32)
    first = rng.integers(n)
    chosen[0] = sample[first]
    d2 = ((sample - chosen[0]) ** 2).sum(-1)
    for c in range(1, n_clusters):
        total = d2.sum()
        if total <= 0:
            chosen[c] = sample[rng.integers(n)]
            continue
        pick = int(np.searchsorted(np.cumsum(d2), rng.random() * total))
        pick = min(pick, n - 1)
        chosen[c] = sample[pick]
        d2 = np.minimum(d2, ((sample - chosen[c]) ** 2).sum(-1))
    return chosen


def train_kmeans(
    data,
    valid,
    n_clusters: int,
    n_iters: int = 10,
    seed: int = 0,
    chunk: int = 65536,
):
    """Lloyd's iterations on device.  Returns (centroids [C, D] f32, assign [N] int32)."""
    import numpy as np

    N = data.shape[0]
    valid_np = np.asarray(jax.device_get(valid))
    live = np.flatnonzero(valid_np)
    if len(live) < n_clusters:
        raise ValueError(f"need >= {n_clusters} live rows to train, have {len(live)}")
    rng = np.random.default_rng(seed)
    centroids = jnp.asarray(
        _init_centroids(data, live, n_clusters, rng), jnp.float32
    )

    assign = None
    for _ in range(n_iters):
        assign, dist = assign_clusters(data, valid, centroids, chunk=chunk)
        centroids_new, counts = update_centroids(data, assign, n_clusters=n_clusters, chunk=chunk)
        counts_np = np.asarray(jax.device_get(counts))
        empty = np.flatnonzero(counts_np == 0)
        if len(empty):
            # re-seed empty clusters from the farthest-assigned rows
            # (copy: device_get can hand back a read-only buffer)
            dist_np = np.array(jax.device_get(dist), copy=True)
            dist_np[~valid_np] = -np.inf
            far = np.argsort(-dist_np)[: len(empty)]
            centroids_new = centroids_new.at[jnp.asarray(empty)].set(
                jnp.asarray(data[jnp.asarray(np.sort(far))], jnp.float32)
            )
        centroids = centroids_new
    assign, _ = assign_clusters(data, valid, centroids, chunk=chunk)
    return centroids, assign
