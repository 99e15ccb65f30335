"""ShardingManager: database-sharded exact search across devices.

Realizes the reference's README-only ShardingManager stub (shard_for_vector /
shard_for_id / all_shards — SURVEY.md §0.1) as a real component:

  * deterministic shard routing by uuid hash (writes land on the owning shard's slot
    range; the scatter under jit routes device-to-device automatically),
  * sharded search via ``shard_map``: every shard runs the engine's own search backend
    (ops/backend.py: the certified sweep when a mirror is passed, the scan otherwise)
    on its local slot range, translates local slots to global ids by adding its shard
    offset, then the [B, k] candidate lists are all-gathered over the "shard" axis
    (collectives XLA hands to the interconnect, NCCL on GPUs) and folded with
    merge_topk — the cross-device reduction the SURVEY's build plan calls for (§5.8).

Query batches are simultaneously data-parallel over the "replica" axis: with mesh
(R, S), a [B, D] query batch is split R ways, each slice searched against the full
database (sharded S ways), so QPS scales with R and capacity with S.
"""

from __future__ import annotations

import functools
import uuid as uuid_mod
from typing import List, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import DEFAULT_CONFIG, EngineConfig
from ..ops.backend import knn_backend
from ..ops.topk import merge_topk
from .mesh import REPLICA_AXIS, SHARD_AXIS


class ShardingManager:
    """Owns the mesh + routing functions + the sharded search computation."""

    def __init__(self, mesh: Mesh, config: EngineConfig = DEFAULT_CONFIG):
        self.mesh = mesh
        self.backend = knn_backend(config)
        self.n_replicas = mesh.shape[REPLICA_AXIS]
        self.n_shards = mesh.shape[SHARD_AXIS]

    # ------------------------------------------------------------------ routing
    # (the reference stub's surface: shard_for_vector / shard_for_id / all_shards)

    def shard_for_id(self, vector_id: uuid_mod.UUID) -> int:
        """Deterministic owner shard of an id (stable across processes/restarts)."""
        return vector_id.int % self.n_shards

    def shard_for_vector(self, vector) -> int:
        return self.shard_for_id(vector.id)

    def all_shards(self) -> List[int]:
        return list(range(self.n_shards))

    # ------------------------------------------------------------------ placement

    def db_sharding(self) -> NamedSharding:
        """Database arrays: rows split over 'shard', replicated over 'replica'."""
        return NamedSharding(self.mesh, P(SHARD_AXIS))

    def db_sharding_2d(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(SHARD_AXIS, None))

    def db_sharding_2d_t(self) -> NamedSharding:
        """Transposed sweep mirror [D, cap]: columns follow the rows' shard."""
        return NamedSharding(self.mesh, P(None, SHARD_AXIS))

    def ivf_sharding_3d(self) -> NamedSharding:
        """IVF cluster arrays [C, L, Dp]: clusters split over 'shard'."""
        return NamedSharding(self.mesh, P(SHARD_AXIS, None, None))

    def ivf_sharding_2d(self) -> NamedSharding:
        """IVF per-row tables [C, L]: clusters split over 'shard'."""
        return NamedSharding(self.mesh, P(SHARD_AXIS, None))

    def query_sharding(self) -> NamedSharding:
        """Query batches: split over 'replica', replicated over 'shard'."""
        return NamedSharding(self.mesh, P(REPLICA_AXIS, None))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())

    def place_database(self, data, valid, sq_norms):
        return (
            jax.device_put(data, self.db_sharding_2d()),
            jax.device_put(valid, self.db_sharding()),
            jax.device_put(sq_norms, self.db_sharding()),
        )

    # ------------------------------------------------------------------ search

    @functools.partial(
        jax.jit, static_argnames=("self", "k", "metric", "db_tile")
    )
    def sharded_knn(
        self, q, data, valid, sq_norms, data_t=None, sweep_err=None,
        *, k, metric, db_tile=8192,
    ):
        """Exact kNN over the sharded database.

        q [B, D] (replica-sharded), data [cap, D] / valid [cap] / sq_norms [cap]
        (shard-sharded); optional data_t [D, cap] transposed sweep mirror (sharded on
        its column axis) — per-shard search then runs the certified sweep
        (ops/pallas_knn_t.py) with the row-major shard as its exact rescan source.
        ``sweep_err`` [cap] (shard-sharded) carries the mixed-config rounding norms so
        each shard's exactness certificate runs with the tight bound.
        Returns (dist [B, k], idx [B, k]) with GLOBAL slot indices, replica-sharded
        like q.
        """
        cap = data.shape[0]
        shard_rows = cap // self.n_shards

        def local(q_loc, data_loc, valid_loc, sqn_loc, *rest):
            kk = min(k, shard_rows)
            # per-shard search through the backend (masked variant: liveness is
            # shard-local); the certified path itself takes the scan for shards
            # below two sweep tiles
            d, i = self.backend(
                q_loc, data_loc, valid_loc, sqn_loc,
                k=kk, metric=metric, db_tile=min(db_tile, shard_rows),
                data_t=rest[0] if rest else None,
                sweep_err=rest[1] if len(rest) > 1 else None,
            )
            # local slot -> global slot
            i = i + jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32) * shard_rows
            # cross-shard merge: all_gather candidates, fold with merge_topk
            ds = jax.lax.all_gather(d, SHARD_AXIS)   # [S, Br, kk]
            is_ = jax.lax.all_gather(i, SHARD_AXIS)  # [S, Br, kk]

            def fold(carry, x):
                cd, ci = carry
                xd, xi = x
                return merge_topk(cd, ci, xd, xi, k=kk), None

            (bd, bi), _ = jax.lax.scan(fold, (ds[0], is_[0]), (ds[1:], is_[1:]))
            if kk < k:  # pad to the requested k with masked slots
                from ..ops.distances import MASKED

                pad = k - kk
                bd = jnp.pad(bd, ((0, 0), (0, pad)), constant_values=float(MASKED))
                bi = jnp.pad(bi, ((0, 0), (0, pad)))
            return bd, bi

        in_specs = [P(REPLICA_AXIS, None), P(SHARD_AXIS, None), P(SHARD_AXIS), P(SHARD_AXIS)]
        args = [q, data, valid, sq_norms]
        if data_t is not None:
            in_specs.append(P(None, SHARD_AXIS))  # mirror columns follow the rows' shard
            args.append(data_t)
            if sweep_err is not None:
                in_specs.append(P(SHARD_AXIS))
                args.append(sweep_err)
        return shard_map(
            local,
            mesh=self.mesh,
            in_specs=tuple(in_specs),
            out_specs=(P(REPLICA_AXIS, None), P(REPLICA_AXIS, None)),
            check_vma=False,
        )(*args)


    @functools.partial(
        jax.jit, static_argnames=("self", "k", "metric", "nprobe")
    )
    def sharded_ivf_probe(self, q, centroids, cnorms, data3, valid3, sqn3, *, k, metric, nprobe):
        """IVF probe search over cluster-sharded inverted lists (per-shard IVF).

        centroids [C, Dp] / cnorms [C] are replicated (the coarse quantizer is tiny);
        data3 [C, L, Dp] / valid3 / sqn3 [C, L] are split on the CLUSTER axis over
        'shard' — each device holds C/S inverted lists, so index memory scales with the
        mesh instead of concentrating on one chip.  ``nprobe`` semantics are identical
        to the single-device path: every query probes its GLOBAL nprobe nearest
        clusters; each shard scans the probed clusters it owns (unowned probes are
        masked), and the [B, k] candidates merge across devices with the same
        all_gather + merge_topk reduction as exact sharded search.  Queries are
        replica-sharded, so QPS scales over 'replica' while memory scales over 'shard'.
        Returns (dist [B, k], ivf_slot [B, k]) with GLOBAL ivf slots (cluster*L+local).
        """
        from ..ops.distances import MASKED, pairwise_distances
        from ..ops.topk import _fold_tile

        C, L, _Dp = data3.shape
        c_loc = C // self.n_shards

        def local(q_loc, cent, cn, d3, v3, s3):
            B = q_loc.shape[0]
            q32 = q_loc.astype(jnp.float32)
            qn = jnp.sum(q32 * q32, axis=-1)
            probe_d = pairwise_distances(q32, cent, cn, qn, metric)     # [B, C]
            _, probed = jax.lax.top_k(-probe_d, nprobe)                 # global ids
            off = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32) * c_loc

            init = (
                jnp.full((B, k), MASKED, jnp.float32),
                jnp.zeros((B, k), jnp.int32),
            )

            def step(carry, j):
                bd, bi = carry
                cids = probed[:, j]                       # [B] global cluster ids
                loc = cids - off
                owned = (loc >= 0) & (loc < c_loc)
                locc = jnp.clip(loc, 0, c_loc - 1)
                rows = d3[locc]                           # [B, L, Dp]
                ok = v3[locc] & owned[:, None]
                sq = s3[locc]
                dots = jnp.einsum(
                    "bd,bld->bl", q32, rows.astype(jnp.float32),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,  # no TF32 on GPUs
                )
                if metric == "l2":
                    d = jnp.maximum(qn[:, None] + sq - 2.0 * dots, 0.0)
                elif metric == "ip":
                    d = 1.0 - dots
                else:
                    denom = jax.lax.rsqrt(jnp.maximum(qn[:, None] * sq, 1e-30))
                    d = 1.0 - dots * denom
                d = jnp.where(ok, d, MASKED)
                idx = cids[:, None] * L + jnp.arange(L, dtype=jnp.int32)[None, :]
                return _fold_tile(bd, bi, d, idx, k), None

            (bd, bi), _ = jax.lax.scan(step, init, jnp.arange(nprobe))

            # cross-shard merge (same reduction as sharded_knn)
            ds = jax.lax.all_gather(bd, SHARD_AXIS)
            is_ = jax.lax.all_gather(bi, SHARD_AXIS)

            def fold(carry, x):
                cd, ci = carry
                xd, xi = x
                return merge_topk(cd, ci, xd, xi, k=k), None

            (bd, bi), _ = jax.lax.scan(fold, (ds[0], is_[0]), (ds[1:], is_[1:]))
            return bd, bi

        return shard_map(
            local,
            mesh=self.mesh,
            in_specs=(
                P(REPLICA_AXIS, None), P(), P(),
                P(SHARD_AXIS, None, None), P(SHARD_AXIS, None), P(SHARD_AXIS, None),
            ),
            out_specs=(P(REPLICA_AXIS, None), P(REPLICA_AXIS, None)),
            check_vma=False,
        )(q, centroids, cnorms, data3, valid3, sqn3)


def merge_shard_results(
    dists: List[jax.Array], idxs: List[jax.Array], k: int
) -> Tuple[jax.Array, jax.Array]:
    """Host-side fold of per-shard top-k lists (used by tests and the scatter-gather
    coordinator path)."""
    bd, bi = dists[0], idxs[0]
    for d, i in zip(dists[1:], idxs[1:]):
        bd, bi = merge_topk(bd, bi, d, i, k=k)
    return bd, bi
