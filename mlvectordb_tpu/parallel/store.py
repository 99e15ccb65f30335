"""Sharded namespace store: one namespace spread over the mesh's 'shard' axis.

Extends the single-device NamespaceStore: the padded matrix/mask/norm arrays carry a
NamedSharding that splits rows over the 'shard' axis (and replicates over 'replica'), the
slot allocator routes each uuid to its owner shard's slot range
(ShardingManager.shard_for_id), and search goes through the shard_map + merge-top-k
reduction.  Capacity grows per shard (every shard keeps an equal slot range so the array
stays evenly partitioned).

Global slot layout: slot = shard * shard_capacity + local_slot.  Growth doubles
shard_capacity and re-interleaves the regions (reshape [S, c, D] -> pad -> [S, 2c, D]),
remapping host tables accordingly.
"""

from __future__ import annotations

import functools
import uuid as uuid_mod
from typing import List

import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, EngineConfig
from ..store.namespace import NamespaceStore

from .sharding import ShardingManager


@functools.partial(jax.jit, static_argnames=("n_shards", "old_shard_cap", "new_shard_cap"))
def _regrow(data, valid, sq_norms, *, n_shards, old_shard_cap, new_shard_cap):
    """Grow every shard's region in place: [S*c, D] -> [S*c', D], preserving shard-local
    row positions (slot = shard*cap + local keeps its local part)."""
    D = data.shape[1]
    pad = new_shard_cap - old_shard_cap
    data = jnp.pad(
        data.reshape(n_shards, old_shard_cap, D), ((0, 0), (0, pad), (0, 0))
    ).reshape(n_shards * new_shard_cap, D)
    valid = jnp.pad(valid.reshape(n_shards, old_shard_cap), ((0, 0), (0, pad))).reshape(-1)
    sq_norms = jnp.pad(
        sq_norms.reshape(n_shards, old_shard_cap), ((0, 0), (0, pad))
    ).reshape(-1)
    return data, valid, sq_norms


@functools.partial(jax.jit, static_argnames=("n_shards", "old_shard_cap", "new_shard_cap"))
def _regrow_t(data_t, *, n_shards, old_shard_cap, new_shard_cap):
    """Same per-shard regrow for the transposed mirror's COLUMN axis [D, S*c]."""
    D = data_t.shape[0]
    pad = new_shard_cap - old_shard_cap
    return jnp.pad(
        data_t.reshape(D, n_shards, old_shard_cap), ((0, 0), (0, 0), (0, pad))
    ).reshape(D, n_shards * new_shard_cap)


class ShardedNamespaceStore(NamespaceStore):
    """NamespaceStore whose device state is sharded across the mesh."""

    # residual mirror not yet plumbed through shard_map: the per-window sweep_err
    # certificate still applies per shard (escalates more often on adversarial data)
    _resid_capable = False

    def __init__(
        self,
        name: str,
        sharding_manager: ShardingManager,
        config: EngineConfig = DEFAULT_CONFIG,
        host_mirror: bool = True,
    ):
        super().__init__(name, config, host_mirror)
        self.sharding = sharding_manager
        self.n_shards = sharding_manager.n_shards
        self.shard_capacity = 0
        # per-shard allocation state (global free list is unused)
        self._shard_free: List[List[int]] = [[] for _ in range(self.n_shards)]
        self._shard_high: List[int] = [0] * self.n_shards

    # ------------------------------------------------------------------ allocation hooks

    def _mirror_ok(self, cap: int) -> bool:
        # the window-major layout is shard-local: every shard's column block must be
        # whole SWEEP_TILE-row tiles
        from ..ops.pallas_knn_t import SWEEP_TILE

        per_shard = cap // self.n_shards if self.n_shards else 0
        return per_shard >= SWEEP_TILE and per_shard % SWEEP_TILE == 0

    def _build_mirror(self):
        sdt = self._sweep_dtype()
        if sdt is None or self._data is None or not self._mirror_ok(self._data.shape[0]):
            return None
        if sdt == jnp.int8:
            # int8 codes need dequant scales plumbed through shard_map — not yet
            # wired for the sharded kernel; run mirror-less (scan path) instead of
            # silently serving unscaled ranks
            return None
        from ..ops.pallas_knn_t import to_sweep_layout

        return jax.device_put(
            to_sweep_layout(self._data, dtype=sdt, shard_cap=self.shard_capacity),
            self.sharding.db_sharding_2d_t(),
        )

    def _build_sweep_err(self):
        err = super()._build_sweep_err()
        if err is None:
            return None
        return jax.device_put(err, self.sharding.db_sharding())

    def _mirror_cols(self, slots):
        from ..ops.pallas_knn_t import sweep_cols_for_rows

        return sweep_cols_for_rows(slots, shard_cap=self.shard_capacity)

    def _alloc_arrays(self, new_cap: int) -> None:
        # new_cap is a GLOBAL row count; round the per-shard capacity to a lane-friendly
        # multiple and keep all shards equal
        per_shard = -(-new_cap // self.n_shards)
        per_shard = max(self.config.capacity_multiple, per_shard)
        p = self.config.capacity_multiple
        per_shard = -(-per_shard // p) * p
        dtype = self._storage_dtype()
        sdt = self._sweep_dtype()
        spec2d = self.sharding.db_sharding_2d()
        spec1d = self.sharding.db_sharding()
        spec2d_t = self.sharding.db_sharding_2d_t()
        total = per_shard * self.n_shards
        if self._data is None:
            self._data = jax.device_put(jnp.zeros((total, self.dpad), dtype), spec2d)
            self._valid = jax.device_put(jnp.zeros((total,), jnp.bool_), spec1d)
            self._sq_norms = jax.device_put(jnp.zeros((total,), jnp.float32), spec1d)
            if sdt is not None and self._mirror_ok(total):
                self._data_t = jax.device_put(jnp.zeros((self.dpad, total), sdt), spec2d_t)
                if self._mixed_sweep():
                    self._sweep_err = jax.device_put(jnp.zeros((total,), jnp.float32), spec1d)
        else:
            old = self.shard_capacity
            old_total = old * self.n_shards
            self._data, self._valid, self._sq_norms = _regrow(
                self._data, self._valid, self._sq_norms,
                n_shards=self.n_shards, old_shard_cap=old, new_shard_cap=per_shard,
            )
            self._data = jax.device_put(self._data, spec2d)
            self._valid = jax.device_put(self._valid, spec1d)
            self._sq_norms = jax.device_put(self._sq_norms, spec1d)
            if sdt is not None and self._mirror_ok(total):
                if self._data_t is not None and self._mirror_ok(old_total):
                    # both layouts are whole tiles per shard: per-shard column pad
                    self._data_t = jax.device_put(
                        _regrow_t(self._data_t, n_shards=self.n_shards,
                                  old_shard_cap=old, new_shard_cap=per_shard),
                        spec2d_t,
                    )
                else:
                    self.shard_capacity = per_shard  # _build_mirror reads it
                    self._data_t = self._build_mirror()
                # the per-row rounding norms grow with the data: cheapest correct
                # move is one rebuild pass (err derives purely from self._data)
                self.shard_capacity = per_shard
                self._sweep_err = self._build_sweep_err()
            else:
                self._data_t = None
                self._sweep_err = None
            # remap host tables: slot shard*old+local -> shard*new+local
            remap = {}
            for vid, slot in self._id_to_slot.items():
                sh, loc = divmod(slot, old)
                remap[vid] = sh * per_shard + loc
            new_ids = [None] * (per_shard * self.n_shards)
            new_meta = [None] * (per_shard * self.n_shards)
            new_vals = [None] * (per_shard * self.n_shards)
            for vid, new_slot in remap.items():
                old_slot = self._id_to_slot[vid]
                new_ids[new_slot] = self._slot_ids[old_slot]
                new_meta[new_slot] = self._slot_meta[old_slot]
                new_vals[new_slot] = self._slot_values[old_slot]
            self._id_to_slot = remap
            self._slot_ids, self._slot_meta, self._slot_values = new_ids, new_meta, new_vals
            self._rebuild_meta_columns()  # slots moved: native metadata mirror is stale
            # the grown region [old, per_shard) of each shard is handed out by the
            # shard's high-water mark, not the free list: listing it in both gave
            # the same slot twice once the free list ran dry
            self._shard_free = [
                [sh * per_shard + (f - sh * old) for f in free]
                for sh, free in enumerate(self._shard_free)
            ]
        self.shard_capacity = per_shard

    def _ensure_capacity(self, extra: int) -> None:
        # grow when ANY shard could overflow; worst case all new ids hash to one shard
        worst_free = min(
            len(free) + (self.shard_capacity - high)
            for free, high in zip(self._shard_free, self._shard_high)
        ) if self.shard_capacity else 0
        if self._data is not None and extra <= worst_free:
            return
        per_shard_needed = max(h for h in self._shard_high) + extra if self.shard_capacity else extra
        new_global = self.n_shards * self.config.round_capacity(
            max(per_shard_needed, self.config.initial_capacity // self.n_shards + 1)
        )
        if new_global > self.config.max_capacity:
            raise MemoryError(
                f"namespace {self.name!r} would exceed max_capacity={self.config.max_capacity}"
            )
        self._alloc_arrays(new_global // self.n_shards * self.n_shards)
        self.capacity = self.shard_capacity * self.n_shards
        self._grow_host_tables(self.capacity)

    def _alloc_slot(self, vid: uuid_mod.UUID) -> int:
        sh = self.sharding.shard_for_id(vid)
        if self._shard_free[sh]:
            return self._shard_free[sh].pop()
        loc = self._shard_high[sh]
        if loc >= self.shard_capacity:
            # _ensure_capacity sizes for the all-ids-hash-to-one-shard worst case before
            # any slot is handed out, so this cannot happen mid-batch
            raise RuntimeError(
                f"shard {sh} overflow in namespace {self.name!r} (capacity invariant broken)"
            )
        self._shard_high[sh] = loc + 1
        self._high_water = sum(self._shard_high)  # keeps rebuild_required's ratio meaningful
        return sh * self.shard_capacity + loc

    def _free_slot(self, slot: int) -> None:
        sh = slot // self.shard_capacity
        self._shard_free[sh].append(slot)

    def _restore_device_arrays(self, host) -> None:
        """Offload page-in: re-apply the mesh shardings the plain restore lacks."""
        super()._restore_device_arrays(host)
        self._data = jax.device_put(self._data, self.sharding.db_sharding_2d())
        self._valid = jax.device_put(self._valid, self.sharding.db_sharding())
        self._sq_norms = jax.device_put(self._sq_norms, self.sharding.db_sharding())
        if self._data_t is not None:
            self._data_t = jax.device_put(self._data_t, self.sharding.db_sharding_2d_t())

    # ------------------------------------------------------------------ compaction

    def compact(self) -> None:
        """Per-shard repack: rebuild as a fresh sharded store and swap state in."""
        with self._lock:
            old_version = self.version
            vectors = self.all_vectors()
            fresh = ShardedNamespaceStore(
                self.name, self.sharding, self.config, self.host_mirror
            )
            if self.dim is not None:
                fresh._ensure_dim(self.dim)
            if vectors:
                fresh.upsert(vectors)
            self.__dict__.update(
                {
                    k: v
                    for k, v in fresh.__dict__.items()
                    # keep identity fields AND the IVF index: it keys by uuid over its own
                    # cluster-major copies, so store-slot repacking cannot stale it
                    if k not in ("_lock", "name", "config", "host_mirror", "sharding", "ivf")
                }
            )
            self._tombstones = 0
            # version must stay MONOTONIC across the state swap: fresh's counter starts
            # at 0 and could collide with a pre-compaction version, resurrecting stale
            # filter-mask / result-cache entries keyed by (version, capacity) whose slot
            # layout no longer exists (found by the sharded model-based fuzz: a stale
            # mask ANDed with the repacked liveness masked out the whole namespace)
            self.version = max(old_version, self.version) + 1
            self._publish()

    # ------------------------------------------------------------------ repair

    def reconcile_and_repair(self, rm) -> dict:
        """Verify replica consistency and, on divergence, restore it on device.

        ``rm``: a ReplicationManager on this store's mesh.  Repair re-broadcasts the
        majority replica's rows over the replica axis (one psum per array — no host
        round trip of row data), recomputes sq_norms and the sweep mirror from the
        repaired matrix, and republishes atomically.  Returns the repair report."""
        with self._lock:
            if self._data is None:
                return {"consistent": True, "repaired": False}
            data2, valid2, report = rm.repair(self._data, self._valid)
            if report.get("repaired"):
                self._data, self._valid = data2, valid2
                self._sq_norms = jnp.sum(
                    self._data.astype(jnp.float32) ** 2, axis=-1
                )
                self._data_t = self._build_mirror()
                self._sweep_err = self._build_sweep_err()
                self.version += 1
                self._publish()
            return report

    # ------------------------------------------------------------------ search

    def sharded_search(self, q: jax.Array, k: int, metric: str, valid_override=None):
        """(dist [B,k], global slot idx [B,k]) via the cross-shard merge reduction.

        ``valid_override``: optional [capacity] bool (liveness AND filter mask) — the
        hybrid-query path; defaults to the store's liveness mask.
        """
        state = self.device_state()
        valid = state.valid if valid_override is None else valid_override
        return self.sharding.sharded_knn(
            q, state.data, valid, state.sq_norms, state.data_t, state.sweep_err,
            k=k, metric=metric, db_tile=self.config.db_tile,
        )
