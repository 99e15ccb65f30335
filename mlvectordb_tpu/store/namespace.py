"""Per-namespace device store: padded HBM matrix + liveness mask + host id tables.

This single structure replaces BOTH the reference's dict-of-dicts storage
(reference: src/mlvectordb/implementations/storage_engine_in_memory.py:12) and its
per-namespace hnswlib graph + uuid<->label bimaps
(reference: src/mlvectordb/implementations/index.py:32-67): on the device, exact search over the
namespace matrix IS the index, so there is no separate graph to keep consistent.

Device state (all shapes static under jit; capacity grows in powers of two):
  data     [capacity, dim_padded]  storage dtype (f32/bf16), rows lane-padded with zeros
  valid    [capacity]              bool — False = never-written, tombstoned, or freed slot
  sq_norms [capacity]              f32  — precomputed squared norms (L2/cosine need them)

Host state: slot -> uuid / metadata / (optional) original float32 values, uuid -> slot map,
free-slot stack.  Writes scatter into free slots (true upsert overwrites in place, fixing
the reference's mint-a-fresh-uuid4 "upsert", SURVEY.md §3.2); deletes clear the mask.
Compaction repacks live rows and is strictly per-namespace (the reference's rebuild wipes
every other namespace's index — SURVEY.md §3.4 — a bug we deliberately do not inherit).
"""

from __future__ import annotations

import threading
import uuid as uuid_mod
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from .vector import Vector


class DeviceState(NamedTuple):
    """Immutable snapshot of the searchable device arrays (functional => a search holding
    this tuple is isolated from concurrent writers; single-writer/snapshot-reads,
    SURVEY.md §7)."""

    data: jax.Array      # [cap, dpad]
    valid: jax.Array     # [cap] bool
    sq_norms: jax.Array  # [cap] f32
    # Host counters captured at publish time.  Readers deriving the live-prefix fast
    # path MUST use these, not the store's live attributes: an upsert bumps
    # _high_water before the device scatter publishes, so pairing an old data
    # snapshot with the live _high_water would admit never-written all-zero rows
    # into top-k (all-zero row: l2 dist = |q|^2, ip/cosine dist = 1.0).
    high_water: int
    live_count: int
    # Optional transposed sweep mirror [dpad, cap] in config.sweep_dtype: phase-1 of
    # the certified sweep (ops/pallas_knn_t.py) reads this; rescan/hydration read data.
    data_t: Optional[jax.Array] = None
    # Mixed f32-store/bf16-sweep configs: per-row data-side error norms [cap] f32,
    # feeding the kernel's exactness certificate (tight sound bound on phase-1 rank
    # error; see ops/pallas_knn_t._fused_t).  Without the residual mirror this is
    # ||row - bf16(row)||; with it, the residual quantizer's remaining error.
    sweep_err: Optional[jax.Array] = None
    # Residual-corrected sweep (config.sweep_resid, mixed configs): int8 codes of
    # delta = row - bf16(row) in sweep layout [dpad, cap], per-row dequant scales
    # [cap] f32, and raw ||delta|| norms [cap] f32 — phase 1 adds one product to
    # recover qh . delta, shrinking the certified error band ~2^-8x so the fast tier
    # certifies even on tightly clustered corpora (ops/pallas_knn_t._window_mins_xla).
    sweep_resid: Optional[jax.Array] = None
    sweep_rscale: Optional[jax.Array] = None
    sweep_err1: Optional[jax.Array] = None
    # int8 PRIMARY sweep with residual correction (sweep_dtype="int8" + sweep_resid):
    # sweep_rscale is the primary dequant scale s1 and sweep_rscale2 the residual
    # scale s2 (row ~ s1*z1 + s2*z2, two int8 streams at 2 B/element total).
    sweep_rscale2: Optional[jax.Array] = None
    # Host slot tables (ids, metadata, values) captured at publish time.  Hydration of
    # store-slot results MUST read all three from here — one atomic tuple — never from
    # the store's live attributes: compact() replaces the three lists wholesale, so a
    # racing reader assembling them attribute-by-attribute could pair one generation's
    # ids with another's values (ADVICE r2).  The lists are shared with in-place
    # writers, which is safe: a slot this snapshot's `valid` admits is never remapped
    # by anything short of a compaction, and a compaction builds new lists.
    host_tables: Optional[tuple] = None
    # Per-snapshot cache of QUERY-INDEPENDENT kernel prep (bias/scale rows in sweep
    # column order, per-window certificate bounds, maxd) keyed by (metric, r1, plan):
    # at DEEP shape these permutes cost ~1.2 ms per search when traced inline
    # (benchmarks/probe_qprep.py).  A fresh dict per publish — the arrays are only
    # valid for THIS snapshot's data/hw.  Mutated in place by readers (GIL-atomic
    # get/set; a racing reader at worst recomputes the same arrays).
    # Filtered searches nest their prep under ("filter", filter_cache_key) inside
    # this same dict, so filter-scoped prep lives and dies with the snapshot —
    # version-keyed side caches have a poisoning window because writers bump
    # ns.version BEFORE publishing.
    prep_cache: Optional[dict] = None


# NOTE: deliberately NOT donated.  Donating the store buffers makes writes zero-copy,
# but a search dispatched a moment earlier may still hold the old buffer, and a runtime
# need not surface that race as the catchable "Array has been deleted" dispatch error
# (which the engine's RCU retry handles).  Copy-on-write costs one device-side array
# copy per write batch and buys true snapshot isolation.
@jax.jit
def _scatter_rows(data, valid, sq_norms, slots, vals):
    """Device-side upsert: scatter rows + norms, set liveness (copy-on-write)."""
    vals32 = vals.astype(jnp.float32)
    data = data.at[slots].set(vals32.astype(data.dtype))
    sq_norms = sq_norms.at[slots].set(jnp.sum(vals32 * vals32, axis=-1))
    valid = valid.at[slots].set(True)
    return data, valid, sq_norms


@jax.jit
def _scatter_cols_t(data_t, cols, vals):
    """Sweep-mirror update: scatter rows as COLUMNS of the [dpad, cap] mirror.

    ``cols`` are WINDOW-MAJOR sweep-layout columns (ops.pallas_knn_t.sweep_cols_for_rows
    of the store slots — computed host-side, pure arithmetic)."""
    return data_t.at[:, cols].set(vals.astype(jnp.float32).T.astype(data_t.dtype))


@jax.jit
def _scatter_sweep_err(err, slots, vals):
    """Maintain per-row ||row - bf16(row)|| for the kernel's exactness certificate
    (mixed f32-store/bf16-sweep configs only)."""
    v32 = vals.astype(jnp.float32)
    delta = v32 - v32.astype(jnp.bfloat16).astype(jnp.float32)
    return err.at[slots].set(jnp.sqrt(jnp.sum(delta * delta, axis=-1)))


@jax.jit
def _scatter_int8(data_t, rscale, err, slots, cols, vals):
    """int8 PRIMARY sweep mirror (sweep_dtype="int8"): quantize the written rows and
    scatter codes + per-row dequant scales + quantization-error norms."""
    from ..ops.pallas_knn_t import quantize_int8_rows

    z, s, e = quantize_int8_rows(vals)
    return (
        data_t.at[:, cols].set(z.T),
        rscale.at[slots].set(s),
        err.at[slots].set(e),
    )


@jax.jit
def _scatter_int8_resid(data_t, rscale, resid_t, rscale2, err, err1, slots, cols, vals):
    """Two-level int8 sweep (sweep_dtype="int8" + sweep_resid): quantize written rows
    as s1*z1 + s2*z2 and scatter both code streams + scales + error norms."""
    from ..ops.pallas_knn_t import quantize_int8_resid_rows

    z1, s1, z2, s2, e2, e1 = quantize_int8_resid_rows(vals)
    return (
        data_t.at[:, cols].set(z1.T),
        rscale.at[slots].set(s1),
        resid_t.at[:, cols].set(z2.T),
        rscale2.at[slots].set(s2),
        err.at[slots].set(e2),
        err1.at[slots].set(e1),
    )


@jax.jit
def _scatter_resid(err, err1, rscale, resid_t, slots, cols, vals):
    """Maintain the int8 residual mirror + its scales/error norms in one scatter
    (residual-corrected sweep, config.sweep_resid)."""
    from ..ops.pallas_knn_t import quantize_resid_rows

    z, scale, e2, e1 = quantize_resid_rows(vals)
    return (
        err.at[slots].set(e2),
        err1.at[slots].set(e1),
        rscale.at[slots].set(scale),
        resid_t.at[:, cols].set(z.T),
    )


@jax.jit
def _clear_slots(valid, slots):
    """Device-side delete: tombstone = mask clear (copy-on-write)."""
    return valid.at[slots].set(False)


def _pow2_pad(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class NamespaceStore:
    """One namespace's vectors, device-resident and exactly searchable."""

    def __init__(self, name: str, config: EngineConfig = DEFAULT_CONFIG, host_mirror: bool = True):
        self.name = name
        self.config = config
        self.host_mirror = host_mirror
        self._lock = threading.RLock()
        # Incarnation token: version numbers restart at 0 when a namespace is GC'd and
        # recreated under the same name, so (name, version) cache keys can resurrect a
        # DEAD incarnation's results.  Every cache keyed on this store must include this.
        self.incarnation = uuid_mod.uuid4().hex

        self.dim: Optional[int] = None   # logical dim, fixed at first write
        self.dpad: int = 0
        self.capacity: int = 0

        self._data: Optional[jax.Array] = None
        self._valid: Optional[jax.Array] = None
        self._sq_norms: Optional[jax.Array] = None
        self._data_t: Optional[jax.Array] = None  # transposed sweep mirror (config.sweep_dtype)
        self._sweep_err: Optional[jax.Array] = None  # [cap] data-side error norms (mixed config)
        self._sweep_resid: Optional[jax.Array] = None   # [dpad, cap] int8 residual codes
        self._sweep_rscale: Optional[jax.Array] = None  # [cap] per-row dequant scales
        self._sweep_err1: Optional[jax.Array] = None    # [cap] raw ||delta|| norms
        self._sweep_rscale2: Optional[jax.Array] = None  # [cap] resid scales (int8 sweep)
        # atomically-published snapshot tuple: readers must never assemble a state from
        # the individual attributes (a concurrent growth could interleave generations)
        self._state: Optional[DeviceState] = None

        # slot-indexed host tables
        self._slot_ids: List[Optional[uuid_mod.UUID]] = []
        self._slot_meta: List[Optional[Dict[str, Any]]] = []
        self._slot_values: List[Optional[np.ndarray]] = []   # host mirror (float32, unpadded)
        self._id_to_slot: Dict[uuid_mod.UUID, int] = {}
        self._free: List[int] = []
        self._high_water = 0          # slots ever used (never reused slots beyond this)
        self._tombstones = 0          # deletes since last compaction
        self.version = 0              # bumped on every mutation (filter-mask cache key)
        # native columnar metadata mirror (C++ filter evaluation); None until first use
        self.meta_columns = None
        self._meta_columns_tried = False
        # optional approximate index (store/ivf.py), attached by QueryProcessor.build_ivf
        self.ivf = None
        # host-RAM offload state (offload()/ensure_resident()): lets cold namespaces
        # vacate HBM and page back in on first touch — the scale axis beyond one
        # chip's memory (SURVEY.md §5.7)
        self._offloaded: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ properties

    @property
    def live_count(self) -> int:
        return len(self._id_to_slot)

    @property
    def nbytes(self) -> int:
        """Exact device-array byte accounting (replaces the reference's sys.getsizeof walk,
        storage_engine_in_memory.py:22-30)."""
        if self._data is None:
            # offloaded namespaces hold no HBM; count their host copy instead
            if self._offloaded is not None:
                return sum(int(a.nbytes) for a in self._offloaded.values())
            return 0
        itemsize = 2 if self.config.dtype == "bfloat16" else 4
        total = self.capacity * self.dpad * itemsize + self.capacity * (1 + 4)
        if self._data_t is not None:
            total += self._data_t.size * self._data_t.dtype.itemsize
        if self._sweep_resid is not None:
            total += self._sweep_resid.size + self.capacity * 8  # codes + scale/err1
        for aux in (self._sweep_rscale, self._sweep_rscale2):
            if aux is not None:
                total += aux.size * 4
        return total

    @property
    def ids(self) -> List[uuid_mod.UUID]:
        return list(self._id_to_slot.keys())

    def device_state(self) -> DeviceState:
        state = self._state  # single attribute read = atomic under the GIL
        if state is None:
            if self._offloaded is not None:
                self.ensure_resident()
                state = self._state
            if state is None:
                raise ValueError(f"namespace {self.name!r} is empty")
        return state

    # ------------------------------------------------------------------ HBM offload

    @property
    def offloaded(self) -> bool:
        return self._offloaded is not None

    def offload(self) -> bool:
        """Move the device arrays to host RAM and free their HBM.  Reads that hit the
        host tables (get/all_vectors with host_mirror) keep working; the first search
        or mutation pages the namespace back in transparently."""
        with self._lock:
            if self._data is None or self._offloaded is not None:
                return False
            self._offloaded = {
                "data": np.asarray(jax.device_get(self._data)),
                "valid": np.asarray(jax.device_get(self._valid)),
                "sq_norms": np.asarray(jax.device_get(self._sq_norms)),
            }
            self._data = self._valid = self._sq_norms = None
            self._data_t = None  # cheap to rebuild from data on restore
            self._sweep_err = None
            self._sweep_resid = self._sweep_rscale = self._sweep_err1 = None
            self._sweep_rscale2 = None
            self._state = None   # readers route through ensure_resident
            return True

    def _restore_device_arrays(self, host: Dict[str, Any]) -> None:
        """Re-materialize device arrays from host copies (sharded stores override to
        re-apply their NamedShardings)."""
        self._data = jnp.asarray(host["data"], self._storage_dtype())
        self._valid = jnp.asarray(host["valid"])
        self._sq_norms = jnp.asarray(host["sq_norms"])
        self._data_t = self._build_mirror()
        self._rebuild_sweep_aux()

    def ensure_resident(self) -> bool:
        """Page an offloaded namespace back into HBM (no-op when resident)."""
        with self._lock:
            if self._offloaded is None:
                return False
            host = self._offloaded
            self._restore_device_arrays(host)
            self._offloaded = None
            self._publish()
            return True

    def _publish(self) -> None:
        """Swap in a new consistent (data, valid, sq_norms, counters) generation."""
        self._state = DeviceState(
            self._data, self._valid, self._sq_norms,
            self._high_water, len(self._id_to_slot),
            data_t=self._data_t,
            sweep_err=self._sweep_err,
            sweep_resid=self._sweep_resid,
            sweep_rscale=self._sweep_rscale,
            sweep_err1=self._sweep_err1,
            sweep_rscale2=self._sweep_rscale2,
            host_tables=(self._slot_ids, self._slot_meta, self._slot_values)
            if self.host_mirror else None,
            prep_cache={},
        )

    # ------------------------------------------------------------------ allocation

    def _ensure_dim(self, dim: int) -> None:
        if self.dim is None:
            self.dim = dim
            self.dpad = self.config.pad_dim(dim)
        elif dim != self.dim:
            raise ValueError(
                f"dimension mismatch in namespace {self.name!r}: store is {self.dim}-d, got {dim}-d"
            )

    def _storage_dtype(self):
        return jnp.bfloat16 if self.config.dtype == "bfloat16" else jnp.float32

    def _sweep_dtype(self):
        """Dtype of the transposed sweep mirror, or None when the mirror is disabled."""
        sd = self.config.sweep_dtype
        if sd is None:
            return None
        return {"bfloat16": jnp.bfloat16, "int8": jnp.int8}.get(sd, jnp.float32)

    def _int8_sweep(self) -> bool:
        """int8 primary sweep active (maintains codes + dequant scales + err norms)."""
        return self._sweep_dtype() == jnp.int8

    def _mirror_ok(self, cap: int) -> bool:
        """The window-major sweep layout (ops/pallas_knn_t.py) needs whole
        SWEEP_TILE-row tiles; smaller/unaligned capacities run mirror-less (the fused
        kernel disengages below 2 tiles anyway)."""
        from ..ops.pallas_knn_t import SWEEP_TILE

        return cap >= SWEEP_TILE and cap % SWEEP_TILE == 0

    def _mixed_sweep(self) -> bool:
        """True for the f32-store + bf16-sweep config (the only one with a phase-1 /
        rescan representation mismatch — maintains _sweep_err for the certificate)."""
        return (
            self._storage_dtype() == jnp.float32
            and self._sweep_dtype() == jnp.bfloat16
        )

    # Sharded stores disable the residual mirror for now (its arrays would need
    # per-shard placement + shard_map plumbing); their certificate still runs on the
    # per-window sweep_err bounds, escalating more often on adversarial corpora.
    _resid_capable = True

    def _use_resid(self) -> bool:
        """Residual-corrected sweep active (config.sweep_resid): mixed
        f32-store/bf16-sweep configs (delta = row - bf16(row)) and int8 PRIMARY
        sweeps (two-level codes, delta1 = row - s1*z1)."""
        return (
            self._resid_capable
            and self.config.sweep_resid
            and (self._mixed_sweep() or self._int8_sweep())
        )

    def _build_mirror(self):
        """(Re)build the window-major sweep mirror from the current device matrix.

        int8 configs quantize the FULL store here and stash the byproducts
        (scales/error norms/residual codes) in ``_int8_aux`` for the paired
        _rebuild_sweep_aux call — quantization is two whole-store passes on a
        multi-GB namespace, and recomputing it per array under the compaction
        lock doubled the writer pause."""
        sdt = self._sweep_dtype()
        if sdt is None or self._data is None or not self._mirror_ok(self._data.shape[0]):
            return None
        if sdt == jnp.int8:
            if self._use_resid():
                from ..ops.pallas_knn_t import quantize_int8_resid

                out = quantize_int8_resid(self._data)
                self._int8_aux = out
                return out[0]
            from ..ops.pallas_knn_t import quantize_int8

            out = quantize_int8(self._data)
            self._int8_aux = out
            return out[0]
        from ..ops.pallas_knn_t import to_sweep_layout

        return to_sweep_layout(self._data, dtype=sdt)

    def _build_sweep_err(self):
        """Per-row bf16-rounding norms matching the mirror, or None when not mixed."""
        if self._data_t is None or not self._mixed_sweep():
            return None
        d32 = self._data.astype(jnp.float32)
        delta = d32 - d32.astype(jnp.bfloat16).astype(jnp.float32)
        return jnp.sqrt(jnp.sum(delta * delta, axis=-1))

    def _rebuild_sweep_aux(self) -> None:
        """(Re)derive every certificate-side array from the current device matrix —
        must run whenever _data_t is rebuilt wholesale (compact, restore, regrow)."""
        self._sweep_resid = self._sweep_rscale = self._sweep_err1 = None
        self._sweep_rscale2 = None
        aux, self._int8_aux = getattr(self, "_int8_aux", None), None
        if self._use_resid() and self._data_t is not None:
            if self._int8_sweep():
                if aux is None or len(aux) != 6:  # aux missing: quantize fresh
                    from ..ops.pallas_knn_t import quantize_int8_resid

                    aux = quantize_int8_resid(self._data)
                (_, self._sweep_rscale, self._sweep_resid, self._sweep_rscale2,
                 self._sweep_err, self._sweep_err1) = aux
            else:
                from ..ops.pallas_knn_t import quantize_resid

                (self._sweep_resid, self._sweep_rscale,
                 self._sweep_err, self._sweep_err1) = quantize_resid(self._data)
        elif self._int8_sweep() and self._data_t is not None:
            if aux is None or len(aux) != 3:
                # rows variant: the sweep-layout codes are discarded here, so the
                # whole-store transpose quantize_int8 adds would be thrown away
                from ..ops.pallas_knn_t import quantize_int8_rows

                aux = quantize_int8_rows(self._data)
            _, self._sweep_rscale, self._sweep_err = aux
        else:
            self._sweep_err = self._build_sweep_err()

    def _mirror_cols(self, slots: np.ndarray) -> np.ndarray:
        """Store slots -> sweep-layout mirror columns (host-side arithmetic)."""
        from ..ops.pallas_knn_t import sweep_cols_for_rows

        return sweep_cols_for_rows(slots)

    def _alloc_arrays(self, new_cap: int) -> None:
        """Create or grow the device arrays to new_cap rows (hook for sharded variant)."""
        dtype = self._storage_dtype()
        sdt = self._sweep_dtype()
        if self._data is None:
            self._data = jnp.zeros((new_cap, self.dpad), dtype)
            self._valid = jnp.zeros((new_cap,), jnp.bool_)
            self._sq_norms = jnp.zeros((new_cap,), jnp.float32)
            if sdt is not None and self._mirror_ok(new_cap):
                self._data_t = jnp.zeros((self.dpad, new_cap), sdt)
                if self._mixed_sweep() or self._int8_sweep():
                    self._sweep_err = jnp.zeros((new_cap,), jnp.float32)
                    if self._int8_sweep():
                        self._sweep_rscale = jnp.zeros((new_cap,), jnp.float32)
                        if self._use_resid():
                            self._sweep_resid = jnp.zeros((self.dpad, new_cap), jnp.int8)
                            self._sweep_rscale2 = jnp.zeros((new_cap,), jnp.float32)
                            self._sweep_err1 = jnp.zeros((new_cap,), jnp.float32)
                    elif self._use_resid():
                        self._sweep_resid = jnp.zeros((self.dpad, new_cap), jnp.int8)
                        self._sweep_rscale = jnp.zeros((new_cap,), jnp.float32)
                        self._sweep_err1 = jnp.zeros((new_cap,), jnp.float32)
        else:
            grow = new_cap - self.capacity
            old_cap = self.capacity
            self._data = jnp.pad(self._data, ((0, grow), (0, 0)))
            self._valid = jnp.pad(self._valid, (0, grow))
            self._sq_norms = jnp.pad(self._sq_norms, (0, grow))
            if sdt is not None and self._mirror_ok(new_cap):
                if self._data_t is not None and self._mirror_ok(old_cap):
                    # window-major layout is tile-local: whole appended tiles extend
                    # the column axis without disturbing existing tiles
                    self._data_t = jnp.pad(self._data_t, ((0, 0), (0, grow)))
                    if self._sweep_err is not None:
                        self._sweep_err = jnp.pad(self._sweep_err, (0, grow))
                    if self._sweep_rscale is not None:
                        self._sweep_rscale = jnp.pad(self._sweep_rscale, (0, grow))
                    if self._sweep_rscale2 is not None:
                        self._sweep_rscale2 = jnp.pad(self._sweep_rscale2, (0, grow))
                    if self._sweep_err1 is not None:
                        self._sweep_err1 = jnp.pad(self._sweep_err1, (0, grow))
                    if self._sweep_resid is not None:
                        self._sweep_resid = jnp.pad(self._sweep_resid, ((0, 0), (0, grow)))
                else:
                    self._data_t = self._build_mirror()  # first eligible capacity
                    self._rebuild_sweep_aux()
            else:
                self._data_t = None
                self._sweep_err = None
                self._sweep_resid = self._sweep_rscale = self._sweep_err1 = None
                self._sweep_rscale2 = None

    def _grow_host_tables(self, new_cap: int) -> None:
        self._slot_ids.extend([None] * (new_cap - len(self._slot_ids)))
        self._slot_meta.extend([None] * (new_cap - len(self._slot_meta)))
        self._slot_values.extend([None] * (new_cap - len(self._slot_values)))
        if self.meta_columns is not None and new_cap > self.meta_columns.capacity:
            self.meta_columns.resize(new_cap)

    def _ensure_meta_columns(self):
        """Lazily stand up the C++ columnar metadata mirror (None if no toolchain)."""
        if self.meta_columns is None and not self._meta_columns_tried:
            self._meta_columns_tried = True
            try:
                from ..native import MetaColumns, available

                if available():
                    self.meta_columns = MetaColumns(max(self.capacity, 1))
            except Exception:  # pragma: no cover - native unavailable
                self.meta_columns = None
        return self.meta_columns

    def _alloc_slot(self, vid: uuid_mod.UUID) -> int:
        """Pick a slot for a new id (hook: sharded variant routes by shard_for_id)."""
        if self._free:
            return self._free.pop()
        slot = self._high_water
        self._high_water += 1
        return slot

    def _free_slot(self, slot: int) -> None:
        self._free.append(slot)

    def _ensure_capacity(self, extra: int) -> None:
        new_slots = max(0, extra - len(self._free))
        needed = self._high_water + new_slots
        if needed <= self.capacity and self._data is not None:
            return
        new_cap = self.config.round_capacity(needed)
        if new_cap > self.config.max_capacity:
            raise MemoryError(
                f"namespace {self.name!r} would exceed max_capacity={self.config.max_capacity}"
            )
        self._alloc_arrays(new_cap)
        self.capacity = new_cap
        self._grow_host_tables(new_cap)

    # ------------------------------------------------------------------ mutation

    def _scatter_write(self, slots: np.ndarray, vals: np.ndarray) -> None:
        """Apply one bucketed write batch to every device array (data + mirrors)."""
        slots_j, vals_j = jnp.asarray(slots), jnp.asarray(vals)
        self._data, self._valid, self._sq_norms = _scatter_rows(
            self._data, self._valid, self._sq_norms, slots_j, vals_j
        )
        if self._data_t is not None:
            cols_j = jnp.asarray(self._mirror_cols(slots))
            if self._data_t.dtype == jnp.int8:
                if self._sweep_resid is not None:
                    (self._data_t, self._sweep_rscale, self._sweep_resid,
                     self._sweep_rscale2, self._sweep_err,
                     self._sweep_err1) = _scatter_int8_resid(
                        self._data_t, self._sweep_rscale, self._sweep_resid,
                        self._sweep_rscale2, self._sweep_err, self._sweep_err1,
                        slots_j, cols_j, vals_j,
                    )
                    return
                self._data_t, self._sweep_rscale, self._sweep_err = _scatter_int8(
                    self._data_t, self._sweep_rscale, self._sweep_err,
                    slots_j, cols_j, vals_j,
                )
                return
            self._data_t = _scatter_cols_t(self._data_t, cols_j, vals_j)
            if self._sweep_resid is not None:
                (self._sweep_err, self._sweep_err1, self._sweep_rscale,
                 self._sweep_resid) = _scatter_resid(
                    self._sweep_err, self._sweep_err1, self._sweep_rscale,
                    self._sweep_resid, slots_j, cols_j, vals_j,
                )
            elif self._sweep_err is not None:
                self._sweep_err = _scatter_sweep_err(self._sweep_err, slots_j, vals_j)

    def upsert(self, vectors: Sequence[Vector]) -> None:
        """Insert or overwrite-by-id a batch of vectors (one device scatter)."""
        if not vectors:
            return
        with self._lock:
            if self._offloaded is not None:
                self.ensure_resident()
            self._ensure_dim(vectors[0].dim)
            for v in vectors:
                if v.dim != self.dim:
                    raise ValueError(
                        f"dimension mismatch in namespace {self.name!r}: store is "
                        f"{self.dim}-d, got {v.dim}-d"
                    )
            fresh = sum(1 for v in vectors if v.id not in self._id_to_slot)
            self._ensure_capacity(fresh)

            slots = np.empty(len(vectors), np.int32)
            for i, v in enumerate(vectors):
                slot = self._id_to_slot.get(v.id)
                if slot is None:
                    slot = self._alloc_slot(v.id)
                    self._id_to_slot[v.id] = slot
                slots[i] = slot
                self._slot_ids[slot] = v.id
                self._slot_meta[slot] = v.metadata
                self._slot_values[slot] = v.values if self.host_mirror else None

            mc = self._ensure_meta_columns()
            if mc is not None:
                ok = mc.set_many(
                    [int(s) for s in slots], [v.metadata for v in vectors]
                )
                if not ok:
                    # metadata not representable natively: drop the mirror entirely
                    # (filters fall back to Python for this namespace)
                    self.meta_columns = None

            vals = np.zeros((len(vectors), self.dpad), np.float32)
            for i, v in enumerate(vectors):
                vals[i, : self.dim] = v.values

            # Bucket the scatter width to powers of two (pad by repeating row 0 — the
            # duplicate scatter rewrites identical data, so it is idempotent) to bound
            # the number of compiled scatter programs.
            n = len(vectors)
            nb = _pow2_pad(n)
            if nb != n:
                slots = np.concatenate([slots, np.full(nb - n, slots[0], np.int32)])
                vals = np.concatenate([vals, np.broadcast_to(vals[0], (nb - n, self.dpad))])

            self._scatter_write(slots, vals)
            self.version += 1
            self._publish()

    def bulk_upsert(
        self,
        values: np.ndarray,                 # [n, dim] float32
        ids: Optional[Sequence[uuid_mod.UUID]] = None,
        metadatas: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
    ) -> List[uuid_mod.UUID]:
        """Vectorized ingestion: no per-vector Python objects on the hot path.

        The per-vector upsert() costs ~20 us/row of host bookkeeping (Vector objects,
        dict churn); this path allocates slots in bulk, pads once, scatters once, and
        feeds metadata to the native mirror in one FFI call — the ingestion path for
        bulk loads and snapshot restores.
        """
        values = np.ascontiguousarray(values, np.float32)
        n = values.shape[0]
        if n == 0:
            return []
        with self._lock:
            if self._offloaded is not None:
                self.ensure_resident()
            self._ensure_dim(int(values.shape[1]))
            if ids is None:
                ids = [uuid_mod.uuid4() for _ in range(n)]
            fresh = sum(1 for vid in ids if vid not in self._id_to_slot)
            self._ensure_capacity(fresh)

            slots = np.empty(n, np.int32)
            metas = metadatas if metadatas is not None else [None] * n
            for i, vid in enumerate(ids):
                slot = self._id_to_slot.get(vid)
                if slot is None:
                    slot = self._alloc_slot(vid)
                    self._id_to_slot[vid] = slot
                slots[i] = slot
                self._slot_ids[slot] = vid
                self._slot_meta[slot] = dict(metas[i]) if metas[i] else {}
                self._slot_values[slot] = values[i] if self.host_mirror else None

            vals = np.zeros((n, self.dpad), np.float32)
            vals[:, : self.dim] = values

            mc = self._ensure_meta_columns()
            if mc is not None and not mc.set_many(
                [int(s) for s in slots], [self._slot_meta[s] for s in slots]
            ):
                self.meta_columns = None

            nb = _pow2_pad(n)
            if nb != n:
                slots = np.concatenate([slots, np.full(nb - n, slots[0], np.int32)])
                vals = np.concatenate([vals, np.broadcast_to(vals[0], (nb - n, self.dpad))])
            self._scatter_write(slots, vals)
            self.version += 1
            self._publish()
            return list(ids)

    def delete(self, ids: Sequence[uuid_mod.UUID]) -> List[uuid_mod.UUID]:
        """Tombstone-delete; returns the ids actually removed (reference semantics:
        query_processor.py:51-62 returns only ids present in storage)."""
        with self._lock:
            if self._offloaded is not None:
                self.ensure_resident()
            slots, removed = [], []
            for vid in ids:
                slot = self._id_to_slot.pop(vid, None)
                if slot is None:
                    continue
                slots.append(slot)
                removed.append(vid)
                self._slot_ids[slot] = None
                self._slot_meta[slot] = None
                self._slot_values[slot] = None
                if self.meta_columns is not None:
                    self.meta_columns.clear(slot)
                self._free_slot(slot)
                self._tombstones += 1
            if not slots:
                return []
            arr = np.asarray(slots, np.int32)
            nb = _pow2_pad(len(arr))
            if nb != len(arr):
                arr = np.concatenate([arr, np.full(nb - len(arr), arr[0], np.int32)])
            self._valid = _clear_slots(self._valid, jnp.asarray(arr))
            self.version += 1
            self._publish()

            if self.rebuild_required():
                self.compact()
            return removed

    def rebuild_required(self) -> bool:
        """Tombstone-ratio trigger, mirroring the reference's rebuild_threshold semantics
        (index.py:84-89) but evaluated against slots ever used."""
        if self._high_water == 0:
            return False
        return self._tombstones / self._high_water >= self.config.rebuild_threshold

    def compact(self) -> None:
        """Repack live rows to the front and shrink capacity.  Per-namespace only."""
        with self._lock:
            if self._offloaded is not None:
                self.ensure_resident()
            live = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            if self._data is not None and live:
                old_slots = np.asarray([s for _, s in live], np.int32)
                # gather live rows on device, rebuild tables host-side
                data_live = np.asarray(jax.device_get(self._data[old_slots]), np.float32)
                new_ids = [vid for vid, _ in live]
                new_meta = [self._slot_meta[s] for _, s in live]
                new_vals = [self._slot_values[s] for _, s in live]
            else:
                data_live, new_ids, new_meta, new_vals = None, [], [], []

            n = len(new_ids)
            self._id_to_slot = {vid: i for i, vid in enumerate(new_ids)}
            self._free = []
            self._high_water = n
            self._tombstones = 0
            self.version += 1

            if self.dim is None:
                return
            new_cap = self.config.round_capacity(max(n, 1))
            dtype = jnp.bfloat16 if self.config.dtype == "bfloat16" else jnp.float32
            buf = np.zeros((new_cap, self.dpad), np.float32)
            if n:
                buf[:n] = data_live
            self._data = jnp.asarray(buf, dtype)
            self._data_t = self._build_mirror()
            # the mirror's certificate arrays must be rebuilt in lockstep: publishing
            # a stale pre-compaction _sweep_err (or residual codes) would feed wrong
            # per-row bounds into the exactness certificate (ADVICE r3 high)
            self._rebuild_sweep_aux()
            valid = np.zeros((new_cap,), bool)
            valid[:n] = True
            self._valid = jnp.asarray(valid)
            self._sq_norms = jnp.asarray((buf.astype(np.float64) ** 2).sum(-1).astype(np.float32))
            self.capacity = new_cap
            self._slot_ids = new_ids + [None] * (new_cap - n)
            self._slot_meta = new_meta + [None] * (new_cap - n)
            self._slot_values = new_vals + [None] * (new_cap - n)
            self._rebuild_meta_columns()
            self._publish()  # new generation visible only after everything is rebuilt

    def _rebuild_meta_columns(self) -> None:
        """Recreate the native metadata mirror after slots moved (compaction/regrow)."""
        if self.meta_columns is None:
            return
        try:
            from ..native import MetaColumns

            mc = MetaColumns(max(self.capacity, 1))
            for vid, slot in self._id_to_slot.items():
                if not mc.set(slot, self._slot_meta[slot]):
                    self.meta_columns = None
                    return
            self.meta_columns = mc
        except Exception:  # pragma: no cover
            self.meta_columns = None

    # ------------------------------------------------------------------ reads

    def contains(self, vid: uuid_mod.UUID) -> bool:
        return vid in self._id_to_slot

    def get(self, vid: uuid_mod.UUID) -> Optional[Vector]:
        slot = self._id_to_slot.get(vid)
        if slot is None:
            return None
        return self._vector_at(slot, vid)

    def _vector_at(self, slot: int, vid: uuid_mod.UUID) -> Vector:
        vals = self._slot_values[slot]
        if vals is None:  # host mirror disabled: fetch the device row
            row = np.asarray(jax.device_get(self._data[slot]), np.float32)[: self.dim]
            vals = row
        return Vector(vals, self._slot_meta[slot] or {}, id=vid)

    def slot_to_id(self, slot: int) -> Optional[uuid_mod.UUID]:
        if 0 <= slot < len(self._slot_ids):
            return self._slot_ids[slot]
        return None

    def slot_metadata(self, slot: int) -> Optional[Dict[str, Any]]:
        if 0 <= slot < len(self._slot_meta):
            return self._slot_meta[slot]
        return None

    def all_vectors(self) -> List[Vector]:
        with self._lock:
            return [self._vector_at(s, vid) for vid, s in self._id_to_slot.items()]

    def iter_slots(self) -> List[Tuple[int, uuid_mod.UUID, Optional[Dict[str, Any]]]]:
        """(slot, id, metadata) for every live row — filter compilation walks this."""
        return [(s, vid, self._slot_meta[s]) for vid, s in self._id_to_slot.items()]

    # ------------------------------------------------------------------ persistence

    def snapshot_arrays(self) -> Dict[str, Any]:
        """Host-side snapshot for checkpointing (device->host transfer of the padded
        matrix + id table + mask — SURVEY.md §5.4)."""
        with self._lock:
            if self._offloaded is not None:
                self.ensure_resident()
            live = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            slots = np.asarray([s for _, s in live], np.int32)
            if self._data is not None and len(slots):
                rows = np.asarray(jax.device_get(self._data[slots]), np.float32)[:, : self.dim]
            else:
                rows = np.zeros((0, self.dim or 0), np.float32)
            return {
                "name": self.name,
                "dim": self.dim,
                "ids": [str(vid) for vid, _ in live],
                "values": rows,
                "metadata": [self._slot_meta[s] for _, s in live],
            }

    def load_snapshot(self, snap: Dict[str, Any]) -> "NamespaceStore":
        """Ingest a snapshot payload into this (fresh) store — works for any subclass,
        so a sharded restore re-applies its mesh placement through the normal
        bulk_upsert path."""
        if len(snap["ids"]):
            self.bulk_upsert(
                np.asarray(snap["values"], np.float32),
                [uuid_mod.UUID(x) for x in snap["ids"]],
                snap["metadata"],
            )
        elif snap.get("dim"):
            self._ensure_dim(int(snap["dim"]))
        return self

    @classmethod
    def from_snapshot(
        cls, snap: Dict[str, Any], config: EngineConfig = DEFAULT_CONFIG, host_mirror: bool = True
    ) -> "NamespaceStore":
        return cls(snap["name"], config, host_mirror).load_snapshot(snap)
