"""Query engine: jit-compiled batched search + consistent write/delete paths.

Capability parity with the reference's QueryProcessor
(reference: src/mlvectordb/implementations/query_processor.py:11-82): insert / upsert_many /
find_similar / delete plus the REST helper surface (list_namespaces /
get_namespace_vectors / get_namespace_count / get_storage_info).  Reference behaviors kept
byte-compatible where sane (SURVEY.md §7):
  * k clamped to the live count (index.py:103-107)
  * search of a missing namespace returns [] (index.py:98-99)
  * result dicts {id, values, metadata, score}, silently dropping hits that vanished from
    storage between select and hydrate (query_processor.py:38-49)
  * score convention: l2/ip -> raw distance (lower better), cosine -> similarity = 1 - dist
    (index.py:121-128)
Reference bugs deliberately NOT inherited: the metric argument here genuinely selects the
distance function (the reference's hnswlib space is frozen at construction — SURVEY.md
§3.3); upsert with an explicit id truly overwrites (§3.2); compaction never clears other
namespaces (§3.4).

Additions (the README-documented intent, SURVEY.md §0.1): true batched search, range /
similarity-threshold search, metadata-filtered and hybrid queries, explain, statistics,
snapshot save/load.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid as uuid_mod
from typing import Any, Dict, Iterable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, HIGHER_IS_BETTER, EngineConfig, canonical_metric
from ..ops.backend import knn_backend, search_path
from ..ops.distances import MASKED
from ..interfaces.vector import VectorDTO
from ..store.storage import StorageEngine
from ..store.vector import Vector
from ..utils.tracing import trace_span
from ..filters import filter_cache_key
from .filters import FilterMaskCache

logger = logging.getLogger(__name__)


def _hydrate_native():
    """The native row-hydration extension, or None (pure-Python fallback)."""
    from ..native import hydrate_module

    return hydrate_module()


class QueryStats:
    """Query-type counters + latency accumulators (serves GET /statistics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}
        self.total_ms: Dict[str, float] = {}
        self._stage_counts: Dict[str, int] = {}
        self._stage_ms: Dict[str, float] = {}

    def record(self, kind: str, elapsed_ms: float) -> None:
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.total_ms[kind] = self.total_ms.get(kind, 0.0) + elapsed_ms

    def record_stage(self, stage: str, elapsed_ms: float) -> None:
        """Per-stage latency budget (device dispatch vs hydration vs batcher wait) —
        itemizes the serving path without inflating total_queries."""
        with self._lock:
            self._stage_counts[stage] = self._stage_counts.get(stage, 0) + 1
            self._stage_ms[stage] = self._stage_ms.get(stage, 0.0) + elapsed_ms

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "total_queries": sum(self.counts.values()),
                "queries_by_type": dict(self.counts),
                "avg_latency_ms_by_type": {
                    k: (self.total_ms[k] / c if c else 0.0) for k, c in self.counts.items()
                },
                "stage_budget_ms": {
                    k: round(self._stage_ms[k] / c, 4)
                    for k, c in self._stage_counts.items() if c
                },
            }


class QueryProcessor:
    """Composes the device store with the fused search kernels."""

    def __init__(
        self,
        storage: Optional[StorageEngine] = None,
        config: EngineConfig = DEFAULT_CONFIG,
    ):
        self.config = config
        self.storage = storage if storage is not None else StorageEngine(config)
        self._filter_masks = FilterMaskCache()
        self.stats = QueryStats()
        # per-namespace certificate-tier counters (see _record_cert_tier)
        self._cert_lock = threading.Lock()  # guards _cert_tiers/_cert_mode/_heavy_warms
        self._cert_tiers: Dict[str, Dict[str, int]] = {}
        # adaptive certified dispatch (config.adaptive_certify): namespaces start on
        # the LIGHT single-pass certified program; an escalation flips them to the
        # heavy residual-corrected one after a background warm (see _use_light)
        self._cert_mode: Dict[str, str] = {}
        self._heavy_warms: set = set()
        self._write_lock = threading.RLock()  # single-writer discipline (SURVEY.md §7)
        # query-result cache (the reference README advertises result caching it never
        # shipped — SURVEY.md §0.1).  Keyed by namespace VERSION, so any mutation
        # invalidates implicitly; stores the final hydrated result lists.  OrderedDict
        # for LRU eviction — clear-all eviction thrashed under diverse query mixes.
        from collections import OrderedDict

        self._result_cache: "OrderedDict[Any, List[List[Dict[str, Any]]]]" = OrderedDict()
        self._result_cache_hits = 0
        self._result_cache_lock = threading.Lock()
        # optional write-ahead log (enable_wal): mutations are logged-then-applied so
        # a crash loses nothing past the last flushed record (engine/wal.py)
        self._wal = None
        self._wal_replaying = False
        # host<->device transfer audit counters: the serving path does exactly ONE
        # host->device (the query batch) and ONE device->host ((dist, idx) fetched
        # together) per search — every extra readback is a host/device sync
        self.transfer_counts = {"h2d": 0, "d2h": 0}

    def _result_cache_key(self, q_np, top_k, namespace, metric, filter, nprobe):
        ns = self.storage.namespace(namespace)
        if ns is None or self.config.result_cache_size <= 0:
            return None
        import hashlib

        h = hashlib.blake2b(q_np.tobytes(), digest_size=16).hexdigest()
        fk = filter_cache_key(filter) if filter else ""
        # ns.incarnation: version counters restart at 0 when a namespace is GC'd and
        # recreated, so (name, version) alone can resurrect a dead incarnation's results
        return (namespace, ns.incarnation, ns.version, h, top_k, metric, fk, nprobe)

    # ------------------------------------------------------------------ durability

    def enable_wal(
        self, path: str, fsync: bool = False, checkpoint_bytes: Optional[int] = None
    ) -> None:
        """Log every mutation to ``path`` BEFORE applying it (crash durability for the
        window between snapshots).  Recover with QueryProcessor.load(snap, wal_path=...)
        or the server's --wal flag; save() rotates and prunes covered segments.

        ``checkpoint_bytes``: for WAL-ONLY deployments (no snapshot schedule prunes
        segments, so replay time and disk would grow without bound — ADVICE r2): when
        the segments exceed this size, the engine writes a snapshot to
        ``<path>/checkpoint`` (atomic swap) and prunes the covered segments inline on
        the mutating call.  ``load(wal_path=...)`` auto-detects the checkpoint."""
        from .wal import WriteAheadLog

        if self._wal is not None:
            raise RuntimeError("WAL already enabled for this processor")
        self._wal = WriteAheadLog(path, fsync=fsync)
        self._wal_checkpoint_bytes = checkpoint_bytes

    def _maybe_checkpoint_wal(self) -> None:
        """WAL-only growth bound: snapshot into <wal>/checkpoint + prune when the log
        exceeds checkpoint_bytes.  Runs under the write lock (mutations pause for the
        device->host snapshot — the price of bounded recovery, taken rarely)."""
        w = self._wal
        limit = getattr(self, "_wal_checkpoint_bytes", None)
        if w is None or self._wal_replaying or not limit or w.total_bytes() < limit:
            return
        import os
        import shutil

        ckpt = os.path.join(w.path, "checkpoint")
        tmp, old = ckpt + ".tmp", ckpt + ".old"
        with self._write_lock:
            shutil.rmtree(tmp, ignore_errors=True)
            sealed = self._save_snapshot(tmp)
            shutil.rmtree(old, ignore_errors=True)
            if os.path.isdir(ckpt):
                os.rename(ckpt, old)
            os.rename(tmp, ckpt)
            shutil.rmtree(old, ignore_errors=True)
            w.prune(sealed)
        self.stats.record("wal_checkpoint", 0.0)

    def _wal_upsert(self, vs: Sequence[Vector], namespace: str) -> None:
        if self._wal is None or self._wal_replaying or not vs:
            return
        self._wal.append(
            "upsert",
            namespace,
            ids=[v.id for v in vs],
            values=np.stack([v.values for v in vs]),
            metadatas=[v.metadata for v in vs],
        )
        self._maybe_checkpoint_wal()

    # ------------------------------------------------------------------ writes

    def _materialize(self, dto: VectorDTO) -> Vector:
        return Vector(dto.values, dto.metadata, id=dto.id)

    def insert(self, vector: VectorDTO, namespace: str = "default") -> Vector:
        with self._write_lock:
            v = self._materialize(vector)
            self._wal_upsert([v], namespace)
            self.storage.write(v, namespace)
            self._sync_ivf_add(namespace, [v])
            return v

    def upsert_many(
        self, vectors: Sequence[VectorDTO], namespace: str = "default"
    ) -> List[Vector]:
        """True upsert: DTOs carrying an id overwrite in place; id-less DTOs mint uuid4
        (fixing the reference's insert-only 'upsert', SURVEY.md §3.2)."""
        with self._write_lock, trace_span("upsert", namespace=namespace, count=len(vectors)):
            vs = [self._materialize(d) for d in vectors]
            self._wal_upsert(vs, namespace)
            self.storage.write_vectors(vs, namespace)
            self._sync_ivf_add(namespace, vs)
            return vs

    def delete(
        self, vector_ids: Iterable[uuid_mod.UUID], namespace: str = "default"
    ) -> List[uuid_mod.UUID]:
        with self._write_lock, trace_span("delete", namespace=namespace):
            ids = list(vector_ids)
            if self._wal is not None and not self._wal_replaying and ids:
                self._wal.append("delete", namespace, ids=ids)
                self._maybe_checkpoint_wal()
            removed = self.storage.delete_vectors(ids, namespace)
            ns = self.storage.namespace(namespace)
            ivf = getattr(ns, "ivf", None) if ns is not None else None
            if ivf is not None and removed:
                ivf.delete(removed)
            return removed

    def delete_namespace(self, namespace: str) -> bool:
        with self._write_lock:
            if self._wal is not None and not self._wal_replaying:
                self._wal.append("delete_namespace", namespace)
            return self.storage.delete_namespace(namespace)

    # ------------------------------------------------------------------ HBM offload

    def offload_namespace(self, namespace: str) -> bool:
        """Move a cold namespace's device arrays to host RAM, freeing HBM for hot
        ones.  Host-table reads keep working; the first search or write pages it back
        in transparently (scale beyond one chip's HBM, SURVEY.md §5.7)."""
        ns = self.storage.namespace(namespace)
        if ns is None:
            return False
        with self._write_lock:
            return ns.offload()

    def restore_namespace(self, namespace: str) -> bool:
        ns = self.storage.namespace(namespace)
        return ns.ensure_resident() if ns is not None else False

    def bulk_load(
        self,
        values,                              # [n, dim] array-like
        namespace: str = "default",
        ids=None,
        metadatas=None,
        batch_rows: int = 65536,
    ):
        """High-throughput vectorized ingestion (no per-vector Python objects).

        Returns the list of uuids.  Batches bound peak host memory and keep device
        scatter widths in the compiled-bucket range.  An attached IVF index is kept in
        sync (assignment-batched).
        """
        values = np.ascontiguousarray(values, np.float32)
        n = values.shape[0]
        out = []
        with self._write_lock, trace_span("bulk_load", namespace=namespace, count=n):
            ns = self.storage.namespace(namespace, create=True)
            for lo in range(0, n, batch_rows):
                hi = min(lo + batch_rows, n)
                got = ns.bulk_upsert(
                    values[lo:hi],
                    ids[lo:hi] if ids is not None else None,
                    metadatas[lo:hi] if metadatas is not None else None,
                )
                if self._wal is not None and not self._wal_replaying:
                    self._wal.append(
                        "upsert", namespace, ids=got, values=values[lo:hi],
                        metadatas=list(metadatas[lo:hi]) if metadatas is not None else None,
                    )
                    self._maybe_checkpoint_wal()
                out.extend(got)
            ivf = getattr(ns, "ivf", None)
            if ivf is not None:
                # assignment-batched straight from the contiguous array: building a
                # Vector per row here was exactly the Python-object churn bulk_upsert
                # exists to avoid
                ivf.add_bulk(values, out)
        return out

    def _sync_ivf_add(self, namespace: str, vectors: Sequence[Vector]) -> None:
        ns = self.storage.namespace(namespace)
        ivf = getattr(ns, "ivf", None) if ns is not None else None
        if ivf is not None and vectors:
            ivf.add(vectors)

    def build_ivf(
        self,
        namespace: str = "default",
        n_clusters: Optional[int] = None,
        cluster_capacity: Optional[int] = None,
        n_iters: int = 10,
        seed: int = 0,
        spill: int = 1,
    ) -> Dict[str, Any]:
        """Train and attach an IVF approximate index to a namespace (store/ivf.py).
        Subsequent searches passing ``nprobe`` use it; exact search stays the default.
        ``spill`` > 1 places each vector in its spill nearest clusters (higher recall
        at fixed nprobe for spill x index memory)."""
        from ..store.ivf import IVFIndex

        with self._write_lock, trace_span("ivf_build", namespace=namespace):
            ns = self.storage.namespace(namespace)
            if ns is None:
                raise ValueError(f"namespace {namespace!r} does not exist")
            # WAL covers the index lifecycle: a WAL-only recovery
            # replays the build (k-means is seeded, so the recovered index matches
            # pre-crash recall characteristics); logged before applying, like data ops
            if self._wal is not None and not self._wal_replaying:
                self._wal.append(
                    "build_ivf", namespace,
                    params={
                        "n_clusters": n_clusters, "cluster_capacity": cluster_capacity,
                        "n_iters": n_iters, "seed": seed, "spill": spill,
                    },
                )
            with ns._lock:
                ns.ivf = IVFIndex(ns, n_clusters, cluster_capacity, n_iters, seed, spill)
                # (re)building the index changes what nprobe searches return: bump the
                # version so result-cache entries from the OLD index can't be served
                # (found by the suite: a spill=2 rebuild returned the spill=1 curve
                # verbatim from cache)
                ns.version += 1
            return ns.ivf.stats()

    def drop_ivf(self, namespace: str = "default") -> bool:
        ns = self.storage.namespace(namespace)
        if ns is not None and getattr(ns, "ivf", None) is not None:
            if self._wal is not None and not self._wal_replaying:
                self._wal.append("drop_ivf", namespace)
            with ns._lock:
                ns.ivf = None
                ns.version += 1  # nprobe searches now fall back to exact: invalidate
            return True
        return False

    # ------------------------------------------------------------------ search core

    def _raw_search(
        self,
        q_np: np.ndarray,       # [B, dim] float32 logical queries
        namespace: str,
        k: int,
        metric: str,
        filter: Optional[Dict[str, Any]],
        nprobe: Optional[int] = None,
    ):
        """Returns (dist [B, k'] np, slots [B, k'] np, ns_store, resolver) with
        k' = min(k, live); resolver maps result slots to uuids (store slots by default,
        IVF slots when the approximate path ran); tables is the snapshot's host slot
        tables (one generation, for torn-free fast hydration) or None.
        Empty namespace / k<=0 -> (None, None, None, None, None)."""
        ns = self.storage.namespace(namespace)
        if ns is None or ns.live_count == 0 or k <= 0:
            return None, None, None, None, None
        if q_np.shape[1] != ns.dim:
            raise ValueError(
                f"query dim {q_np.shape[1]} != namespace {namespace!r} dim {ns.dim}"
            )

        # approximate path: IVF probe-search (no filters — those fall through to exact)
        ivf = getattr(ns, "ivf", None)
        if nprobe is not None and ivf is not None and filter is None:
            k_eff = min(k, ns.live_count)
            # spilled indexes hold up to `spill` copies per id: over-fetch so k unique
            # ids survive the hydration dedupe
            k_fetch = min(k_eff * ivf.spill, ivf.C * ivf.L)
            B = q_np.shape[0]
            Bb = self.config.bucket_batch(B)
            q_pad = np.zeros((Bb, ns.dpad), np.float32)
            q_pad[:B, : ns.dim] = q_np
            with trace_span("knn_ivf", namespace=namespace, k=k_fetch, nprobe=nprobe):
                # resolver is bound to the generation that produced the slots: a
                # concurrent retrain cannot resolve old-layout slots in the new table
                self.transfer_counts["h2d"] += 1
                dist, idx, resolve = ivf.search_resolved(
                    jnp.asarray(q_pad), k_fetch, metric, nprobe
                )
            self.transfer_counts["d2h"] += 1
            dist, idx = jax.device_get((dist, idx))  # one readback, not two
            return dist[:B, :k_fetch], idx[:B, :k_fetch], ns, resolve, None

        # Snapshot-read with RCU-style retry.  Write buffers are NOT donated (the store
        # is copy-on-write — see store/namespace.py on why donation is unsafe with
        # concurrent readers), so a published DeviceState can never be invalidated under a
        # reader.  What CAN still race is the filter path: the mask is compiled against
        # the live store's capacity, and a concurrent capacity growth between snapshot
        # and mask build yields a mask/array shape mismatch — _search_snapshot raises
        # "snapshot deleted (capacity changed)" and we simply re-snapshot.  The final
        # attempt serializes against the writer via the namespace lock for progress.
        attempts = 6
        for attempt in range(attempts):
            try:
                if attempt == attempts - 1:
                    with ns._lock:
                        return self._search_snapshot(q_np, ns, namespace, k, metric, filter)
                return self._search_snapshot(q_np, ns, namespace, k, metric, filter)  # noqa: TRY300
            except RuntimeError as e:
                if "deleted" not in str(e):
                    raise
        raise RuntimeError("unreachable")  # pragma: no cover

    def _search_snapshot(self, q_np, ns, namespace, k, metric, filter):
        v0 = ns.version            # read BEFORE the snapshot: brackets the mask build
        state = ns.device_state()  # snapshot: functional arrays isolate readers

        valid = state.valid
        prep_cache = state.prep_cache
        if filter:
            with trace_span("filter_mask", namespace=namespace):
                mask = self._filter_masks.mask_for(ns, filter)
            if mask.shape[0] != state.valid.shape[0]:  # capacity changed mid-snapshot
                raise RuntimeError("snapshot deleted (capacity changed)")
            if ns.version != v0:
                # a write published between our version read and the mask build:
                # the mask (live tables, keyed by live version) may not match the
                # snapshot arrays.  Re-snapshot via the RCU retry.  NB: compared
                # against v0, not state.version — version can move WITHOUT a
                # republish (an IVF build bumps it to drop result caches while
                # the arrays are unchanged), so the snapshot's own stamp may
                # legitimately lag the live counter forever.
                raise RuntimeError("snapshot deleted (version moved during mask build)")
            valid = jnp.logical_and(valid, jnp.asarray(mask))
            # masked prep depends on the filtered liveness — scope it INSIDE the
            # snapshot's own prep dict, keyed by the filter: prep then lives and
            # dies with the snapshot's arrays, so no version arithmetic can file
            # stale prep under a future version (writers bump ns.version BEFORE
            # publishing, so any version-keyed side cache has a poisoning window
            # between the bump and the publish).  Bounded:
            # each entry holds ~cap*8 B of prep rows, so a many-distinct-filter
            # workload gets a per-call throwaway dict past 32 entries instead of
            # pinning HBM for the snapshot's lifetime.
            fk = ("filter", filter_cache_key(filter))
            if fk in state.prep_cache or len(state.prep_cache) < 32:
                prep_cache = state.prep_cache.setdefault(fk, {})
            else:
                prep_cache = {}

        # counters come from the SNAPSHOT, never the live store attributes: a concurrent
        # upsert bumps host tables before publishing the scattered arrays, and pairing
        # old data with the new high-water would admit never-written all-zero rows
        k_eff = min(k, state.live_count)
        if k_eff <= 0:
            B = q_np.shape[0]
            empty = np.zeros((B, 0))
            return empty, empty.astype(np.int32), ns, None, state.host_tables
        kb = min(self.config.bucket_k(k_eff), state.valid.shape[0])
        B = q_np.shape[0]
        Bb = self.config.bucket_batch(B)
        q_pad = np.zeros((Bb, ns.dpad), np.float32)
        q_pad[:B, : ns.dim] = q_np

        self.transfer_counts["h2d"] += 1
        tier_dev = None
        if hasattr(ns, "sharded_search"):  # distributed namespace: cross-shard reduction
            with trace_span("knn_sharded", namespace=namespace, k=kb, batch=Bb):
                dist, idx = ns.sharded_search(
                    jnp.asarray(q_pad), kb, metric,
                    valid_override=None if filter is None else valid,
                )
        else:
            # rows [0, high_water) are exactly the live rows iff no slot below the
            # high-water mark is dead => the certified path can skip all mask traffic
            live_prefix = None
            if filter is None and state.live_count == state.high_water:
                live_prefix = state.high_water

            backend = knn_backend(self.config)
            # request the certificate-tier scalar on certified configs: it rides in
            # the SAME device fetch (no extra round trip) and feeds the per-namespace
            # escalation counters in /statistics
            want_tier = bool(self.config.certify_exact) and state.data_t is not None
            use_light = self._use_light(namespace, state, metric,
                                        masked=live_prefix is None)
            with trace_span("knn_kernel", namespace=namespace, k=kb, batch=Bb):
                out = backend(
                    jnp.asarray(q_pad), state.data, valid, state.sq_norms,
                    k=kb, metric=metric, db_tile=self.config.db_tile,
                    live_prefix=live_prefix, data_t=state.data_t,
                    sweep_err=state.sweep_err, sweep_resid=state.sweep_resid,
                    sweep_rscale=state.sweep_rscale, sweep_err1=state.sweep_err1,
                    sweep_rscale2=state.sweep_rscale2, report_tier=want_tier,
                    sweep_light=use_light, sweep_prep=prep_cache,
                )
                dist, idx = out[:2]
                tier_dev = out[2] if want_tier else None
        # ONE device->host transfer for both arrays: fetching dist and idx
        # separately would add a second host/device sync per batch
        self.transfer_counts["d2h"] += 1
        if tier_dev is not None:
            dist, idx, tier = jax.device_get((dist, idx, tier_dev))
            self._record_cert_tier(namespace, int(tier), light=use_light)
            if use_light and int(tier) == 2:
                # the light band is too wide for this corpus: warm the heavy
                # residual-corrected program in the background, then switch the
                # namespace to it permanently (results stayed exact throughout —
                # escalation costs speed, never correctness)
                self._warm_heavy_then_switch(
                    namespace, state, Bb, kb, metric, live_prefix,
                    None if filter is None else valid,
                    prep_cache=prep_cache,
                )
        else:
            dist, idx = jax.device_get((dist, idx))
        # None resolver = store slots; host_tables = the SNAPSHOT's generation of the
        # id/meta/value lists, so hydration can never mix generations with a racing
        # compaction (ADVICE r2)
        return dist[:B, :k_eff], idx[:B, :k_eff], ns, None, state.host_tables

    # certificate-tier names, indexed by the kernel's scalar (ops/pallas_knn_t)
    _TIER_NAMES = {0: "fast", 1: "widened", 2: "exact_scan", -1: "disengaged"}

    def _record_cert_tier(self, namespace: str, tier: int, light: bool = False) -> None:
        """Count which certificate tier served each batch (per namespace): operators
        see escalation rates in /statistics, and a namespace that keeps escalating is
        the signal that its corpus needs the residual-corrected sweep config."""
        name = self._TIER_NAMES.get(tier, str(tier))
        if light:
            name = f"light_{name}"
        with self._cert_lock:
            d = self._cert_tiers.setdefault(namespace, {})
            d[name] = d.get(name, 0) + 1

    def cert_tier_counts(self, namespace: str) -> Dict[str, int]:
        with self._cert_lock:
            return dict(self._cert_tiers.get(namespace, {}))

    def _explain_dispatch(self, ns, namespace, metric, *, masked, fused_active):
        """The dispatch label for explain_query — side-effect free (no snapshot)."""
        eligible = (
            ns is not None
            and self.config.adaptive_certify
            and getattr(ns, "_sweep_resid", None) is not None
            and getattr(ns, "_data_t", None) is not None
            and ns._data_t.dtype == jnp.bfloat16
        )
        if eligible:
            return self._cert_mode.get((namespace, metric, masked), "light")
        return "heavy" if fused_active else "exact-scan"

    def _use_light(self, namespace: str, state, metric: str = "l2",
                   masked: bool = False) -> bool:
        """Adaptive certified dispatch (config.adaptive_certify): serve the namespace
        with the LIGHT single-pass certified program — one matmul pass, no residual
        stream; the proof carries the uncompensated query-rounding term per window —
        until an escalation shows its corpus needs the heavy residual-corrected
        program.  Only mixed bf16-sweep stores have both variants (the int8 primary
        band is too wide for the light proof by construction)."""
        if not (self.config.certify_exact and self.config.adaptive_certify):
            return False
        if (
            state.sweep_resid is None
            or state.data_t is None
            or state.data_t.dtype != jnp.bfloat16
        ):
            return False
        # mode is per (namespace, metric, masked-variant): the heavy warm compiles
        # that variant's bucket grid, so flipping only it keeps every OTHER
        # variant on the (always-compiled) light program instead of landing its
        # first post-flip query on a cold certified compile
        return self._cert_mode.get((namespace, metric, masked), "light") == "light"

    def _warm_heavy_then_switch(
        self, namespace, state, Bb, kb, metric, live_prefix, valid_override,
        prep_cache=None,
    ) -> None:
        """Compile the heavy residual-corrected programs in a daemon thread, then
        flip the namespace's dispatch to them.  Queries keep using the light program
        (exact via escalation) until the heavy ones are ready, so nobody stalls on
        the compiles.

        Warms EVERY (batch-bucket, k-bucket) pair for the triggering metric/variant
        — not just the shape that escalated — because the mode flip applies to the
        whole namespace: flipping after one compile would land every other bucket's
        first heavy query on a cold multi-minute certified compile.

        ``prep_cache`` must be the SAME dict the triggering search used (the
        snapshot dict, or the per-(filter, version) dict for filtered traffic):
        warming a filtered shape against the snapshot dict would file prep built
        from the filter-ANDed liveness under the snapshot's own keys, and later
        tombstone-masked unfiltered searches would rank — and certify — against
        rows the old filter excluded."""
        mode_key = (namespace, metric, live_prefix is None)
        with self._cert_lock:
            if (mode_key in self._heavy_warms
                    or self._cert_mode.get(mode_key) == "heavy"):
                return
            self._heavy_warms.add(mode_key)

        backend = knn_backend(self.config)
        valid = state.valid if valid_override is None else valid_override
        if prep_cache is None:
            prep_cache = state.prep_cache
        batches = sorted({self.config.bucket_batch(b)
                          for b in self.config.query_buckets if b <= 512} | {Bb})
        ks = sorted({min(self.config.bucket_k(min(kk, state.live_count)),
                         state.valid.shape[0])
                     for kk in (10, 100)} | {kb})

        def warm_one(bb, kk):
            d, _ = backend(
                jnp.zeros((bb, state.data.shape[1]), jnp.float32),
                state.data, valid, state.sq_norms,
                k=kk, metric=metric, db_tile=self.config.db_tile,
                live_prefix=live_prefix, data_t=state.data_t,
                sweep_err=state.sweep_err, sweep_resid=state.sweep_resid,
                sweep_rscale=state.sweep_rscale, sweep_err1=state.sweep_err1,
                sweep_rscale2=state.sweep_rscale2, report_tier=True,
                sweep_light=False, sweep_prep=prep_cache,
            )[:2]
            np.asarray(jax.device_get(d[:1, :1]))  # force real completion

        def run():
            try:
                from concurrent.futures import ThreadPoolExecutor

                pairs = [(bb, kk) for bb in batches for kk in ks]
                with ThreadPoolExecutor(max_workers=min(8, len(pairs))) as pool:
                    list(pool.map(lambda p: warm_one(*p), pairs))
                with self._cert_lock:
                    self._cert_mode[mode_key] = "heavy"
            except Exception:  # pragma: no cover - compile failure: stay light
                logger.exception("heavy certified program warm failed for %r", namespace)
            finally:
                with self._cert_lock:
                    self._heavy_warms.discard(mode_key)

        threading.Thread(target=run, name=f"mlvdb-heavy-warm-{namespace}", daemon=True).start()

    def _to_user_score(self, dist: np.ndarray, metric: str) -> np.ndarray:
        # reference convention (index.py:121-128): cosine -> 1 - dist; else raw distance
        return 1.0 - dist if HIGHER_IS_BETTER[metric] else dist

    # ------------------------------------------------------------------ public queries

    def find_similar(
        self,
        query: VectorDTO,
        top_k: int = 10,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
        nprobe: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        return self.find_similar_batch([query], top_k, namespace, metric, filter, nprobe)[0]

    def find_similar_batch(
        self,
        queries: Sequence[VectorDTO],
        top_k: int = 10,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
        nprobe: Optional[int] = None,
    ) -> List[List[Dict[str, Any]]]:
        """Batched kNN — query batches are free matmul parallelism; this is the QPS path.

        ``nprobe``: opt into the approximate IVF path (build_ivf first) probing that many
        clusters; None (default) = exact search, recall 1.0."""
        t0 = time.perf_counter()
        m = canonical_metric(metric or self.config.default_metric)
        q_np = np.stack([np.asarray(q.values, np.float32).reshape(-1) for q in queries])

        cache_key = self._result_cache_key(q_np, top_k, namespace, m, filter, nprobe)
        if cache_key is not None:
            with self._result_cache_lock:
                hit = self._result_cache.get(cache_key)
                if hit is not None:
                    self._result_cache.move_to_end(cache_key)  # LRU touch
            if hit is not None:
                self._result_cache_hits += 1
                self.stats.record("cache_hit", (time.perf_counter() - t0) * 1e3)
                # shallow-copy the result dicts so a caller mutating a hit can't
                # poison later cache reads
                return [[dict(r) for r in rs] for rs in hit]

        t_dev = time.perf_counter()
        dist, slots, ns, resolver, tables = self._raw_search(
            q_np, namespace, top_k, m, filter, nprobe
        )
        self.stats.record_stage("device", (time.perf_counter() - t_dev) * 1e3)
        if ns is None:
            results: List[List[Dict[str, Any]]] = [[] for _ in queries]
        else:
            user = self._to_user_score(dist, m)
            t_hyd = time.perf_counter()
            with trace_span("hydrate", namespace=namespace, batch=len(queries)):
                results = self._hydrate_batch(
                    user, dist, slots, ns, resolver, limit=top_k, tables=tables
                )
            self.stats.record_stage("hydrate", (time.perf_counter() - t_hyd) * 1e3)
        kind = "hybrid" if filter else ("ivf" if nprobe is not None else "knn")
        self.stats.record(kind, (time.perf_counter() - t0) * 1e3)
        if cache_key is not None:
            # store a private copy: the caller owns the returned dicts and may mutate
            # them, which must not poison later hits (same rule as the hit path above)
            with self._result_cache_lock:
                while len(self._result_cache) >= self.config.result_cache_size:
                    self._result_cache.popitem(last=False)  # evict least-recently-used
                self._result_cache[cache_key] = [[dict(r) for r in rs] for rs in results]
        return results

    def _hydrate_batch(
        self, user, dist, slots, ns, resolver=None,
        limit: Optional[int] = None, tables=None,
    ) -> List[List[Dict[str, Any]]]:
        """Hydrate a whole [B, k] result block into per-query result lists.

        Fast path: results carry STORE slots (the exact-search path) and the host
        mirror is on — one vectorized numpy mask prefilters the block, then a single
        flat pass reads the slot tables directly instead of a per-row/per-hit Python
        loop.  ``tables`` is the
        search snapshot's generation of the three lists (DeviceState.host_tables): one
        atomic capture, so a compaction racing this loop cannot pair one generation's
        ids with another's values.  Metadata dicts are copied (Vector did too); values
        intentionally alias the host mirror, same as the Vector path.
        """
        B = user.shape[0]
        if resolver is not None or tables is None:
            return [
                self._hydrate_scored(user[i], dist[i], slots[i], ns, resolver, limit=limit)
                for i in range(B)
            ]
        ids, metas, vals = tables
        n_slots = len(ids)
        native = _hydrate_native()
        if native is not None and hasattr(native, "build_nested"):
            # ONE C pass: mask, row construction, delete-after-snapshot drops and
            # per-query chunking together — removes the numpy boolean indexing +
            # counts.tolist() + B-iteration chunk loop
            kb = slots.shape[1]
            return native.build_nested(
                ids, vals, metas,
                np.ascontiguousarray(slots).reshape(-1),
                np.ascontiguousarray(user).reshape(-1),
                np.ascontiguousarray(dist).reshape(-1),
                float(MASKED) / 2, B, kb,
            )
        keep = (dist < float(MASKED) / 2) & (slots >= 0) & (slots < n_slots)
        counts = keep.sum(axis=1).tolist()
        if native is not None:
            # C-API row construction (native/hydrate.c) straight from the numpy
            # buffers (no .tolist()): ~3x the pure-Python dict build; `dropping`
            # flags rows nulled by a delete-after-snapshot
            rows, dropping = native.build_rows(
                ids, vals, metas, np.ascontiguousarray(slots[keep]),
                np.ascontiguousarray(user[keep]),
            )
        else:
            fs = slots[keep].tolist()
            fu = user[keep].tolist()
            rows = [
                {
                    "id": ids[slot],
                    "values": vals[slot],
                    "metadata": dict(m) if (m := metas[slot]) else {},
                    "score": sc,
                }
                for slot, sc in zip(fs, fu)
            ]
            # a hit can reference a slot deleted AFTER the snapshot published (the
            # shared host lists are nulled in place): drop those, mirroring the
            # reference's silently-dropping hydration (query_processor.py:38-49).
            dropping = any(r["id"] is None or r["values"] is None for r in rows)
        out, pos = [], 0
        for c in counts:
            chunk = rows[pos : pos + c]
            pos += c
            if dropping:
                chunk = [r for r in chunk if r["id"] is not None and r["values"] is not None]
            out.append(chunk)
        return out

    def _hydrate_scored(
        self, user_row, dist_row, slot_row, ns, resolver=None,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        half_masked = float(MASKED) / 2
        out = []
        # Generic path (IVF etc.): dedupe by id — a spilled IVF index can surface
        # multiple copies of one vector; keep the first (best-ranked) occurrence.
        resolver = resolver or ns.slot_to_id
        seen = set()
        for u, d, slot in zip(user_row.tolist(), dist_row.tolist(), slot_row.tolist()):
            if d >= half_masked:
                continue
            vid = resolver(int(slot))
            if vid is None or vid in seen:
                continue
            vec = ns.get(vid)
            if vec is None:
                continue
            seen.add(vid)
            out.append({"id": vid, "values": vec.values, "metadata": vec.metadata, "score": float(u)})
            if limit is not None and len(out) >= limit:
                break
        return out

    def range_search(
        self,
        query: VectorDTO,
        radius: float,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
        limit: int = 1000,
    ) -> List[Dict[str, Any]]:
        """All vectors within ``radius`` of the query (README-advertised /query/range).

        Threshold is in user-score units: l2/ip -> distance <= radius; cosine ->
        similarity >= radius.  At most ``limit`` best-first results are returned.
        """
        t0 = time.perf_counter()
        m = canonical_metric(metric or self.config.default_metric)
        q_np = np.asarray(query.values, np.float32).reshape(1, -1)
        dist, slots, ns, resolver, tables = self._raw_search(q_np, namespace, limit, m, filter)
        if ns is None:
            self.stats.record("range", (time.perf_counter() - t0) * 1e3)
            return []
        user = self._to_user_score(dist, m)
        hits = self._hydrate_batch(
            user, dist, slots, ns, resolver, limit=limit, tables=tables
        )[0]
        if HIGHER_IS_BETTER[m]:
            hits = [h for h in hits if h["score"] >= radius]
        else:
            hits = [h for h in hits if h["score"] <= radius]
        self.stats.record("range", (time.perf_counter() - t0) * 1e3)
        return hits

    def similarity_search(
        self,
        query: VectorDTO,
        threshold: float,
        namespace: str = "default",
        filter: Optional[Dict[str, Any]] = None,
        limit: int = 1000,
    ) -> List[Dict[str, Any]]:
        """Cosine-similarity threshold search (README-advertised /query/similarity)."""
        return self.range_search(query, threshold, namespace, "cosine", filter, limit)

    def query_by_metadata(
        self, filter: Dict[str, Any], namespace: str = "default", limit: int = 1000
    ) -> List[Dict[str, Any]]:
        """Pure metadata query (README-advertised /query/metadata)."""
        t0 = time.perf_counter()
        vecs = self.storage.query_by_metadata(filter, namespace)[:limit]
        out = [
            {"id": v.id, "values": v.values, "metadata": v.metadata, "score": 0.0}
            for v in vecs
        ]
        self.stats.record("metadata", (time.perf_counter() - t0) * 1e3)
        return out

    def explain_query(
        self,
        query: VectorDTO,
        top_k: int = 10,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Describe the execution plan without running it (README /query/explain)."""
        m = canonical_metric(metric or self.config.default_metric)
        ns = self.storage.namespace(namespace)
        live = ns.live_count if ns else 0
        cap = ns.capacity if ns else 0
        kb = min(self.config.bucket_k(min(top_k, max(live, 1))), max(cap, 1))
        # Truthful exactness reporting: margin mode (certify_exact=False) weakens
        # the contract ONLY where the certified sweep actually engages —
        # small/mirror-less namespaces take the scan and stay exact by construction.
        # The path comes from the same rule the backend dispatches by.
        data_t = getattr(ns, "_data_t", None)
        path = search_path(cap, getattr(ns, "dpad", 0),
                           None if data_t is None else data_t.dtype,
                           self.config.bucket_batch(1))
        fused_active = path != "scan"
        margin_mode = fused_active and not self.config.certify_exact
        if self.config.certify_exact:
            contract = (
                "certified: per-query on-device proof that no pruned window can "
                "hold a true neighbour; escalates to wider selection / exact scan"
            )
        elif margin_mode:
            contract = (
                "margin: fast selection tier returned unconditionally; exactness "
                "rests on the empirical selection margin + benchmark recall gates "
                "(certify_exact=False)"
            )
        else:
            contract = "exact by construction (full scan / fused kernel disengaged)"
        return {
            "query_type": "hybrid" if filter else "knn",
            "namespace": namespace,
            "metric": m,
            "higher_is_better": HIGHER_IS_BETTER[m],
            "exact": not margin_mode,
            "certified": bool(self.config.certify_exact),
            "exactness_contract": contract,
            # which certificate tier served past batches on this namespace (empty
            # until certified searches have run; see /statistics for all namespaces)
            "certificate_tiers": self.cert_tier_counts(namespace),
            # adaptive dispatch state: "light" single-pass proof vs "heavy"
            # residual-corrected proof (config.adaptive_certify).  Eligibility
            # mirrors _use_light: namespaces that can never serve the light
            # program (int8/same-dtype sweeps, no residual stream, sharded)
            # report "heavy", not the mode dict's optimistic default.
            # light-eligible namespaces (per their own arrays) surface the adaptive
            # mode of the REQUESTED (metric, filtered) variant; ineligible ones
            # (int8/same-dtype sweeps, no residual stream) report the program they
            # actually dispatch — "heavy" when the fused kernel engages, the exact
            # scan otherwise.  Eligibility reads store attributes, NOT
            # device_state(): a describe-only endpoint must not raise on empty
            # namespaces or page offloaded ones back into HBM.
            "certificate_dispatch": self._explain_dispatch(
                ns, namespace, m, masked=bool(filter), fused_active=fused_active,
            )
            if self.config.certify_exact
            else "margin" if margin_mode else "exact-scan",
            "expected_recall": None if margin_mode else 1.0,
            "live_vectors": live,
            "scanned_slots": cap,
            "k_requested": top_k,
            "k_effective": min(top_k, live),
            "k_kernel_bucket": kb,
            "db_tile": min(self.config.db_tile, cap) if cap else 0,
            "backend": path,
            "filter": filter,
        }

    def get_statistics(self) -> Dict[str, Any]:
        out = self.stats.as_dict()
        # a margin-mode server must SAY so: operators reading
        # /statistics should see which exactness contract their traffic ran under
        out["exactness"] = {
            "certify_exact": bool(self.config.certify_exact),
            "contract": "certified" if self.config.certify_exact else "margin",
        }
        with self._cert_lock:
            if self._cert_tiers:
                # which certificate tier served each batch, per namespace — a
                # namespace dominated by "exact_scan" is escalating every batch
                # (its corpus gaps sit under the sweep error band)
                out["exactness"]["tiers_by_namespace"] = {
                    ns: dict(d) for ns, d in self._cert_tiers.items()
                }
        return out

    def warmup(
        self,
        namespace: str = "default",
        ks: Sequence[int] = (10, 100),
        batches: Optional[Sequence[int]] = None,
        metrics: Sequence[str] = ("l2", "cosine"),
        detail: bool = False,
        include_masked: Optional[bool] = None,
    ):
        """Pre-compile the search programs a serving deployment will hit.

        Each (capacity, batch-bucket, k-bucket, metric, variant) tuple is a separate XLA
        compilation (the certified program is larger than the scan); warming them
        before traffic arrives turns first-query latency spikes into deploy-time
        work.  Returns programs executed (with ``detail=True``, a
        ``(count, {program: seconds})`` pair so /warmup can report the per-program
        compile bill).

        Programs are dispatched CONCURRENTLY (thread pool): XLA compilation happens
        server-side per program, so overlapping the requests bounds deploy-time
        warmup near the slowest single compile instead of the serial sum.

        ``batches`` defaults to EVERY config batch bucket up to 512 — the micro-batcher
        coalesces concurrent singles into any of them, and one unwarmed bucket
        serializes all traffic behind a compile.

        ``include_masked``: warm the masked-kernel variant (tombstones / metadata
        filters present).  Default None = auto: masked programs are warmed only when
        the namespace already carries tombstones — a tombstone-free deployment's
        search traffic dispatches the fast live-prefix variant exclusively, so
        skipping masked halves the compile bill.  Deployments that
        serve metadata-FILTERED queries should pass True: filters always take the
        masked variant, and its first compile otherwise lands on query traffic.
        """
        ns = self.storage.namespace(namespace)
        if ns is None or ns.live_count == 0:
            return (0, {}) if detail else 0
        if batches is None:
            batches = [b for b in self.config.query_buckets if b <= 512] or [8]
        state = ns.device_state()
        if include_masked is None:
            include_masked = state.live_count != state.high_water
        variants = (None, state.high_water) if include_masked else (state.high_water,)
        # Warm BOTH kernel variants — fast (live-prefix, no tombstones) and masked
        # (tombstones/filters present) — by dispatching the backend directly against the
        # namespace's published snapshot.  Compilation keys on shapes/static args only,
        # so this compiles exactly the programs _search_snapshot will dispatch WITHOUT
        # inserting sentinels into or compacting the user's namespace (warmup must never
        # mutate data, bump versions, or change compiled capacity buckets).
        jobs: Dict[str, Any] = {}
        sharded = hasattr(ns, "sharded_search")
        backend = None if sharded else knn_backend(self.config)
        for m in metrics:
            mc = canonical_metric(m)
            for b in batches:
                Bb = self.config.bucket_batch(b)
                for k in ks:
                    kb = min(self.config.bucket_k(min(k, state.live_count)), state.valid.shape[0])
                    if sharded:
                        key = f"b{Bb}_k{kb}_{mc}_sharded"
                        if key in jobs:
                            continue

                        def job(Bb=Bb, kb=kb, mc=mc):
                            ds, _ = ns.sharded_search(
                                jnp.zeros((Bb, ns.dpad), jnp.float32), kb, mc
                            )
                            np.asarray(jax.device_get(ds[:1, :1]))  # force completion

                        jobs[key] = job
                        continue
                    for live_prefix in variants:
                        key = f"b{Bb}_k{kb}_{mc}_{'masked' if live_prefix is None else 'fast'}"
                        if key in jobs:
                            continue

                        # sweep_err/resid operands MUST match the serving call
                        # exactly: leaving one out warms a different jit
                        # specialization and the first real search pays the
                        # certified-program compile
                        def job(Bb=Bb, kb=kb, mc=mc, live_prefix=live_prefix):
                            d, _ = backend(
                                jnp.zeros((Bb, ns.dpad), jnp.float32),
                                state.data, state.valid, state.sq_norms,
                                k=kb, metric=mc,
                                db_tile=self.config.db_tile, live_prefix=live_prefix,
                                data_t=state.data_t, sweep_err=state.sweep_err,
                                sweep_resid=state.sweep_resid,
                                sweep_rscale=state.sweep_rscale,
                                sweep_err1=state.sweep_err1,
                                sweep_rscale2=state.sweep_rscale2,
                                # warm the variant serving will DISPATCH (adaptive
                                # light vs heavy + the tier scalar) — a different
                                # specialization would leave first queries cold
                                report_tier=bool(self.config.certify_exact)
                                and state.data_t is not None,
                                sweep_light=self._use_light(
                                    namespace, state, mc,
                                    masked=live_prefix is None),
                                sweep_prep=state.prep_cache,
                            )[:2]
                            # a real readback: warmup reports success only once
                            # the program has compiled and run
                            np.asarray(jax.device_get(d[:1, :1]))

                        jobs[key] = job

        from concurrent.futures import ThreadPoolExecutor

        report: Dict[str, float] = {}

        def timed(item):
            key, job = item
            t0 = time.perf_counter()
            job()
            return key, time.perf_counter() - t0

        with ThreadPoolExecutor(max_workers=min(8, max(1, len(jobs)))) as pool:
            for key, secs in pool.map(timed, jobs.items()):
                report[key] = round(secs, 3)
        return (len(jobs), report) if detail else len(jobs)

    # ------------------------------------------------------------------ REST helpers
    # (parity with reference query_processor.py:64-82)

    def list_namespaces(self) -> List[str]:
        return self.storage.list_namespaces()

    def get_namespace_vectors(self, namespace: str = "default") -> List[Vector]:
        ns = self.storage.namespace(namespace)
        return ns.all_vectors() if ns else []

    def get_namespace_count(self, namespace: str = "default") -> int:
        ns = self.storage.namespace(namespace)
        return ns.live_count if ns else 0

    def get_storage_info(self) -> Dict[str, Any]:
        return self.storage.get_storage_info()

    # ------------------------------------------------------------------ persistence

    def _save_snapshot(self, path: str) -> List[str]:
        """Rotate the WAL (if enabled) under the write lock so every record the
        snapshot will cover is in a sealed segment, then write the snapshot.  Returns
        the sealed segments — the CALLER prunes them only once the snapshot sits in
        its final, recovery-visible location (the auto-snapshot loop writes to a temp
        dir first; pruning before its atomic rename would lose the delta on a crash
        in between).  Writes landing in the fresh segment during the snapshot replay
        idempotently."""
        from .persist import save_storage

        sealed: List[str] = []
        if self._wal is not None:
            with self._write_lock:
                sealed = self._wal.rotate()
        save_storage(self.storage, path)
        return sealed

    def save(self, path: str) -> None:
        sealed = self._save_snapshot(path)
        if self._wal is not None:
            self._wal.prune(sealed)

    @classmethod
    def load(
        cls,
        path: str,
        config: EngineConfig = DEFAULT_CONFIG,
        wal_path: Optional[str] = None,
        wal_fsync: bool = False,
        wal_checkpoint_bytes: Optional[int] = None,
    ) -> "QueryProcessor":
        """Restore from a snapshot directory; with ``wal_path``, additionally replay
        the write-ahead log on top (recovering everything after the snapshot) and
        keep logging to it.  WAL-only recovery (no snapshot directory at ``path``)
        auto-detects a ``<wal_path>/checkpoint`` written by size-triggered WAL-only
        checkpointing and loads it before replaying the remaining segments."""
        import os

        from .persist import load_storage, resolve_snapshot_dir

        snap = resolve_snapshot_dir(path) or (path if os.path.isdir(path) else None)
        if snap is not None:
            qp = cls(load_storage(snap, config), config)
        else:  # WAL-only recovery (crashed before the first explicit snapshot)
            ckpt = resolve_snapshot_dir(
                os.path.join(wal_path, "checkpoint") if wal_path else None
            )
            if ckpt is not None:
                qp = cls(load_storage(ckpt, config), config)
            else:
                qp = cls(config=config)
        if wal_path is not None:
            qp.replay_wal(wal_path)
            qp.enable_wal(wal_path, fsync=wal_fsync, checkpoint_bytes=wal_checkpoint_bytes)
        return qp

    def replay_wal(self, wal_path: str) -> int:
        """Re-apply logged mutations (idempotent); returns records applied."""
        from .wal import WriteAheadLog

        applied = 0
        self._wal_replaying = True
        try:
            for rec in WriteAheadLog.replay(wal_path):
                op, ns = rec["op"], rec["ns"]
                if op == "upsert":
                    self.bulk_load(
                        rec["values"], ns,
                        ids=[uuid_mod.UUID(x) for x in rec["ids"]],
                        metadatas=rec.get("meta"),
                    )
                elif op == "delete":
                    self.delete([uuid_mod.UUID(x) for x in rec["ids"]], ns)
                elif op == "delete_namespace":
                    self.storage.delete_namespace(ns)
                elif op == "build_ivf":
                    # re-derive the index from the recovered rows (seeded k-means =>
                    # pre-crash-equivalent recall); tolerate a build that can no
                    # longer succeed (e.g. the rows were deleted later in the log)
                    try:
                        self.build_ivf(ns, **(rec.get("params") or {}))
                    except (ValueError, RuntimeError):
                        import logging

                        logging.getLogger(__name__).warning(
                            "WAL replay: build_ivf(%s) not applicable, skipped", ns
                        )
                elif op == "drop_ivf":
                    self.drop_ivf(ns)
                applied += 1
        finally:
            self._wal_replaying = False
        return applied

    # README-advertised persistence surface of the reference (SURVEY.md §0.1):
    # save_index/load_index and create_backup/restore_from_backup map onto snapshots.

    def save_index(self, path: str) -> None:
        self.save(path)

    def load_index(self, path: str) -> None:
        from .persist import load_storage

        self.storage = load_storage(path, self.config)

    def create_backup(self, path: str) -> None:
        self.save(path)

    def restore_from_backup(self, path: str) -> None:
        self.load_index(path)

    def start_auto_snapshot(self, path: str, interval_s: float = 300.0) -> None:
        """Periodic background checkpointing (crash recovery: restart with
        QueryProcessor.load(path) or the server's --snapshot flag).  Writes go to a
        temp directory and are swapped in atomically; skipped when nothing mutated."""
        import os
        import shutil

        if getattr(self, "_snap_thread", None) is not None:
            raise RuntimeError("auto-snapshot already running")
        self._snap_stop = threading.Event()

        def versions() -> tuple:
            return tuple(
                sorted(
                    (name, self.storage.namespace(name).version)
                    for name in self.storage.list_namespaces()
                )
            )

        def loop():
            last = None
            while not self._snap_stop.wait(interval_s):
                try:
                    cur = versions()
                    if cur == last:
                        continue
                    tmp = path + ".tmp"
                    shutil.rmtree(tmp, ignore_errors=True)
                    sealed = self._save_snapshot(tmp)
                    old = path + ".old"
                    shutil.rmtree(old, ignore_errors=True)
                    if os.path.isdir(path):
                        os.rename(path, old)
                    os.rename(tmp, path)
                    shutil.rmtree(old, ignore_errors=True)
                    # only now is the snapshot recovery-visible: safe to drop the
                    # WAL segments it covers
                    if self._wal is not None:
                        self._wal.prune(sealed)
                    last = cur
                    self.stats.record("auto_snapshot", 0.0)
                except Exception:  # pragma: no cover - keep checkpointing alive
                    import logging

                    logging.getLogger(__name__).exception("auto-snapshot failed")

        self._snap_thread = threading.Thread(target=loop, daemon=True, name="auto-snapshot")
        self._snap_thread.start()

    def stop_auto_snapshot(self) -> None:
        t = getattr(self, "_snap_thread", None)
        if t is not None:
            self._snap_stop.set()
            t.join(timeout=10)
            self._snap_thread = None
