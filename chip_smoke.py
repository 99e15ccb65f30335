#!/usr/bin/env python3
"""Bring-up check of the exact-kNN engine on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py                # phases A-E on one GPU
    python chip_smoke.py --four-cards   # only the sharded search, over 4 GPUs

The deployment is the ann-benchmarks SIFT-1M shape: 2^20 x 128-d f32, euclidean (and
cosine), generated from ``--seed`` (gaussian rows; nothing is downloaded).  Every
phase is compared with a float64 numpy oracle on the host and raises on any
mismatch; the last line of stdout is one JSON object, printed only when every phase
passed.  Without a GPU the script exits non-zero before running anything.

Tolerances (one set, used by every comparison):
  * ids: set-equal to the oracle's top-k, except for queries whose k-th and (k+1)-th
    oracle distances are within ID_TIE_REL (1e-5) relative of each other — either row
    is then a correct answer;
  * distances: within DIST_REL (1e-4) relative; l2 relative to |q|^2 + |x|^2 (the
    magnitude the f32 expanded form cancels from), cosine relative to 1;
  * Pallas-Triton against XLA phase 1: window-mins within PHASE1_REL (1e-5) x max|rank|,
    because the two sum the products in different orders.

Phases (one process, one card):
  A  default store (no mirror): bulk_load, batch search k=10/100 l2+cosine, one single
     query, one hybrid query with a 50% metadata filter, 1% deletes then search again.
  B  the recommended serving config (sweep_dtype="bfloat16", certified): k=10/100/1000
     l2+cosine before and after the deletes; one batch each with sweep_dtype float32
     and int8; phase-1 and end-to-end timings of the XLA and Pallas-Triton phase 1.
  C  64 concurrent single-query searches through the micro-batcher.
  D  IVF: build_ivf(n_clusters=1024); a full probe must equal exact search; recall at
     nprobe=8.
  E  REST, when aiohttp and pydantic import: PUT /vectors/batch, POST /search,
     DELETE /vectors served in-process on localhost.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np

ID_TIE_REL = 1e-5
DIST_REL = 1e-4
PHASE1_REL = 1e-5

N_ROWS, DIM, BATCH = 1 << 20, 128, 128

_COMPILE_S = [0.0]


def _on_event(event, duration, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE_S[0] += duration


def log(*parts):
    print(*parts, flush=True)


# ------------------------------------------------------------------ oracle


class Oracle:
    """Float64 brute force over the whole corpus for one metric (host numpy)."""

    def __init__(self, X, Q, metric):
        x64, q64 = X.astype(np.float64), Q.astype(np.float64)
        self.metric = metric
        self.xn = np.einsum("ij,ij->i", x64, x64)
        self.qn = np.einsum("ij,ij->i", q64, q64)
        dots = q64 @ x64.T
        if metric == "l2":
            self.d = self.qn[:, None] + self.xn[None, :] - 2.0 * dots
        else:
            self.d = 1.0 - dots / np.sqrt(np.maximum(self.qn[:, None] * self.xn[None, :], 1e-300))
        del dots

    def check(self, qi, rows, dists, k, live=None, what=""):
        """Compare one query's results (rows, engine distances) with the oracle."""
        d = self.d[qi] if live is None else np.where(live, self.d[qi], np.inf)
        kk = min(k, int(np.isfinite(d).sum()))
        part = np.argpartition(d, kk)[: kk + 1]
        part = part[np.argsort(d[part], kind="stable")]
        ref, ref_d = part[:kk], d[part[:kk]]
        rows, dists = np.asarray(rows), np.asarray(dists, np.float64)
        if len(rows) != kk:
            raise AssertionError(f"{what} q{qi}: {len(rows)} results, want {kk}")
        if live is not None and not live[rows].all():
            raise AssertionError(f"{what} q{qi}: returned a deleted or filtered row")
        scale = (self.qn[qi] + self.xn[rows]) if self.metric == "l2" else 1.0
        if not (np.abs(dists - self.d[qi][rows]) <= DIST_REL * scale).all():
            raise AssertionError(f"{what} q{qi}: distances off the oracle's for the same rows")
        ref_scale = (self.qn[qi] + self.xn[ref]) if self.metric == "l2" else 1.0
        if not (np.abs(np.sort(dists) - ref_d) <= DIST_REL * ref_scale).all():
            raise AssertionError(f"{what} q{qi}: sorted distances off the oracle's top-{kk}")
        tie = kk < len(part) and abs(d[part[kk]] - ref_d[-1]) <= ID_TIE_REL * max(abs(ref_d[-1]), 1e-30)
        if not tie and set(rows.tolist()) != set(ref.tolist()):
            raise AssertionError(f"{what} q{qi}: ids differ from the oracle's top-{kk}")
        return tie


def check_hits(oracle, hits_per_query, id2row, k, live=None, what="", qidx=None):
    """Engine results (lists of {"id", "score"}) against the oracle; returns tie count."""
    ties = 0
    for j, hits in enumerate(hits_per_query):
        qi = j if qidx is None else qidx[j]
        rows = [id2row[h["id"]] for h in hits]
        score = np.array([h["score"] for h in hits], np.float64)
        dists = score if oracle.metric == "l2" else 1.0 - score
        ties += oracle.check(qi, rows, dists, k, live, what)
    return ties


# ------------------------------------------------------------------ phases


def phase_a(X, Q, oracles, *, ks=(10, 100), seed=0):
    """Default store (no mirror) through QueryProcessor."""
    from mlvectordb_tpu import QueryProcessor, VectorDTO
    from mlvectordb_tpu.config import EngineConfig

    n = X.shape[0]
    qp = QueryProcessor(config=EngineConfig())
    ids = qp.bulk_load(X, "a", metadatas=[{"half": i % 2} for i in range(n)])
    id2row = {v: i for i, v in enumerate(ids)}
    dtos = [VectorDTO(q) for q in Q]
    ties = 0
    for metric in ("l2", "cosine"):
        for k in ks:
            hits = qp.find_similar_batch(dtos, top_k=k, namespace="a", metric=metric)
            ties += check_hits(oracles[metric], hits, id2row, k, what=f"A {metric} k={k}")
    hits = [qp.find_similar(dtos[0], top_k=10, namespace="a", metric="l2")]
    ties += check_hits(oracles["l2"], hits, id2row, 10, what="A single")
    half = np.arange(n) % 2 == 0
    hits = qp.find_similar_batch(dtos, top_k=10, namespace="a", metric="l2", filter={"half": 0})
    ties += check_hits(oracles["l2"], hits, id2row, 10, live=half, what="A hybrid")
    dead = np.random.default_rng(seed + 1).choice(n, n // 100, replace=False)
    qp.delete([ids[i] for i in dead], "a")
    live = np.ones(n, bool)
    live[dead] = False
    for metric in ("l2", "cosine"):
        hits = qp.find_similar_batch(dtos, top_k=ks[0], namespace="a", metric=metric)
        ties += check_hits(oracles[metric], hits, id2row, ks[0], live=live,
                           what=f"A deleted {metric}")
    log(f"phase A: ok, near-tie queries {ties}, path {qp.explain_query(dtos[0], namespace='a')['backend']}")
    return qp, ids, id2row, live, dead


def phase_b(X, Q, oracles, dead, *, ks=(10, 100, 1000), other_dtypes=("float32", "int8")):
    """The recommended serving config: f32 store + bf16 mirror + int8 residual codes,
    certified; plus one batch on each other accepted sweep dtype."""
    from mlvectordb_tpu import QueryProcessor, VectorDTO
    from mlvectordb_tpu.config import EngineConfig

    n = X.shape[0]
    dtos = [VectorDTO(q) for q in Q]
    qp = QueryProcessor(config=EngineConfig(sweep_dtype="bfloat16"))
    ids = qp.bulk_load(X, "b")
    id2row = {v: i for i, v in enumerate(ids)}
    live = np.ones(n, bool)
    live[dead] = False
    ties = 0
    for deleted in (False, True):
        if deleted:
            qp.delete([ids[i] for i in dead], "b")
        for metric in ("l2", "cosine"):
            for k in ks:
                hits = qp.find_similar_batch(dtos, top_k=k, namespace="b", metric=metric)
                ties += check_hits(oracles[metric], hits, id2row, k,
                                   live=live if deleted else None,
                                   what=f"B {metric} k={k} deleted={deleted}")
    tiers = qp.get_statistics()["exactness"].get("tiers_by_namespace", {})
    log(f"phase B: ok, near-tie queries {ties}, path "
        f"{qp.explain_query(dtos[0], namespace='b')['backend']}, certificate tiers {tiers}")
    for sdt in other_dtypes:
        qo = QueryProcessor(config=EngineConfig(sweep_dtype=sdt))
        oids = qo.bulk_load(X, "o")
        hits = qo.find_similar_batch(dtos, top_k=ks[0], namespace="o", metric="l2")
        t = check_hits(oracles["l2"], hits, {v: i for i, v in enumerate(oids)}, ks[0],
                       what=f"B sweep_dtype={sdt}")
        log(f"phase B sweep_dtype={sdt}: ok, near-tie queries {t}, certificate tiers "
            f"{qo.get_statistics()['exactness'].get('tiers_by_namespace', {})}")
        del qo
        gc.collect()
    return qp


def _median_s(fn, reps):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase1_timings(qp, Q, *, ks=(10, 100, 1000), reps=20, impls=("xla", "triton")):
    """Phase 1 alone and the whole certified search, XLA vs Pallas-Triton phase 1, at
    the served namespace's shape and B = len(Q), light and heavy certificate plans.
    Also checks that the two phase-1 forms agree (PHASE1_REL)."""
    import jax
    import jax.numpy as jnp

    from mlvectordb_tpu.ops import pallas_knn_t as pk

    st = qp.storage.namespace("b").device_state()
    q = jnp.asarray(np.pad(Q, ((0, 0), (0, st.data.shape[1] - Q.shape[1]))))
    B, cap, Dp = q.shape[0], st.data.shape[0], st.data.shape[1]
    lp = st.high_water if st.live_count == st.high_water else None
    out = {}
    for light in (True, False):
        use_resid = not light
        wb, q_tags, _ = pk._cert_plan(
            certify=True, light=light, mixed=True, lossy_sweep=True, int8_sweep=False,
            use_resid=use_resid, has_sweep_err=True, has_err1=True, metric="l2")
        prep = pk.search_prep(B, st.data_t, st.data.dtype, st.valid, st.sq_norms, k=10,
                              metric="l2", live_prefix=lp, light=light,
                              sweep_err=st.sweep_err, resid=st.sweep_resid,
                              rscale=st.sweep_rscale, err1=st.sweep_err1)
        q_fold = -2.0 * q
        qh = q_fold.astype(jnp.bfloat16)
        qres = None if light else (q_fold - qh.astype(jnp.float32)).astype(jnp.bfloat16)
        ql = jnp.sqrt(jnp.sum(q * q, -1))
        scales = {"qh": 2.0 * ql, "qres": jnp.sqrt(jnp.sum((q_fold - qh.astype(jnp.float32)) ** 2, -1))}
        qe = jnp.stack([scales[t] for t in q_tags], axis=1)
        args = (qh, qres, st.data_t, st.sweep_resid if use_resid else None,
                prep["rscale_row"], prep["scale_row"], prep["bias_row"])
        for k in ks:
            r1 = pk._pick_r1(B, cap, k)
            wms = {}
            for impl in impls:
                f1 = jax.jit(lambda a, e, impl=impl, r1=r1: pk._window_mins(
                    *a, impl=impl, r1=r1, qe=e, eb_rows=tuple(prep["eb_rows"])))
                wms[impl] = f1(args, qe)
                t1 = _median_s(lambda: f1(args, qe), reps)
                cache = {}

                def e2e(impl=impl, k=k, cache=cache):
                    return pk.exact_knn_pallas_t(
                        q, st.data_t, st.data, st.valid, st.sq_norms, k=k, metric="l2",
                        live_prefix=lp, sweep_err=st.sweep_err, resid=st.sweep_resid,
                        rscale=st.sweep_rscale, err1=st.sweep_err1, light=light,
                        prep_cache=cache, phase1=impl, report_tier=True)
                t2 = _median_s(e2e, reps)
                tier = int(e2e()[2])
                out[(light, k, impl)] = (t1, t2)
                log(f"phase1 {'light' if light else 'heavy'} k={k} r1={r1} impl={impl}: "
                    f"phase1_ms={t1 * 1e3:.4f} e2e_ms={t2 * 1e3:.4f} tier={tier}")
            if len(wms) == 2:
                ref, got = np.asarray(wms["xla"]), np.asarray(wms["triton"])
                live = ref < pk.MASKED / 2
                tol = PHASE1_REL * np.abs(ref[live]).max()
                err = np.abs(got[live] - ref[live]).max()
                if not (err <= tol and (got[~live] >= pk.MASKED / 2).all()):
                    raise AssertionError(f"triton phase 1 off xla: max err {err} > {tol}")
                log(f"phase1 {'light' if light else 'heavy'} k={k}: triton vs xla max err "
                    f"{err:.3e} <= {tol:.3e}")
    return out


def phase_c(qp, Q, oracle, id2row, live, *, n_clients=64):
    """Concurrent single-query searches through the micro-batcher."""
    from concurrent.futures import ThreadPoolExecutor

    from mlvectordb_tpu import VectorDTO
    from mlvectordb_tpu.engine.batcher import MicroBatcher

    mb = MicroBatcher(qp)
    try:
        qidx = [i % len(Q) for i in range(n_clients)]
        with ThreadPoolExecutor(n_clients) as pool:
            hits = list(pool.map(
                lambda i: mb.find_similar(VectorDTO(Q[i]), top_k=10, namespace="a", metric="l2"),
                qidx))
        ties = check_hits(oracle, hits, id2row, 10, live=live, what="C", qidx=qidx)
        stats = mb.stats()
    finally:
        mb.close()
    log(f"phase C: ok, {n_clients} singles in {stats.get('batches_executed')} batches, "
        f"near-tie queries {ties}")


def phase_d(qp, Q, oracle, id2row, live, *, n_clusters=1024, nprobe=8):
    """IVF: a full probe answers like exact search (both held to the same oracle);
    recall at a small nprobe against exact search."""
    from mlvectordb_tpu import VectorDTO

    dtos = [VectorDTO(q) for q in Q]
    qp.build_ivf("a", n_clusters=n_clusters)
    exact = qp.find_similar_batch(dtos, top_k=10, namespace="a", metric="l2")
    full = qp.find_similar_batch(dtos, top_k=10, namespace="a", metric="l2", nprobe=n_clusters)
    check_hits(oracle, exact, id2row, 10, live=live, what="D exact")
    check_hits(oracle, full, id2row, 10, live=live, what="D full probe")
    few = qp.find_similar_batch(dtos, top_k=10, namespace="a", metric="l2", nprobe=nprobe)
    recall = np.mean([len({h["id"] for h in e} & {h["id"] for h in f}) / max(len(e), 1)
                      for e, f in zip(exact, few)])
    log(f"phase D: ok, full probe == exact, recall@10 at nprobe={nprobe}: {recall:.4f}")
    return recall


def rest_available() -> bool:
    try:
        import aiohttp  # noqa: F401
        import pydantic  # noqa: F401
    except ImportError:
        return False
    return True


def phase_e(qp, X, Q, oracle, id2row, live, *, n_rest=2000):
    """REST served in-process on localhost: PUT /vectors/batch, POST /search, DELETE /vectors."""
    import asyncio
    import socket
    import threading
    import urllib.request

    from aiohttp import web

    from mlvectordb_tpu.api.rest_api import RestAPI

    api = RestAPI(query_processor=qp, title="MLVectorDB API", log_level="WARNING")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(api.get_app())
    loop.run_until_complete(runner.setup())
    loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def call(method, path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            method=method, headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    try:
        rows = X[:n_rest]
        got = call("PUT", "/vectors/batch?namespace=rest",
                   {"vectors": [{"values": r.tolist()} for r in rows]})
        rest_ids = got["ids"]
        small = Oracle(rows, Q, "l2")
        rid2row = {v: i for i, v in enumerate(rest_ids)}
        for qi in range(4):
            hits = call("POST", "/search?namespace=rest",
                        {"query": Q[qi].tolist(), "top_k": 10, "metric": "l2"})
            small.check(qi, [rid2row[h["id"]] for h in hits], [h["score"] for h in hits], 10,
                        what="E rest")
            hits = call("POST", "/search?namespace=a",
                        {"query": Q[qi].tolist(), "top_k": 10, "metric": "l2"})
            oracle.check(qi, [id2row[_uuid(h["id"])] for h in hits],
                         [h["score"] for h in hits], 10, live=live, what="E corpus")
        gone = rest_ids[: n_rest // 2]
        got = call("DELETE", "/vectors?namespace=rest", {"ids": gone})
        if len(got["ids"]) != len(gone):
            raise AssertionError("E: DELETE /vectors removed the wrong count")
        alive = np.zeros(n_rest, bool)
        alive[n_rest // 2:] = True
        hits = call("POST", "/search?namespace=rest",
                    {"query": Q[0].tolist(), "top_k": 10, "metric": "l2"})
        small.check(0, [rid2row[h["id"]] for h in hits], [h["score"] for h in hits], 10,
                    live=alive, what="E rest deleted")
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.run_until_complete(runner.cleanup())
        loop.close()
    log("phase E: ok, PUT /vectors/batch, POST /search, DELETE /vectors")


def _uuid(s):
    import uuid

    return uuid.UUID(s)


def four_cards(X, Q, oracles, *, ks=(10, 100)):
    """Sharded search over a 1 replica x 4 shard mesh.  One sharded store with a bf16
    mirror is loaded once (host ingest dominates this phase); it is searched with the
    mirror through the engine (certified sweep per shard) and without it through the
    ShardingManager (scan per shard), both against the oracle."""
    import jax
    import jax.numpy as jnp

    from mlvectordb_tpu import VectorDTO
    from mlvectordb_tpu.config import EngineConfig
    from mlvectordb_tpu.parallel import make_distributed_processor

    qp = make_distributed_processor(1, 4, EngineConfig(sweep_dtype="bfloat16"))
    ids = qp.bulk_load(X, "s")
    id2row = {v: i for i, v in enumerate(ids)}
    ns = qp.storage.namespace("s")
    st = ns.device_state()
    for name, arr in (("store", st.data), ("mirror", st.data_t)):
        devs = sorted({sh.device.id for sh in arr.addressable_shards})
        log(f"four-cards: {name} {arr.shape} {arr.sharding.spec} on devices {devs}")
        if len(devs) != 4:
            raise AssertionError(f"four-cards: the {name} is not spread over four devices")
    sm = qp.sharding_manager
    qpad = jnp.zeros((len(Q), st.data.shape[1]), jnp.float32).at[:, : Q.shape[1]].set(Q)
    dtos = [VectorDTO(q) for q in Q]
    for mirror in (False, True):
        args = (qpad, st.data, st.valid, st.sq_norms) + (
            (st.data_t, st.sweep_err) if mirror else ())
        hlo = jax.jit(lambda *a: sm.sharded_knn(*a, k=10, metric="l2")).lower(
            *args).compile().as_text()
        n_ag = hlo.count("all-gather-start") + hlo.count(" all-gather(")
        log(f"four-cards mirror={mirror}: compiled search has {n_ag} all-gather collectives")
        if n_ag == 0:
            raise AssertionError("four-cards: no cross-device all-gather in the sharded search")
        ties = 0
        for metric in ("l2", "cosine"):
            for k in ks:
                what = f"4x mirror={mirror} {metric} k={k}"
                if mirror:
                    hits = qp.find_similar_batch(dtos, top_k=k, namespace="s", metric=metric)
                    ties += check_hits(oracles[metric], hits, id2row, k, what=what)
                    continue
                d, slots = jax.device_get(sm.sharded_knn(*args, k=k, metric=metric))
                for qi in range(len(Q)):
                    rows = [id2row[ns.slot_to_id(int(s))] for s in slots[qi]]
                    ties += oracles[metric].check(qi, rows, d[qi], k, what=what)
        log(f"four-cards mirror={mirror}: ok, near-tie queries {ties}")


# ------------------------------------------------------------------ driver


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def _phase_done(name, t0, c0, dev):
    stats = dev.memory_stats() or {}
    log(f"{name}: wall_s={time.perf_counter() - t0:.1f} compile_s={_COMPILE_S[0] - c0:.1f} "
        f"peak_bytes_in_use={stats.get('peak_bytes_in_use', 'not available')}")


def make_data(seed, n, dim, batch):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, dim), dtype=np.float32)
    Q = rng.standard_normal((batch, dim), dtype=np.float32)
    return X, Q


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded search over four GPUs")
    args = ap.parse_args(argv)

    import jax
    import jax.monitoring

    import mlvectordb_tpu  # noqa: F401  (fails outside a checkout of the repo)
    from mlvectordb_tpu.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform}", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, JAX found {len(devices)}", file=sys.stderr)
        return 1
    cache = enable_compile_cache()
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    log(f"card: {_card_line()}")
    log(f"device_kind: {dev.device_kind}, devices: {len(devices)}, compile cache: {cache}")
    from mlvectordb_tpu import native

    log(f"native: _hydrate={native.hydrate_module() is not None} "
        f"libmetafilter={native.available()}")
    rest = rest_available()
    log(f"rest packages (aiohttp, pydantic) import: {rest}")

    n = 4 * N_ROWS if args.four_cards else N_ROWS
    t0 = time.perf_counter()
    X, Q = make_data(args.seed, n, DIM, BATCH)
    oracles = {m: Oracle(X, Q, m) for m in ("l2", "cosine")}
    log(f"data + oracle: {X.shape} f32, {time.perf_counter() - t0:.1f} s")

    if args.four_cards:
        t0, c0 = time.perf_counter(), _COMPILE_S[0]
        four_cards(X, Q, oracles)
        _phase_done("four-cards", t0, c0, dev)
    else:
        t0, c0 = time.perf_counter(), _COMPILE_S[0]
        qp_a, ids_a, id2row, live, dead = phase_a(X, Q, oracles, seed=args.seed)
        _phase_done("phase A", t0, c0, dev)
        t0, c0 = time.perf_counter(), _COMPILE_S[0]
        qp_b = phase_b(X, Q, oracles, dead)
        phase1_timings(qp_b, Q)
        del qp_b
        gc.collect()
        _phase_done("phase B", t0, c0, dev)
        t0, c0 = time.perf_counter(), _COMPILE_S[0]
        phase_c(qp_a, Q, oracles["l2"], id2row, live)
        _phase_done("phase C", t0, c0, dev)
        t0, c0 = time.perf_counter(), _COMPILE_S[0]
        phase_d(qp_a, Q, oracles["l2"], id2row, live)
        _phase_done("phase D", t0, c0, dev)
        if rest:
            t0, c0 = time.perf_counter(), _COMPILE_S[0]
            phase_e(qp_a, X, Q, oracles["l2"], id2row, live)
            _phase_done("phase E", t0, c0, dev)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
