"""Search path selection: the certified sweep for namespaces with a mirror, the scan otherwise.

Every search, single-device or per shard, goes through the function ``knn_backend``
returns:
    backend(q, data, valid, sq_norms, *, k, metric, db_tile, live_prefix, data_t, ...)
        -> (dist, idx[, tier])

A namespace that keeps a sweep mirror (``EngineConfig.sweep_dtype``) passes it as
``data_t`` and gets the certified window-major sweep (ops/pallas_knn_t.py); one
without gets the exact XLA scan (ops/topk.py).  Both return the same exact results.
``live_prefix`` is a host-known hint that rows [0, live_prefix) are exactly the live
rows (no tombstones; no filter active); the certified path uses it to skip mask
traffic, the scan ignores it (``valid`` is authoritative there).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import EngineConfig
from .pallas_knn_t import SWEEP_TILE, exact_knn_pallas_t, phase1_impl
from .topk import exact_knn


def knn_backend(config: EngineConfig):
    certify = config.certify_exact

    def backend(q, data, valid, sq_norms, *, k, metric, db_tile, live_prefix=None,
                data_t=None, sweep_err=None, sweep_resid=None, sweep_rscale=None,
                sweep_err1=None, sweep_rscale2=None, report_tier=False,
                sweep_light=False, sweep_prep=None):
        if data_t is None:
            d, i = exact_knn(q, data, valid, sq_norms, k=k, metric=metric, db_tile=db_tile)
            # tier -1: no certificate ran, the scan IS the exact path
            return (d, i, jnp.int32(-1)) if report_tier else (d, i)
        return exact_knn_pallas_t(
            q, data_t, data, valid, sq_norms,
            k=k, metric=metric, live_prefix=live_prefix,
            sweep_err=sweep_err, resid=sweep_resid,
            rscale=sweep_rscale, err1=sweep_err1, rscale2=sweep_rscale2,
            certify=certify, report_tier=report_tier, light=sweep_light,
            prep_cache=sweep_prep,
        )

    return backend


def search_path(capacity: int, dpad: int, sweep_dtype, batch: int = 128) -> str:
    """Name of the path a search takes (explain_query's "backend"): "scan", or
    "certified/<phase-1 impl>" when the namespace's mirror engages the sweep."""
    if sweep_dtype is None or capacity < 2 * SWEEP_TILE or capacity % SWEEP_TILE:
        return "scan"
    return f"certified/{phase1_impl(batch, dpad, sweep_dtype)}"
