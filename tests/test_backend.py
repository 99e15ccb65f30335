"""Search-path selection (ops/backend.py), the sharded path through it, and the
compile-cache helper."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlvectordb_tpu.config import EngineConfig
from mlvectordb_tpu.ops import backend as backend_mod
from mlvectordb_tpu.ops import pallas_knn_t as pk
from mlvectordb_tpu.ops.backend import knn_backend, search_path


def _corpus(rng, n, d=128):
    db = jnp.asarray(rng.standard_normal((n, d), dtype=np.float32))
    return db, jnp.sum(db * db, axis=-1), jnp.ones((n,), bool)


def test_backend_scan_without_mirror_certified_with(rng, monkeypatch):
    """No mirror -> the scan (tier -1); a mirror -> the certified sweep, which
    reports a certificate tier; both agree with each other."""
    n = 2 * pk.SWEEP_TILE
    db, sq, valid = _corpus(rng, n)
    q = jnp.asarray(rng.standard_normal((16, 128), dtype=np.float32))
    be = knn_backend(EngineConfig())
    d0, i0, t0 = be(q, db, valid, sq, k=10, metric="l2", db_tile=4096,
                    live_prefix=n, report_tier=True)
    assert int(t0) == -1
    calls = []
    real = backend_mod.exact_knn_pallas_t
    monkeypatch.setattr(backend_mod, "exact_knn_pallas_t",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    d1, i1, t1 = be(q, db, valid, sq, k=10, metric="l2", db_tile=4096, live_prefix=n,
                    data_t=pk.to_sweep_layout(db, dtype=jnp.bfloat16),
                    sweep_err=pk.sweep_err_norms(db), report_tier=True)
    assert calls and int(t1) == 0
    for a, b in zip(np.asarray(i0), np.asarray(i1)):
        assert set(a.tolist()) == set(b.tolist())
    assert search_path(n, 128, None) == "scan"
    assert search_path(n, 128, jnp.bfloat16) == "certified/xla"  # CPU: XLA phase 1
    assert search_path(pk.SWEEP_TILE, 128, jnp.bfloat16) == "scan"


def test_backend_has_no_fallback(rng, monkeypatch):
    """A failure inside the certified path surfaces; nothing catches it and serves
    the scan instead."""
    n = 2 * pk.SWEEP_TILE
    db, sq, valid = _corpus(rng, n)

    def broken(*a, **kw):
        raise RuntimeError("phase 1 failed")

    monkeypatch.setattr(backend_mod, "exact_knn_pallas_t", broken)
    be = knn_backend(EngineConfig())
    with pytest.raises(RuntimeError, match="phase 1 failed"):
        be(jnp.zeros((16, 128)), db, valid, sq, k=10, metric="l2", db_tile=4096,
           data_t=pk.to_sweep_layout(db, dtype=jnp.bfloat16))


@pytest.mark.parametrize("mirror", [False, True], ids=["scan", "certified"])
def test_sharded_search_on_four_devices(rng, oracle, eight_devices, mirror):
    """1 replica x 4 shards on virtual CPU devices: every shard runs the backend (the
    certified sweep when the mirror is passed), the merge is an all_gather, results
    match the oracle, and no Pallas call (interpreted or not) is in the program."""
    from mlvectordb_tpu.parallel import ShardingManager, build_mesh

    sm = ShardingManager(build_mesh(1, 4, devices=jax.devices()[:4]))
    shard = 2 * pk.SWEEP_TILE
    n = 4 * shard
    db_np = rng.standard_normal((n, 128)).astype(np.float32)
    db, valid, sq = sm.place_database(jnp.asarray(db_np), jnp.ones((n,), bool),
                                      jnp.asarray((db_np ** 2).sum(-1)))
    extra = ()
    if mirror:
        data_t = jax.device_put(
            pk.to_sweep_layout(db, dtype=jnp.bfloat16, shard_cap=shard),
            sm.db_sharding_2d_t())
        extra = (data_t, jax.device_put(pk.sweep_err_norms(db), sm.db_sharding()))
    q = rng.standard_normal((16, 128)).astype(np.float32)

    def run(qq):
        return sm.sharded_knn(qq, db, valid, sq, *extra, k=10, metric="l2", db_tile=4096)

    jaxpr = str(jax.make_jaxpr(run)(jnp.asarray(q)))
    assert "pallas_call" not in jaxpr and "all_gather" in jaxpr
    assert ("_fused_t" in jaxpr) == mirror  # the certified program ran per shard
    d, i = run(jnp.asarray(q))
    od, oi = oracle(q, db_np, 10, "l2")
    for b in range(16):
        assert set(np.asarray(i)[b].tolist()) == set(oi[b].tolist())
    np.testing.assert_allclose(np.sort(np.asarray(d), 1), od, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins untouched; otherwise <checkout>/.jax_cache."""
    import os

    from mlvectordb_tpu.utils import compile_cache

    updates = []
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert updates == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(compile_cache.CHECKOUT, ".jax_cache")
        assert compile_cache.enable_compile_cache() == want
        assert updates == [("jax_compilation_cache_dir", want)]
        assert os.path.isfile(os.path.join(compile_cache.CHECKOUT, "chip_smoke.py"))
