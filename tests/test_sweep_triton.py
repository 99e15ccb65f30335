"""Pallas-Triton phase 1 (ops/sweep_triton.py) against the XLA phase 1, in interpret mode.

The kernel is compiled for the GPU only on the card (chip_smoke.py compares it there
at full width); here the Pallas interpreter runs the same kernel body on the CPU.
Both forms must produce the same window-min matrix up to f32 accumulation order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from mlvectordb_tpu.ops import pallas_knn_t as pk
from mlvectordb_tpu.ops import sweep_triton

N = 2 * pk.SWEEP_TILE
D = 128
B = 16
R1 = 16

# variant -> (sweep dtype, metric, light, use_resid)
VARIANTS = {
    "bf16_light": ("bfloat16", "l2", True, False),
    "bf16_resid_heavy": ("bfloat16", "l2", False, True),
    "f32": ("float32", "cosine", False, False),
    "int8": ("int8", "l2", False, False),
}


def _operands(rng, variant, masked, n=N, b=B):
    sdt, metric, light, use_resid = VARIANTS[variant]
    db = jnp.asarray(rng.standard_normal((n, D), dtype=np.float32))
    sq = jnp.sum(db * db, axis=-1)
    valid_np = np.ones(n, bool)
    if masked:
        valid_np[rng.choice(n, n // 10, replace=False)] = False
    valid = jnp.asarray(valid_np)
    hw = n if masked else n - 1000
    rscale = rscale2 = sweep_err = err1 = resid = None
    if sdt == "int8":
        data_t, rscale, sweep_err = pk.quantize_int8(db)
    else:
        data_t = pk.to_sweep_layout(db, dtype=jnp.dtype(sdt))
        if sdt == "bfloat16":
            resid, rscale, sweep_err, err1 = pk.quantize_resid(db)
    bf_sweep, int8_sweep = sdt == "bfloat16", sdt == "int8"
    wb_sources, q_tags, _ = pk._cert_plan(
        certify=True, light=light, mixed=bf_sweep or int8_sweep,
        lossy_sweep=bf_sweep or int8_sweep, int8_sweep=int8_sweep,
        use_resid=use_resid, has_sweep_err=sweep_err is not None,
        has_err1=err1 is not None, metric=metric,
    )
    prep = pk._prep_terms(
        valid, sq, jnp.int32(hw), rscale, rscale2, sweep_err, err1, cap=n,
        metric=metric, masked=masked, int8_sweep=int8_sweep, bf_sweep=bf_sweep,
        use_resid=use_resid, wb_sources=wb_sources,
    )
    q_fold = -2.0 * jnp.asarray(rng.standard_normal((b, D), dtype=np.float32))
    op = jnp.bfloat16 if int8_sweep else data_t.dtype
    qh = q_fold.astype(op)
    qres = (q_fold - qh.astype(jnp.float32)).astype(op) if (bf_sweep and not light) else None
    eb_rows = tuple(prep["eb_rows"])
    qe = (jnp.asarray(rng.uniform(1.0, 4.0, (b, len(eb_rows))).astype(np.float32))
          if eb_rows else None)
    assert len(q_tags) == len(eb_rows)
    args = (qh, qres, data_t, resid if use_resid else None, prep["rscale_row"],
            prep["scale_row"], prep["bias_row"])
    return args, dict(qe=qe, eb_rows=eb_rows)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "live_prefix"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_triton_phase1_matches_xla_phase1(rng, monkeypatch, variant, masked):
    args, kw = _operands(rng, variant, masked)
    precision = pk._phase1_precision(args[2].dtype)
    ref = np.asarray(pk._window_mins_xla(*args, r1=R1, precision=precision, **kw))
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    got = np.asarray(sweep_triton.window_mins(*args, r1=R1, precision=precision, **kw))
    assert got.shape == ref.shape == (B, N // R1)
    live = ref < pk.MASKED / 2
    assert live.any() and (got[~live] >= pk.MASKED / 2).all()
    # accumulation order differs between the two forms: 1e-5 of the largest rank
    tol = 1e-5 * np.abs(ref[live]).max()
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=tol)


def test_phase1_impl_choice():
    """Triton only on a GPU, only for the variants the kernel covers."""
    assert pk.phase1_impl(128, 128, jnp.bfloat16, platform="gpu") == "triton"
    assert pk.phase1_impl(128, 128, jnp.int8, platform="gpu") == "triton"
    assert pk.phase1_impl(128, 128, jnp.float32, platform="gpu") == "xla"
    assert pk.phase1_impl(8, 128, jnp.bfloat16, platform="gpu") == "xla"
    assert pk.phase1_impl(128, 256, jnp.bfloat16, platform="gpu") == "xla"
    assert pk.phase1_impl(128, 128, jnp.bfloat16, platform="cpu") == "xla"


@pytest.mark.gpu
@pytest.mark.parametrize("r1", [32, 16, 4])
@pytest.mark.parametrize("variant", ["bf16_light", "bf16_resid_heavy", "int8"])
def test_triton_phase1_compiled_matches_xla(rng, variant, r1):
    """The kernel as compiled for the card, at the SIFT-1M width, against XLA."""
    import jax

    args, kw = _operands(rng, variant, masked=False, n=1 << 20, b=128)
    precision = pk._phase1_precision(args[2].dtype)
    ref = np.asarray(pk._window_mins_xla(*args, r1=r1, precision=precision, **kw))
    got = np.asarray(jax.jit(functools.partial(
        sweep_triton.window_mins, r1=r1, precision=precision, **kw))(*args))
    live = ref < pk.MASKED / 2
    tol = 1e-5 * np.abs(ref[live]).max()
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=tol)
    assert (got[~live] >= pk.MASKED / 2).all()
