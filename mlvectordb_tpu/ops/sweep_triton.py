"""Phase-1 window-min sweep as a Pallas kernel for NVIDIA GPUs (Triton route).

Produces the same ``[B, nt*g*WLANE]`` window-min matrix as the plain XLA form in
``pallas_knn_t._window_mins_xla``, without writing the ``[B, cap]`` f32 rank matrix
to device memory and reading it back for the min.

Grid: one program per (query block, window group).  A window group is ``r1``
consecutive WLANE-wide column slices of one sweep tile (the window-major layout puts
the r1 rows of each fine window in the same lane of those slices).  The program keeps
its query block resident and loops over the slices: one tensor-core product per
slice (bf16 operands, f32 accumulation), the per-column folds (residual correction,
scale, bias, certificate error bounds), and a running minimum.  It stores one
``[Bq, WLANE]`` block.  Triton's ``num_stages`` overlaps the next slice's load with
the current product.

``supports`` says which variants this kernel covers; ``pallas_knn_t.phase1_impl``
chooses between it and the XLA form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

WLANE = 128
Q_BLOCK = 64      # queries per program: one 64-row warpgroup tile
NUM_WARPS = 4
NUM_STAGES = 3


def supports(batch: int, dp: int, sweep_dtype) -> bool:
    """Variants the kernel covers: bf16 and int8 sweeps at Dp=128 (the width it was
    measured at), batches of at least 16 rows (Triton's smallest dot tile)."""
    return (
        sweep_dtype in (jnp.bfloat16, jnp.int8)
        and dp == 128
        and batch >= 16
        and batch % min(Q_BLOCK, batch) == 0
    )


def _kernel(*refs, r1, two_pass, use_resid, use_scale, n_eb, precision):
    refs = list(refs)
    out_ref = refs.pop()
    q_ref = refs.pop(0)
    qr_ref = refs.pop(0) if two_pass else None
    db_ref = refs.pop(0)
    res_ref, rs_ref = (refs.pop(0), refs.pop(0)) if use_resid else (None, None)
    sc_ref = refs.pop(0) if use_scale else None
    bias_ref = refs.pop(0)
    qe_ref, eb_ref = (refs.pop(0), refs.pop(0)) if n_eb else (None, None)

    q = q_ref[...]
    qr = qr_ref[...] if two_pass else None
    qe = [qe_ref[:, t] for t in range(n_eb)]

    def body(rr, acc):
        cols = pl.ds(pl.multiple_of(rr * WLANE, WLANE), WLANE)
        db = db_ref[:, cols]
        if db.dtype == jnp.int8:
            db = db.astype(jnp.bfloat16)  # codes are integers <= 127: exact in bf16
        dots = pl.dot(q, db, precision=precision)
        if two_pass:
            dots = dots + pl.dot(qr, db, precision=precision)
        if use_resid:
            corr = pl.dot(q, res_ref[:, cols].astype(jnp.bfloat16))
            dots = dots + corr * rs_ref[cols][None, :]
        rank = dots
        if use_scale:
            rank = rank * sc_ref[cols][None, :]
        rank = rank + bias_ref[cols][None, :]
        for t in range(n_eb):
            rank = rank - qe[t][:, None] * eb_ref[t, cols][None, :]
        return jnp.minimum(acc, rank)

    init = jnp.full(out_ref.shape, jnp.inf, jnp.float32)
    out_ref[...] = jax.lax.fori_loop(0, r1, body, init)


def window_mins(qh, qres, data_t, resid_t, rscale_row, scale_row, bias_row, *,
                r1, precision, qe=None, eb_rows=()):
    """Same operands and result as ``pallas_knn_t._window_mins_xla``."""
    Dp, cap = data_t.shape
    B = qh.shape[0]
    bq = min(Q_BLOCK, B)
    gw = r1 * WLANE
    n_groups = cap // gw
    n_eb = len(eb_rows)

    def rows(spec_rows):
        return pl.BlockSpec((spec_rows, gw), lambda i, j: (0, j))

    qspec = pl.BlockSpec((bq, Dp), lambda i, j: (i, 0))
    vec = pl.BlockSpec((gw,), lambda i, j: (j,))
    args, specs = [qh], [qspec]
    if qres is not None:
        args.append(qres)
        specs.append(qspec)
    args.append(data_t)
    specs.append(rows(Dp))
    if resid_t is not None:
        args += [resid_t, rscale_row.reshape(cap)]
        specs += [rows(Dp), vec]
    if scale_row is not None:
        args.append(scale_row.reshape(cap))
        specs.append(vec)
    args.append(bias_row.reshape(cap))
    specs.append(vec)
    if n_eb:
        args += [qe, jnp.concatenate(eb_rows, axis=0)]
        specs += [pl.BlockSpec((bq, n_eb), lambda i, j: (i, 0)), rows(n_eb)]

    def kernel(*refs):
        _kernel(*refs, r1=r1, two_pass=qres is not None, use_resid=resid_t is not None,
                use_scale=scale_row is not None, n_eb=n_eb, precision=precision)

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, n_groups * WLANE), jnp.float32),
        grid=(B // bq, n_groups),
        in_specs=specs,
        out_specs=pl.BlockSpec((bq, WLANE), lambda i, j: (i, j)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        name="sweep_window_mins",
    )(*args)
