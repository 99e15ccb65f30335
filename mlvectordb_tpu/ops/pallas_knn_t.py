"""Window-major sweep exact kNN with a per-query exactness certificate.

The certified path of the engine: phase 1 ranks every row on a reduced-precision
sweep mirror (bf16, int8 or f32), phase 2 selects the most promising windows of
consecutive rows and rescans them exactly from the full-precision row-major store.

  WINDOW-MAJOR LAYOUT.  The sweep mirror ``data_t`` [Dp, cap] stores its columns
  PERMUTED so that a window-min over WLANE-wide column slices lands on windows of
  CONSECUTIVE store rows.  Column c = t*SWEEP_TILE + r*WLANE + j holds store row
  (t*WLANE + j)*R1MAX + r; the min over the r1-group slices then reduces store rows
  [f*r1, (f+1)*r1) for fine window f.  Phase 2 gathers candidates as
  dataw = rescan.reshape(cap//r1, r1*Dp) rows: one contiguous r1-row read per window.
  The permutation is pure arithmetic (per tile, columns are the [WLANE, R1MAX]
  transpose of rows), so per-row vectors permute with one reshape-transpose and
  scatters compute their target columns host-side (``sweep_cols_for_rows``).

  GROUPED EMISSION.  Every window width r1 in {1,2,4,8,16,32} uses one layout: a
  tile's rank block reduces in g = R1MAX//r1 groups of r1 WLANE-wide slices, giving
  g*WLANE mins per tile.  Output position p = t*g*WLANE + a*WLANE + j maps to window
  f = (t*WLANE + j)*g + a arithmetically.

  ONE DISPATCH.  Query prep (metric factor folding, bias/scale permutation, liveness),
  the sweep, selection, and the exact HIGHEST-precision rescan all trace into a single
  jitted program: one host->device transfer in, one device->host out.

Phase 1 ranks, it does not score (per-query constants dropped; the metric's scalar
factor folds into the query operand).  It runs as plain XLA (``_window_mins_xla``) or,
on NVIDIA GPUs for the variants it covers, as a Pallas-Triton kernel that never
writes the rank matrix (``sweep_triton``); ``phase1_impl`` is the one place that
chooses.  Exactness (default, ``certify=True``) is MACHINE-CHECKED per query: phase 1
emits OPTIMISTIC window-mins (each column's rank lowered by its own data-side error
norm, scaled per query), and the certificate proves that every window left
unscanned has true min rank beyond the k-th found distance.  Escalation is
three-tier: certified fast selection, an 8x wider selection reusing the same
window-min matrix, then a full-precision exact scan, so a failed proof costs speed,
never correctness.  ``certify=False`` (margin mode) returns tier 1 unconditionally:
exactness then rests on the empirical +16 selection margin (the documented
speed/proof trade; see EngineConfig.certify_exact).  Replaces the role of hnswlib's
graph walk (reference: src/mlvectordb/implementations/index.py:111).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from . import sweep_triton
from .distances import MASKED
from .topk import exact_knn

SWEEP_TILE = 4096          # db rows per layout tile
DB_TILE = SWEEP_TILE       # backward-compat alias
R1MAX = 32                 # layout interleave factor = max window width
WLANE = SWEEP_TILE // R1MAX  # 128: one window-min slice
R2 = 32                    # fine windows per level-2 selection block

# k at or above which selections pair-sort instead of top_k (see _sorted_topk)
SORT_TOPK_FROM = 257
# rescan width (s1*r1 candidate rows) at or above which the gather+score runs in
# lax.map chunks instead of one pass (see _rescan_windows)
RESCAN_CHUNK_FROM = 2048
# block-top refine for wide certified selections (see _select_and_rescan): each
# selected level-2 block yields its MB smallest windows
MB_BLOCKTOP = 8
# queries re-proved by the contained escalation tier (see _fused_t)
FQ_CONTAIN = 8


# ------------------------------------------------------------------ layout helpers

def to_sweep_layout(data: jax.Array, dtype=None, shard_cap: int | None = None) -> jax.Array:
    """[cap, Dp] row-major -> [Dp, cap] window-major sweep layout.

    ``shard_cap``: for mesh-sharded stores, permute within each shard's row range so
    every shard's column block is its own valid local layout (shard_cap must be a
    multiple of SWEEP_TILE)."""
    cap, Dp = data.shape
    unit = shard_cap or cap
    if unit % SWEEP_TILE or cap % unit:
        raise ValueError(f"sweep layout needs capacity in {SWEEP_TILE}-row tiles, got {cap}/{unit}")
    s = cap // unit
    nt = unit // SWEEP_TILE
    out = (
        data.reshape(s, nt, WLANE, R1MAX, Dp)
        .transpose(4, 0, 1, 3, 2)
        .reshape(Dp, cap)
    )
    return out.astype(dtype) if dtype is not None else out


def sweep_rows_1d(vec: jax.Array, shard_cap: int | None = None) -> jax.Array:
    """Permute a per-row [cap] vector into sweep column order (pure reshape/transpose)."""
    cap = vec.shape[-1]
    unit = shard_cap or cap
    s = cap // unit
    nt = unit // SWEEP_TILE
    return vec.reshape(s, nt, WLANE, R1MAX).swapaxes(-1, -2).reshape(cap)


def sweep_err_norms(data: jax.Array) -> jax.Array:
    """Per-row ``||row - bf16(row)||`` norms for MIXED f32-store/bf16-sweep configs —
    feeds the exactness certificate's tight data-side error bound (see _fused_t)."""
    d32 = data.astype(jnp.float32)
    delta = d32 - d32.astype(jnp.bfloat16).astype(jnp.float32)
    return jnp.sqrt(jnp.sum(delta * delta, axis=-1))


def quantize_int8_rows(vals: jax.Array):
    """Row-wise int8 PRIMARY quantization (sweep_dtype="int8"): row ~ scale * z with
    z int8 and a per-row scale.  Returns ``(z [n, Dp] int8, scale [n] f32,
    err [n] f32)`` with err = ||row - scale*z|| — the certificate's data-side bound
    (phase 1 at 1 byte/element; ~2x the bf16 sweep's bandwidth headroom, ~2x its
    error band — the proof decides per corpus whether that is enough)."""
    v32 = vals.astype(jnp.float32)
    scale = jnp.max(jnp.abs(v32), axis=-1) / 127.0
    safe = jnp.where(scale > 0, scale, 1.0)[:, None]
    z = jnp.clip(jnp.round(v32 / safe), -127.0, 127.0)
    z = jnp.where(scale[:, None] > 0, z, 0.0)
    rem = v32 - scale[:, None] * z
    err = jnp.sqrt(jnp.sum(rem * rem, axis=-1))
    return z.astype(jnp.int8), scale, err


def quantize_int8(data: jax.Array, shard_cap: int | None = None):
    """Whole-store int8 sweep mirror: ``(codes [Dp, cap] int8 sweep layout,
    scale [cap] f32, err [cap] f32)`` — see quantize_int8_rows."""
    z, scale, err = quantize_int8_rows(data)
    return to_sweep_layout(z, shard_cap=shard_cap), scale, err


def quantize_int8_resid_rows(vals: jax.Array):
    """Two-level int8 quantization: row ~ s1*z1 + s2*z2 (1+1 bytes/element).

    The residual-corrected PRIMARY-int8 sweep (sweep_dtype="int8" + sweep_resid):
    z2 encodes delta1 = row - s1*z1 with its own per-row scale s2 <= s1/254, so the
    remaining data-side band err2 = ||delta1 - s2*z2|| is ~2^-15 of the row's max
    element — comparable to the bf16+int8-resid band at 2/3 the HBM bytes and one
    fewer byte-stream (2 B/element total vs 3).  Returns
    ``(z1 [n, Dp] int8, s1 [n] f32, z2 [n, Dp] int8, s2 [n] f32, err2 [n] f32,
    err1 [n] f32)`` with err1 = ||delta1|| bounding the query-residual cross term."""
    v32 = vals.astype(jnp.float32)
    z1, s1, e1 = quantize_int8_rows(v32)
    delta = v32 - s1[:, None] * z1.astype(jnp.float32)
    s2 = jnp.max(jnp.abs(delta), axis=-1) / 127.0
    safe = jnp.where(s2 > 0, s2, 1.0)[:, None]
    z2 = jnp.clip(jnp.round(delta / safe), -127.0, 127.0)
    z2 = jnp.where(s2[:, None] > 0, z2, 0.0)
    rem = delta - s2[:, None] * z2
    e2 = jnp.sqrt(jnp.sum(rem * rem, axis=-1))
    return z1, s1, z2.astype(jnp.int8), s2, e2, e1


def quantize_int8_resid(data: jax.Array, shard_cap: int | None = None):
    """Whole-store two-level int8 sweep: ``(codes [Dp, cap] int8 sweep layout,
    s1 [cap] f32, resid [Dp, cap] int8 sweep layout, s2 [cap] f32, err2 [cap] f32,
    err1 [cap] f32)`` — see quantize_int8_resid_rows."""
    z1, s1, z2, s2, e2, e1 = quantize_int8_resid_rows(data)
    return (
        to_sweep_layout(z1, shard_cap=shard_cap), s1,
        to_sweep_layout(z2, shard_cap=shard_cap), s2, e2, e1,
    )


def quantize_resid_rows(vals: jax.Array):
    """Row-wise int8 residual quantization for MIXED f32-store/bf16-sweep configs.

    delta = row - bf16(row) is encoded as scale * z with z int8 and a per-row scale:
    returns ``(z [n, Dp] int8, scale [n] f32, err2 [n] f32, err1 [n] f32)`` where
    err2 = ||delta - scale*z|| (the certificate's remaining data-side bound, ~2^-8
    of err1) and err1 = ||delta|| (bounds the query-residual cross term)."""
    v32 = vals.astype(jnp.float32)
    delta = v32 - v32.astype(jnp.bfloat16).astype(jnp.float32)
    e1 = jnp.sqrt(jnp.sum(delta * delta, axis=-1))
    scale = jnp.max(jnp.abs(delta), axis=-1) / 127.0
    safe = jnp.where(scale > 0, scale, 1.0)[:, None]
    z = jnp.clip(jnp.round(delta / safe), -127.0, 127.0)
    z = jnp.where(scale[:, None] > 0, z, 0.0)
    rem = delta - scale[:, None] * z
    e2 = jnp.sqrt(jnp.sum(rem * rem, axis=-1))
    return z.astype(jnp.int8), scale, e2, e1


def quantize_resid(data: jax.Array, shard_cap: int | None = None):
    """Whole-store residual quantization: ``(resid [Dp, cap] int8 sweep layout,
    scale [cap] f32, err2 [cap] f32, err1 [cap] f32)`` — see quantize_resid_rows."""
    z, scale, e2, e1 = quantize_resid_rows(data)
    return to_sweep_layout(z, shard_cap=shard_cap), scale, e2, e1


def sweep_cols_for_rows(rows, shard_cap: int | None = None):
    """Store rows -> sweep mirror columns (vectorized int arithmetic; np or jnp)."""
    if shard_cap is not None:
        sh = rows // shard_cap
        loc = rows % shard_cap
        return sh * shard_cap + sweep_cols_for_rows(loc)
    w = rows // R1MAX
    r = rows % R1MAX
    t = w // WLANE
    j = w % WLANE
    return t * SWEEP_TILE + r * WLANE + j


# ------------------------------------------------------------------ phase 1

def _phase1_precision(dtype):
    """f32 sweeps rank at HIGHEST: without it a GPU runs f32 products in TF32, whose
    error the certificate's accumulation slack does not cover."""
    return jax.lax.Precision.HIGHEST if dtype == jnp.float32 else jax.lax.Precision.DEFAULT


def phase1_impl(batch: int, dp: int, sweep_dtype, platform: str | None = None) -> str:
    """The one place that chooses phase 1's implementation: ``"triton"`` (the
    Pallas-Triton kernel, sweep_triton) on a GPU for the variants it covers,
    ``"xla"`` (_window_mins_xla) everywhere else."""
    platform = platform or jax.default_backend()
    if platform == "gpu" and sweep_triton.supports(batch, dp, jnp.dtype(sweep_dtype)):
        return "triton"
    return "xla"


def _window_mins_xla(qh, qres, data_t, resid_t, rscale_row, scale_row, bias_row, *,
                     r1, precision, qe=None, eb_rows=()):
    """qh/qres [B, Dp] (metric factor pre-folded; qres = compensation residual or
    None), data_t [Dp, cap] sweep layout -> window-mins [B, cap // r1] in output
    position order (module docstring).

    rank = dots [+ (qh . resid) * rscale] [* scale] + bias - sum_t qe_t * eb_t:
    ``bias_row`` [1, cap] carries everything per-row (l2 sq_norms, tombstone/filter
    mask, unwritten tail) in sweep column order.  ``qres``: compensated query for
    mixed bf16 sweeps (head + residual both dotted against the mirror), removing the
    query-side rounding term from the certificate.  ``resid_t`` [Dp, cap] int8 +
    ``rscale_row`` [1, cap]: residual-correction codes, recovering qh . delta to the
    int8 quantizer's precision.  ``qe`` [B, n_eb] + ``eb_rows`` (n_eb [1, cap] rows):
    per-query scales and per-row certificate error bounds, so the mins are the
    certificate's OPTIMISTIC lower bounds directly."""
    Dp, cap = data_t.shape
    B = qh.shape[0]
    db = data_t.astype(jnp.bfloat16) if data_t.dtype == jnp.int8 else data_t

    def dot(a, b, prec):
        return jax.lax.dot_general(
            a, b, dimension_numbers=(((1,), (0,)), ((), ())),
            precision=prec, preferred_element_type=jnp.float32,
        )

    dots = dot(qh, db, precision)
    if qres is not None:
        dots = dots + dot(qres, db, precision)
    if resid_t is not None:
        # int8 codes are integers <= 127: the bf16 cast is exact
        dots = dots + dot(qh, resid_t.astype(jnp.bfloat16),
                          jax.lax.Precision.DEFAULT) * rscale_row
    rank = dots
    if scale_row is not None:
        rank = rank * scale_row
    rank = rank + bias_row
    for t, eb in enumerate(eb_rows):
        rank = rank - qe[:, t : t + 1] * eb
    g = R1MAX // r1
    nt = cap // SWEEP_TILE
    return rank.reshape(B, nt, g, r1, WLANE).min(axis=3).reshape(B, nt * g * WLANE)


def _window_mins(*args, impl, r1, **kw):
    fn = sweep_triton.window_mins if impl == "triton" else _window_mins_xla
    return fn(*args, r1=r1, precision=_phase1_precision(args[2].dtype), **kw)


# ------------------------------------------------------------------ phase 2 selection

def _pos_to_window(p, g: int):
    """Output position -> fine window id (see module docstring layout)."""
    gw = g * WLANE
    t = p // gw
    rem = p - t * gw
    a = rem // WLANE
    j = rem - a * WLANE
    return (t * WLANE + j) * g + a


def _sorted_topk(x, kk: int):
    """(values, positions) of the kk smallest per row via ONE pair-sort.

    Large-k selections sort (value, index) pairs once and slice instead of an
    iterative top_k; the SORT_TOPK_FROM threshold was chosen on earlier hardware
    and is not yet measured on a GPU."""
    B, W = x.shape
    iota = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (B, W))
    sv, si = jax.lax.sort((x, iota), dimension=-1, num_keys=1)
    return sv[:, :kk], si[:, :kk]


def _topk_min(x, kk: int):
    """Smallest-kk (values, positions): top_k for small kk, pair-sort for large."""
    if kk >= SORT_TOPK_FROM and x.shape[1] > kk:
        return _sorted_topk(x, kk)
    neg, i = jax.lax.top_k(-x, kk)
    return -neg, i


def _topk_spec(x, kk: int):
    """(values, idx, floor) of kk smallest entries per row of x [B, W].

    XLA top_k cost grows ~W*k, so wide selections run CHUNKED: per-chunk top-kc with
    a SMALL speculative kc (expected chunk occupancy + slack), then one narrow merge.
    Speculation can miss elements when a chunk holds more than kc of the global
    top-kk; ``floor`` [B] makes that SOUND for the exactness certificate: every
    element NOT returned is >= min(floor, values[:, -1]) — floor is the min over
    chunks of each chunk's kc-th smallest (+inf on the exact paths, where nothing
    below values[:, -1] can be missing).  A genuine miss drops floor below the
    certificate's bar and escalates the tier instead of returning a wrong result."""
    B, W = x.shape
    CH = 2048
    if W <= max(kk, 4096):
        v, i = _topk_min(x, min(kk, W))
        return v, i, jnp.full((B,), jnp.inf, jnp.float32)

    Wp = -(-W // CH) * CH
    pad = Wp - W
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad)), constant_values=jnp.inf)
    nch = Wp // CH
    if kk <= 64:
        kc = min(kk, CH)   # exact per chunk: no chunk can hold >kk of the top-kk
    else:
        occupancy = kk // nch + 4 * math.isqrt(max(kk // nch, 1)) + 16
        guarantee = (kk + pad + nch - 1) // nch  # merged real candidates >= kk
        kc = min(CH, max(occupancy, guarantee))
    v, i = jax.lax.top_k(-x.reshape(B * nch, CH), kc)
    vch = (-v).reshape(B, nch, kc)
    iglob = (
        i.reshape(B, nch, kc) + (jnp.arange(nch, dtype=jnp.int32) * CH)[None, :, None]
    ).reshape(B, nch * kc)
    v2, p = _topk_min(vch.reshape(B, nch * kc), kk)
    idx = jnp.minimum(jnp.take_along_axis(iglob, p, axis=1), W - 1)
    if kc < kk:  # speculative: unreturned elements are >= their chunk's kc-th
        floor = jnp.min(vch[:, :, -1], axis=1)
    else:
        floor = jnp.full((B,), jnp.inf, jnp.float32)
    return v2, idx, floor


def _flat_rows(mat3, idx):
    """Flat 2-D row gather: mat3 [B, W, C] rows selected by idx [B, s] -> [B, s, C]."""
    B, W, C = mat3.shape
    flat = mat3.reshape(B * W, C)
    gidx = idx + (jnp.arange(B, dtype=idx.dtype) * W)[:, None]
    return flat[gidx.reshape(-1)].reshape(B, idx.shape[1], C)


def _select_and_rescan(
    q32, qn_row, rescan, maskadd, hw, wmin, *, k, metric, r1, masked, s_sel=None,
    spec_l2=False,
):
    """Hierarchical window selection + exact HIGHEST rescan of contiguous windows.

    Returns ``(best_d, best_i, thresh)`` where ``thresh`` [B] is the selection
    threshold: every fine window NOT rescanned has (as-computed) window-min >= thresh.
    +inf when every window was rescanned.  The certificate in ``_fused_t`` compares
    ``thresh`` against the k-th found distance to prove no true neighbour was pruned.
    ``s_sel`` overrides the number of windows selected (the certificate escalation
    tiers pass wider widths).

    Certified callers feed window-mins that are ALREADY the certificate's
    optimistic per-row lower bounds (phase 1 folds the data-side error terms in),
    so selection here needs no error awareness at all: windows whose phase-1 rank
    is uncertain rank low and get rescanned exactly, and ``thresh`` is directly the
    optimistic-bound floor the proof compares against."""
    B, P = wmin.shape
    g = R1MAX // r1
    r2 = R2
    s = min(s_sel if s_sel is not None else min(2 * k, k + 16), P)
    two_level = P % r2 == 0 and P // r2 > 1

    if two_level:
        # two-level: min-reduce to r2-blocks first — top_k cost grows with the
        # row width, so shrinking W before the exact top_k is the cheap path
        W2 = P // r2
        wmin3 = wmin.reshape(B, W2, r2)
        wmin2 = wmin3.min(axis=-1)                        # [B, W2]
        s2 = min(s, W2)
        # chunked speculative selection at level 2 — CERTIFIED CALLERS ONLY: fl2
        # folds into thresh so a speculation miss escalates the certificate.
        # Margin mode has NO escalation (a miss there would become a recall miss),
        # so it keeps the exact selection.
        if spec_l2:
            v2, w2i, fl2 = _topk_spec(wmin2, s2)
        else:
            v2, w2i = _topk_min(wmin2, s2)
            fl2 = jnp.full((wmin2.shape[0],), jnp.inf, jnp.float32)
        w2i = jnp.sort(w2i, axis=1)
        l1_blk = _flat_rows(wmin3, w2i)                   # [B, s2, r2]
        # BLOCK-TOP refine (certified only): at wide selections each selected
        # block yields its MB smallest windows by MB rounds of min/argmin/mask
        # over the minor axis, and one narrow top-s1 runs on the [B, s2*MB]
        # candidates instead of a chunked top_k over [B, s2*r2].  SOUND under
        # the certificate only: a block hiding more than MB hot windows lowers
        # block_floor (min over blocks of each block's MB-th min) below the k-th
        # found rank and the batch escalates — with hot windows ~Poisson(s/W2)
        # per block, the W2 >= 4*s gate puts that at P(>=8) ~ 1e-3 per batch.
        use_bt = spec_l2 and s >= 512 and MB_BLOCKTOP < r2 and W2 >= 4 * s
        if use_bt:
            MB = MB_BLOCKTOP
            iota_r = jnp.arange(r2, dtype=jnp.int32)
            work = l1_blk
            vals, poss = [], []
            for _ in range(MB):
                m1 = work.min(axis=2)                     # [B, s2]
                pm = jnp.min(
                    jnp.where(work == m1[..., None], iota_r, r2), axis=2
                )
                # NaN rows match no lane: pm stays at the r2 sentinel — clamp so
                # the candidate decodes inside its own block (a NaN kth fails
                # check_exact and escalates regardless)
                pm = jnp.minimum(pm, r2 - 1)
                vals.append(m1)
                poss.append(pm)
                work = jnp.where(
                    iota_r[None, None, :] == pm[..., None], jnp.inf, work
                )
            cand_v = jnp.stack(vals, -1).reshape(B, s2 * MB)
            cand_p = (
                w2i[:, :, None] * r2 + jnp.stack(poss, -1)
            ).reshape(B, s2 * MB)
            s1 = min(s, s2 * MB)
            v1, sel = _topk_min(cand_v, s1)
            p = jnp.take_along_axis(cand_p, sel, axis=1)
            block_floor = vals[-1].min(axis=1)            # [B] MB-th mins' min
            thresh = jnp.minimum(fl2, block_floor)
            if s2 < W2:
                thresh = jnp.minimum(thresh, v2[:, -1])
            if s1 < s2 * MB:
                thresh = jnp.minimum(thresh, v1[:, -1])
        else:
            s1 = min(s, s2 * r2)
            l1_vals = l1_blk.reshape(B, s2 * r2)
            v1, pos, floor = _topk_spec(l1_vals, s1)
            w2sel = jnp.take_along_axis(w2i, pos // r2, axis=1)
            p = w2sel * r2 + pos % r2                     # output positions
            # unselected blocks >= s2-th block-min; unselected windows inside
            # selected blocks >= min(s1-th value, speculative floor)
            thresh = fl2                                  # level-2 speculation floor
            if s2 < W2:
                thresh = jnp.minimum(thresh, v2[:, -1])
            if s1 < s2 * r2:
                thresh = jnp.minimum(thresh, v1[:, -1])
            thresh = jnp.minimum(thresh, floor)
    else:
        s1 = min(s, P)
        v1, p, floor = _topk_spec(wmin, s1)
        thresh = floor if s1 >= P else jnp.minimum(v1[:, -1], floor)

    f = _pos_to_window(p, g)                              # [B, s1] fine windows
    best_d, best_i = _rescan_windows(
        q32, qn_row, rescan, maskadd, hw, f, k=k, metric=metric, r1=r1, masked=masked,
    )
    return best_d, best_i, thresh


def _rescan_windows(q32, qn_row, rescan, maskadd, hw, f, *, k, metric, r1, masked):
    """Exact HIGHEST-precision rescan of the selected fine windows ``f`` [B, s1]:
    contiguous r1-row gathers + fused VPU scoring + final top-k."""
    B, s1 = f.shape
    # ascending store order adds locality to the rescan gather; the final top-k
    # re-ranks, so candidate order is free
    f = jnp.sort(f, axis=1)
    cap, Dp = rescan.shape
    # contiguous window gather: one r1-row (r1*Dp*itemsize bytes) read per window
    dataw = rescan.reshape(cap // r1, r1 * Dp)

    def _score(fc):
        """Gather + exact-score one candidate-window chunk [B, sc] -> dist, rows."""
        sc = fc.shape[1]
        sub = dataw[fc.reshape(-1)].reshape(B, sc * r1, Dp).astype(jnp.float32)
        rws = (fc[:, :, None] * r1 + jnp.arange(r1, dtype=jnp.int32)).reshape(B, sc * r1)
        # elementwise mul+reduce, not a batched dot_general: it runs in true f32
        # (no TF32 matmul unit involved) and shares one pass over ``sub`` with
        # the norm reduction.  f32 tree-reduce accumulation error is within the
        # certificate's Dp * 2^-22 slack.
        dots = jnp.sum(sub * q32[:, None, :], axis=-1)    # [B, sc*r1]
        sqn_c = jnp.sum(sub * sub, axis=-1)               # norms from the rows
        if metric == "l2":
            dd = jnp.maximum(qn_row + sqn_c - 2.0 * dots, 0.0)
        elif metric == "ip":
            dd = 1.0 - dots
        else:
            denom = jax.lax.rsqrt(jnp.maximum(qn_row * sqn_c, 1e-30))
            dd = 1.0 - dots * denom
        if masked:
            dd = dd + maskadd[rws]
        else:
            dd = jnp.where(rws < hw, dd, MASKED)          # arithmetic tail mask
        return dd, rws

    # wide rescans score in chunks (lax.map) to bound the live gathered-sub
    # buffer (B*s1*r1*Dp*4 bytes in one pass) — chunking costs nothing on
    # exactness (same rows, same arithmetic).  s1 pads to a chunkable width;
    # pad slots repeat window 0 and are masked to MASKED below so duplicates
    # can never enter the top-k.
    if s1 * r1 >= RESCAN_CHUNK_FROM:
        nch = 8
        s1p = -(-s1 // nch) * nch
        fpad = jnp.pad(f, ((0, 0), (0, s1p - s1)))
        fch = fpad.reshape(B, nch, s1p // nch).transpose(1, 0, 2)
        dist_c, rows_c = jax.lax.map(_score, fch)         # [nch, B, (s1p/nch)*r1]
        dist = dist_c.transpose(1, 0, 2).reshape(B, s1p * r1)
        rows = rows_c.transpose(1, 0, 2).reshape(B, s1p * r1)
        if s1p != s1:
            pad_slot = jnp.arange(s1p * r1, dtype=jnp.int32) >= s1 * r1
            dist = jnp.where(pad_slot[None, :], MASKED, dist)
    else:
        dist, rows = _score(f)

    kk = min(k, dist.shape[1])
    best_d, pk = _topk_min(dist, kk)
    best_i = jnp.take_along_axis(rows, pk, axis=1).astype(jnp.int32)
    if kk < k:
        best_d = jnp.pad(best_d, ((0, 0), (0, k - kk)), constant_values=float(MASKED))
        best_i = jnp.pad(best_i, ((0, 0), (0, k - kk)))
    return best_d, best_i


# ------------------------------------------------------------------ fused program

def _cert_plan(*, certify, light, mixed, lossy_sweep, int8_sweep, use_resid,
               has_sweep_err, has_err1, metric):
    """Static certificate plan — the ONE source of truth for which error terms the
    proof carries (both the inline path and the snapshot-cached prep path build
    from this; see _prep_terms).

    Returns ``(wb_sources, q_tags, err_tags)``:
      * wb_sources: per-window bound arrays to build, each a name resolved by
        _prep_terms ("sweep_err" | "err1" | "sqn_sqrt").
      * q_tags: the per-query scale paired with each wb entry ("qh" -> |q_fold|,
        "qres" -> |q_fold - bf16(q_fold)|).
      * err_tags: scalar error composition beyond the f32 accumulation slack —
        "qres" adds the per-query residual norm (cosine folds the data norm away);
        ("rel", x) adds the worst-case elementwise band x * |qh| * maxd.
    """
    if not certify:
        return (), (), ()
    if not mixed:
        if lossy_sweep:
            # same-dtype lossy sweep: the only phase-1/rescan mismatch is the
            # query's own rounding — |qres . d| <= |qres| * ||d|| per window
            # (cosine: the norms cancel into a constant per-query shift)
            if metric == "cosine":
                return (), (), ("qres",)
            return ("sqn_sqrt",), ("qres",), ()
        return (), (), ()
    if light and (has_err1 or has_sweep_err):
        # LIGHT certified tier (single pass): RAW data band (err1 when the store
        # maintains residual arrays — its sweep_err is then the post-correction
        # band this tier does NOT earn), plus the uncompensated query rounding
        band = "err1" if has_err1 else "sweep_err"
        if metric == "cosine":
            return (band,), ("qh",), ("qres",)
        return (band, "sqn_sqrt"), ("qh", "qres"), ()
    if use_resid and has_sweep_err:
        # residual-corrected sweep: post-correction band (sweep_err, ~2^-8 of raw)
        # scaled by the FULL query + raw band (err1) scaled by the query residual
        # (the correction matmul used qh, not qh+qres)
        return ("sweep_err", "err1"), ("qh", "qres"), ()
    if has_sweep_err:
        return ("sweep_err",), ("qh",), ()
    rel = 2.0 ** -7 if int8_sweep else 2.0 ** -9
    if light:
        rel *= 2.0  # single pass: the query-side rounding is uncompensated too
    return (), (), (("rel", rel),)


def _prep_terms(valid, sq_norms, hw, rscale, rscale2, sweep_err, err1, *,
                cap, metric, masked, int8_sweep, bf_sweep, use_resid,
                wb_sources):
    """All QUERY-INDEPENDENT search prep: bias/scale rows in sweep column order,
    the residual-correction multiplier row, the live-max norm, and the certificate's
    per-window bound arrays.  They are whole-store permutes and reduces that only
    change when the SNAPSHOT changes, so exact_knn_pallas_t caches this dict per
    published DeviceState (prep_cache) and the fused program takes the arrays as
    inputs."""
    sqn = sq_norms.astype(jnp.float32)
    if masked:
        maskadd = jnp.where(valid, 0.0, MASKED).astype(jnp.float32)
    else:
        maskadd = jnp.where(jnp.arange(cap) < hw, 0.0, MASKED)
    bias = (sqn + maskadd) if metric == "l2" else maskadd
    bias_row = sweep_rows_1d(bias).reshape(1, cap)

    if metric == "cosine":
        sfac = jax.lax.rsqrt(jnp.maximum(sqn, 1e-30))
    else:
        sfac = None
    if int8_sweep:
        # fold the per-row dequant scale into the kernel's per-column multiplier
        sfac = rscale if sfac is None else rscale * sfac
    scale_row = sweep_rows_1d(sfac).reshape(1, cap) if sfac is not None else None

    if use_resid:
        # bf16 sweep: resid codes carry their own scale in ``rscale``.  int8 PRIMARY
        # sweep: ``rscale`` is the primary dequant scale s1 (folded into scale_row
        # above), so the kernel's correction multiplier must be the RATIO s2/s1 —
        # rank = (z1.q + (z2.q)*(s2/s1)) * s1 = s1*z1.q + s2*z2.q.  s1 == 0 only for
        # all-zero/unwritten rows, whose delta is zero too.
        kr = rscale if bf_sweep else jnp.where(rscale > 0, rscale2 / rscale, 0.0)
        rscale_row = sweep_rows_1d(kr).reshape(1, cap)
    else:
        rscale_row = None

    live = maskadd < 1.0
    maxd = jnp.sqrt(jnp.max(jnp.where(live, sqn, 0.0)))

    def eb_row(row_norms):
        """Per-row error norms -> a [1, cap] bound row in SWEEP COLUMN order,
        ready for phase 1's optimistic fold (_window_mins_xla's eb_rows)."""
        e = row_norms
        if metric == "cosine":
            e = e * jax.lax.rsqrt(jnp.maximum(sqn, 1e-30))
        e = jnp.where(live, e, 0.0)                       # dead rows rank as +inf anyway
        return sweep_rows_1d(e).reshape(1, cap).astype(jnp.float32)

    srcs = {"sqn_sqrt": lambda: jnp.sqrt(sqn),
            "sweep_err": lambda: sweep_err,
            "err1": lambda: err1}
    eb_rows = tuple(eb_row(srcs[s]()) for s in wb_sources)
    return {"bias_row": bias_row, "scale_row": scale_row, "rscale_row": rscale_row,
            "maxd": maxd, "eb_rows": eb_rows}


_prep_terms_jit = jax.jit(
    _prep_terms,
    static_argnames=("cap", "metric", "masked", "int8_sweep", "bf_sweep",
                     "use_resid", "wb_sources"),
)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "r1", "masked", "certify", "light",
                     "use_resid", "wb_sources", "q_tags", "err_tags", "impl"),
)
def _fused_t(
    q, data_t, rescan, valid, sq_norms, hw, sweep_err=None,
    resid=None, rscale=None, err1=None, rscale2=None, prep=None,
    *, k, metric, r1, masked, certify=True, light=False,
    use_resid=False, wb_sources=(), q_tags=(), err_tags=(), impl="xla",
):
    """The whole search — prep, sweep, selection, rescan — as ONE dispatched program.

    ``prep``: optional precomputed query-independent terms (_prep_terms) — the
    caller caches them per published snapshot; when None they trace inline (same
    program as before, for direct/sharded callers without a snapshot).
    ``impl``: phase 1's implementation (phase1_impl)."""
    Dp, cap = data_t.shape
    q32 = q.astype(jnp.float32)
    qn_row = jnp.sum(q32 * q32, axis=-1)

    bf_sweep = data_t.dtype == jnp.bfloat16
    int8_sweep = data_t.dtype == jnp.int8
    lossy_sweep = bf_sweep or int8_sweep
    if prep is None:
        prep = _prep_terms(
            valid, sq_norms, hw, rscale, rscale2, sweep_err, err1,
            cap=cap, metric=metric, masked=masked,
            int8_sweep=int8_sweep, bf_sweep=bf_sweep, use_resid=use_resid,
            wb_sources=wb_sources,
        )
    bias_row, scale_row, rscale_row = prep["bias_row"], prep["scale_row"], prep["rscale_row"]

    if metric == "l2":
        q_fold = -2.0 * q32
    else:  # ip/cosine: rank by -dots[/|d|] (+mask); 1/|q| is a per-query constant
        q_fold = -q32

    # compensated query for MIXED lossy sweeps: qh + qres represents q_fold to
    # ~2^-18 relative, so the certificate's query-rounding term vanishes.  int8
    # sweeps dot the bf16 query against bf16-cast codes (exact for integers <= 127).
    # SAME-dtype sweeps (bf16 store + mirror) skip the second pass and carry the
    # query-rounding term per window instead (see _cert_plan).
    mixed = (bf_sweep and rescan.dtype != data_t.dtype) or int8_sweep
    op_dtype = jnp.bfloat16 if int8_sweep else data_t.dtype
    qh = q_fold.astype(op_dtype)
    qres_f32 = q_fold - qh.astype(jnp.float32)
    # ``light``: single-pass certified tier — skip the query-compensation product AND
    # the residual stream; the certificate carries the uncompensated query-rounding
    # term + RAW data band per window (_cert_plan).  On benign corpora tier-1 still
    # certifies at one pass / no resid bytes; adversarial corpora escalate (speed,
    # never correctness) — the engine's adaptive dispatch then switches the
    # namespace to the heavy program (engine/query_processor._use_light).
    qres = qres_f32.astype(op_dtype) if (lossy_sweep and mixed and not light) else None

    P_all = cap // r1

    # tier-1 selection width: the margin above k must scale with k because
    # window-min quantile spacing tightens deeper into the distance distribution.
    # With per-window optimistic-bound selection, uncertain windows are pulled into
    # the rescan by construction, so the certified width carries no global error
    # allowance — except the worst-case-band plans, which widen.
    if not certify:
        s1_w = min(2 * k, k + 16)
    elif any(isinstance(t, tuple) for t in err_tags):
        s1_w = max(64, 2 * k + 48)  # worst-case global band: widen tier-1
    else:
        s1_w = min(2 * k, k + 16 + k // 8)
    s1_w = min(s1_w, P_all)
    # tier-2 (8x wider selection on the window-min matrix) only exists while its
    # gather traffic (B * s2 * r1 rows) stays under the exact scan's one-pass stream
    # (cap rows for ALL queries): beyond that crossover the wider selection is
    # slower than the fallback it delays, and its subgraph dominates the certified
    # program's compile time at large k.
    s2_w = min(8 * s1_w, P_all)
    tier2_exists = s2_w > s1_w and q.shape[0] * s2_w * r1 <= cap

    # -------- exactness certificate (a fixed selection margin is not a bound when
    # phase 1 ranks on rounded inputs).  Phase 1 emits OPTIMISTIC window-mins: each
    # column's rank is lowered by its own per-row data-side error bound scaled per
    # query, a sound lower bound on the window's true full-precision min rank.
    # Every fine window NOT rescanned has optimistic bound >= thresh, hence true min
    # rank >= thresh - slack: if that clears the k-th FOUND rank, no pruned window
    # can hold a closer row and the result is provably exact.  Failure escalates
    # per batch: a wider selection tier (reusing the same wmin — selection and
    # rescan only), then a full-precision exact scan.  Correctness never depends on
    # an empirical margin; the tiers only set how fast the common case is.  The
    # error-term composition is decided statically by _cert_plan
    # (wb_sources/q_tags/err_tags) and the per-row bound rows live in ``prep`` —
    # see _prep_terms for the terms themselves.
    q_l2 = jnp.sqrt(qn_row)                               # [B]
    qh_l2 = q_l2 * (2.0 if metric == "l2" else 1.0)       # |q_fold|
    maxd = prep["maxd"]
    # worst-case f32 accumulation: <= Dp * 2^-24 relative to |qh||d| per dot, on both
    # the phase-1 and rescan sides, whatever the summation order; 4x headroom (2^-22
    # covers Dp <= 512).  It holds only for true f32 products: f32 phase 1 and the
    # scan run at Precision.HIGHEST, and the rescan is elementwise.
    slack = (Dp * 2.0 ** -22) * qh_l2 * (1.0 if metric == "cosine" else maxd)
    qres_l2 = jnp.sqrt(jnp.sum(qres_f32 * qres_f32, axis=-1))
    q_scales = {"qh": qh_l2, "qres": qres_l2}
    eb_rows = tuple(prep["eb_rows"])
    qe = jnp.stack([q_scales[t] for t in q_tags], axis=1) if eb_rows else None
    err = slack
    for t in err_tags:
        if t == "qres":
            err = err + qres_l2
        else:  # ("rel", x): worst-case elementwise band; tier-1 widens to compensate
            err = err + t[1] * qh_l2 * (1.0 if metric == "cosine" else maxd)

    def check_exact(best_d, thresh, sel=None):
        # [Bq] bool; must not shadow the `certify` param.  ``sel`` [Bq] selects a
        # query sub-batch (the contained-escalation tier re-proves only the
        # queries whose tier-1 certificate failed).
        qn = qn_row if sel is None else qn_row[sel]
        ql = q_l2 if sel is None else q_l2[sel]
        e = err if sel is None else err[sel]
        kth = best_d[:, k - 1]
        if metric == "l2":
            kth_rank = kth - qn                           # dist = qn + rank
        elif metric == "ip":
            kth_rank = kth - 1.0                          # dist = 1 + rank
        else:
            kth_rank = (kth - 1.0) * ql                   # dist = 1 + rank/|q|
        kth_real = kth < float(MASKED) / 2
        # thresh == +inf: every window was rescanned — exact regardless of fill
        return jnp.where(kth_real, thresh - e >= kth_rank, jnp.isinf(thresh))

    wmin = _window_mins(
        qh, qres, data_t, resid if use_resid else None, rscale_row,
        scale_row, bias_row, impl=impl, r1=r1, qe=qe, eb_rows=eb_rows,
    )

    # the rescan's tombstone mask (masked variant only; the unmasked path uses the
    # arithmetic rows < hw tail mask, so prep needs no maskadd array at all)
    maskadd = jnp.where(valid, 0.0, MASKED).astype(jnp.float32) if masked else None

    def tier(s_sel):
        return _select_and_rescan(
            q32, qn_row[:, None], rescan, maskadd, hw, wmin,
            k=k, metric=metric, r1=r1, masked=masked, s_sel=s_sel, spec_l2=certify,
        )

    d1, i1, th1 = tier(s1_w)
    if not certify:
        # margin-based mode (EngineConfig.certify_exact=False): return the fast tier
        # unconditionally.  Exactness then rests on the empirical selection margin —
        # a documented speed/proof trade for corpora whose neighbour gaps sit below
        # the bf16 error band.
        return d1, i1, jnp.int32(0)

    def exact_fallback(_):
        # The terminal tier MUST be the scan backend: it is the results contract the
        # oracle tests pin set-exactly.  Wide tiles keep the scan's top_k fold count
        # small.
        d, i = exact_knn(q32, rescan, valid, sq_norms.astype(jnp.float32),
                         k=k, metric=metric, db_tile=8 * SWEEP_TILE)
        return d, i, jnp.int32(2)

    okq = check_exact(d1, th1)                            # [B] per-query proof
    ok1 = jnp.all(okq)

    if not tier2_exists:
        return jax.lax.cond(
            ok1, lambda _: (d1, i1, jnp.int32(0)), exact_fallback, operand=None
        )

    def tier2_or_exact(_):
        # selection+rescan only — the sweep is not repaid
        d2, i2, th2 = tier(s2_w)
        ok2 = jnp.all(check_exact(d2, th2))
        return jax.lax.cond(
            ok2, lambda _: (d2, i2, jnp.int32(1)), exact_fallback, operand=None
        )

    # CONTAINED escalation: the proof is per query, so one adversarial query in a
    # batch need not drag every query through tier 2 — when at most FQ_CONTAIN
    # certificates failed, re-select at tier-2 width for a fixed FQ-query sub-batch
    # only (window-min rows gathered per query; the rescan pays s2*r1 rows for FQ
    # queries instead of B).  Each re-proof is the same per-query certificate at
    # the wider threshold; any residual failure still falls through to the exact
    # scan.  Poisoned-batch cost is then tier-1 + an FQ/B-scale selection instead
    # of tier-1 + full tier-2.
    contain = q.shape[0] > FQ_CONTAIN

    def contained(_):
        fail = (~okq).astype(jnp.float32)
        _, fidx = jax.lax.top_k(fail, FQ_CONTAIN)         # failing first; rest pad
        d_f, i_f, th_f = _select_and_rescan(
            q32[fidx], qn_row[fidx][:, None], rescan, maskadd, hw, wmin[fidx],
            k=k, metric=metric, r1=r1, masked=masked, s_sel=s2_w, spec_l2=True,
        )
        ok_f = jnp.all(check_exact(d_f, th_f, sel=fidx))
        d_m = d1.at[fidx].set(d_f)
        i_m = i1.at[fidx].set(i_f)
        return jax.lax.cond(
            ok_f, lambda _: (d_m, i_m, jnp.int32(1)), exact_fallback, operand=None
        )

    def escalate(_):
        if not contain:
            return tier2_or_exact(None)
        nfail = jnp.sum(~okq)
        return jax.lax.cond(
            nfail <= FQ_CONTAIN, contained, tier2_or_exact, operand=None
        )

    return jax.lax.cond(
        ok1, lambda _: (d1, i1, jnp.int32(0)), escalate, operand=None
    )


# ------------------------------------------------------------------ public entry

def _pick_r1(batch: int, n_rows: int, k: int) -> int:
    """Window width: small k wants wide windows (small window-min matrix, the
    contiguous rescan makes wide windows nearly free); large k wants narrow windows
    (rescan payload is s1*r1 rows/query).  Floor by window-min matrix memory
    (B*N*4/r1 bytes must stay bounded).  The table was tuned on earlier hardware
    and is not yet measured on a GPU."""
    if k <= 16:
        r1 = 32
    elif k <= 128:
        r1 = 16
    elif k <= 256:
        r1 = 8
    else:
        r1 = 4
    while r1 < R1MAX and batch * n_rows * 4 // r1 > (1 << 31):  # cap wmin at 2 GB
        r1 *= 2
    return r1


def search_prep(
    batch: int,
    data_t: jax.Array,
    rescan_dtype,
    valid: jax.Array,
    sq_norms: jax.Array,
    *,
    k: int,
    metric: str,
    live_prefix: int | None,
    certify: bool = True,
    light: bool = False,
    sweep_err: jax.Array | None = None,
    resid: jax.Array | None = None,
    rscale: jax.Array | None = None,
    err1: jax.Array | None = None,
    rscale2: jax.Array | None = None,
    r1_override: int | None = None,
) -> dict:
    """The query-independent prep dict for one (batch, k, metric, config) search —
    exactly what exact_knn_pallas_t caches per snapshot.  Compute it EAGERLY and
    pass it via ``prep=`` (threading its arrays as arguments) when calling the
    entry under an outer trace, so the traced program matches the cached-prep
    program eager serving dispatches.  ``live_prefix=None`` builds the MASKED
    variant's prep (tombstones / metadata filters): ``valid`` must then be the
    same (filter-ANDed) mask the search call will pass."""
    Dp, cap = data_t.shape
    del batch, r1_override  # prep is r1-independent since the in-kernel bound fold
    bf_sweep = data_t.dtype == jnp.bfloat16
    int8_sweep = data_t.dtype == jnp.int8
    lossy_sweep = bf_sweep or int8_sweep
    mixed = (bf_sweep and rescan_dtype != data_t.dtype) or int8_sweep
    use_resid = (
        certify and not light
        and resid is not None and rscale is not None and err1 is not None
        and (bf_sweep or (int8_sweep and rscale2 is not None))
    )
    wb_sources, _, _ = _cert_plan(
        certify=certify, light=light, mixed=mixed, lossy_sweep=lossy_sweep,
        int8_sweep=int8_sweep, use_resid=use_resid,
        has_sweep_err=sweep_err is not None, has_err1=err1 is not None,
        metric=metric,
    )
    masked = live_prefix is None
    return _prep_terms_jit(
        valid, sq_norms, jnp.int32(cap if masked else live_prefix),
        rscale, rscale2, sweep_err, err1,
        cap=cap, metric=metric, masked=masked,
        int8_sweep=int8_sweep, bf_sweep=bf_sweep, use_resid=use_resid,
        wb_sources=wb_sources,
    )


def exact_knn_pallas_t(
    q: jax.Array,
    data_t: jax.Array,        # [Dp, cap] SWEEP-LAYOUT mirror (to_sweep_layout) — bf16 or f32
    rescan_data: jax.Array,   # [cap, Dp] row-major full-precision rows
    valid: jax.Array,
    sq_norms: jax.Array,
    *,
    k: int,
    metric: str,
    db_tile: int = SWEEP_TILE,   # kept for signature compat; the layout fixes the tile
    live_prefix: int | None = None,
    r1_override: int | None = None,
    sweep_err: jax.Array | None = None,
    resid: jax.Array | None = None,
    rscale: jax.Array | None = None,
    err1: jax.Array | None = None,
    rscale2: jax.Array | None = None,
    certify: bool = True,
    report_tier: bool = False,
    light: bool = False,
    prep_cache: dict | None = None,
    prep: dict | None = None,
    phase1: str | None = None,
):
    """Window-major sweep exact kNN; same results contract as ops.topk.exact_knn.

    ``phase1``: force phase 1's implementation ("xla" | "triton"); None = the
    platform's choice (phase1_impl).  Timing the two against each other is the
    only reason to force it.

    ``prep_cache``: optional per-SNAPSHOT dict (DeviceState.prep_cache).  The
    query-independent prep — bias/scale rows in sweep order, per-window error
    bounds, maxd — is whole-store work; with a cache it is computed once per
    published snapshot per (metric, plan) — r1-independent, since the bounds are
    per row — and fed to the fused program as inputs.
    The cache never populates under an outer trace (values would be tracers);
    traced callers who still want the cached-prep program pass ``prep`` (a dict
    from :func:`search_prep`) explicitly, threading its arrays as arguments.
    Only used on the unmasked (live_prefix) path: the masked variant's ``valid``
    is a per-query filter bitmap.

    ``report_tier``: additionally return a scalar int32 — which certificate tier
    served the batch: 0 = certified fast selection (margin mode always reports 0),
    1 = widened selection, 2 = full exact scan, -1 = fused path disengaged (the
    row-major scan served the query; no certificate ran).  Serving layers use it
    to expose escalation rates in /statistics and to adapt per-namespace dispatch.

    ``data_t`` MUST be in the window-major sweep layout (``to_sweep_layout``); the
    store maintains it incrementally via ``sweep_cols_for_rows`` scatters.  Falls back
    to the row-major scan for shapes the fused path does not cover.

    ``sweep_err``: [cap] f32 per-row data-side error norms for MIXED configs (f32
    rescan + bf16 sweep mirror) — feeds the exactness certificate's per-window
    bounds (see _fused_t).  Without the residual operands it is
    ``||row - bf16(row)||``; with them it is the residual quantizer's remaining
    error ``||delta - scale*z||``.

    ``resid``/``rscale``/``err1``: residual-corrected sweep (quantize_resid):
    [Dp, cap] int8 sweep-layout codes of delta = row - bf16(row), [cap] f32 per-row
    dequant scales, and [cap] f32 raw ``||delta||`` norms.  Phase 1 adds one product
    to recover qh . delta, shrinking the certified error band ~2^-8x so tier-1
    certifies even on tightly clustered corpora.

    ``rscale2``: for int8 PRIMARY sweeps (``data_t`` int8, quantize_int8_resid):
    ``rscale`` is the primary dequant scale s1 and ``rscale2`` the residual scale
    s2; ``resid`` then holds codes of delta1 = row - s1*z1 and ``sweep_err``/
    ``err1`` the two-level quantizer's error norms.  Two int8 streams at
    2 B/element total give a certified band comparable to bf16+resid's 3 B/element.
    """
    Dp, cap = data_t.shape
    B = q.shape[0]
    r1 = r1_override or _pick_r1(B, cap, k)
    if (
        cap < 2 * SWEEP_TILE
        or cap % SWEEP_TILE != 0
        or Dp % 128 != 0
        or k * r1 > cap
        or r1 not in (1, 2, 4, 8, 16, 32)
        or (data_t.dtype == jnp.int8 and rscale is None)  # codes need dequant scales
    ):
        d, i = exact_knn(q, rescan_data, valid, sq_norms, k=k, metric=metric, db_tile=db_tile)
        return (d, i, jnp.int32(-1)) if report_tier else (d, i)

    masked = live_prefix is None
    hw = jnp.int32(cap if masked else live_prefix)

    bf_sweep = data_t.dtype == jnp.bfloat16
    int8_sweep = data_t.dtype == jnp.int8
    lossy_sweep = bf_sweep or int8_sweep
    mixed = (bf_sweep and rescan_data.dtype != data_t.dtype) or int8_sweep
    # margin/light modes skip the residual stream: the extra matmul/bandwidth would
    # buy rank accuracy margin never proves and light deliberately forgoes
    use_resid = (
        certify and not light
        and resid is not None and rscale is not None and err1 is not None
        and (bf_sweep or (int8_sweep and rscale2 is not None))
    )
    wb_sources, q_tags, err_tags = _cert_plan(
        certify=certify, light=light, mixed=mixed, lossy_sweep=lossy_sweep,
        int8_sweep=int8_sweep, use_resid=use_resid,
        has_sweep_err=sweep_err is not None, has_err1=err1 is not None,
        metric=metric,
    )

    if (
        prep is None
        and prep_cache is not None
        # NEVER populate the cache from inside an outer trace (vmap/jit/fori_loop
        # around this entry): the computed rows would be tracers, and caching a
        # tracer leaks it out of its trace (UnexpectedTracerError on reuse).
        # Inside a trace the fused program simply traces prep inline — same
        # program it compiles for direct callers without a snapshot cache.
        and not isinstance(valid, jax.core.Tracer)
    ):
        # masked entries are valid ONLY while the caller's ``valid`` array is the
        # one the cache is scoped to: the snapshot dict is scoped to the
        # snapshot's own liveness mask, and the engine passes a per-(filter,
        # version) dict for filtered searches (FilterMaskCache.prep_cache_for)
        # NOTE: r1 is deliberately NOT in the key — prep is r1-independent since
        # the in-kernel bound fold (eb_rows are per-ROW, not per-window), so all
        # k-buckets of one (metric, config) share one prep dict entry.
        key = (metric, -1 if live_prefix is None else int(live_prefix),
               masked, certify, light, use_resid, wb_sources, str(data_t.dtype))
        prep = prep_cache.get(key)
        if prep is None:
            prep = _prep_terms_jit(
                valid, sq_norms, hw, rscale, rscale2, sweep_err, err1,
                cap=cap, metric=metric, masked=masked,
                int8_sweep=int8_sweep, bf_sweep=bf_sweep, use_resid=use_resid,
                wb_sources=wb_sources,
            )
            prep_cache[key] = prep  # GIL-atomic set; a racing reader just recomputes

    d, i, tier = _fused_t(
        q, data_t, rescan_data, valid, sq_norms, hw, sweep_err, resid, rscale, err1,
        rscale2, prep, k=k, metric=metric, r1=r1, masked=masked,
        certify=certify, light=light, use_resid=use_resid, wb_sources=wb_sources,
        q_tags=q_tags, err_tags=err_tags,
        impl=phase1 or phase1_impl(B, Dp, data_t.dtype),
    )
    return (d, i, tier) if report_tier else (d, i)
