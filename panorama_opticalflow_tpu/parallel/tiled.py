"""Row-tiled (sharded) stitch pipeline with halo exchange between devices.

The scaling design (SURVEY.md sections 2/5): the canvas and
every pyramid level are tiled into row blocks across a 1-D device mesh.
Rows -- not columns -- because the equirectangular canvas wraps in x
(360 degrees): keeping x whole per device makes the reference's wrap
extensions (CPU/OpticalFlow.cpp:113-126, CPU/StitchTool.cpp:102-111)
local concats, while the open (non-periodic) y boundary gives clean halo
exchange via ``ppermute``.

Structure (everything inside one shard_map / one jit):

* elementwise stages (map, overlap, combine weights) are trivially local;
* stencil stages (blurs, medians, relaxation) run on halo-extended tiles
  and crop the contaminated margin -- halo width is the stage's exact
  receptive radius, computed statically;
* resizes between pyramid levels gather source rows by *global* index
  from the halo-extended tile (per-level static plans);
* the blend/gather distance fields use the scan formulation of
  ops/distance.py: x-direction scans are row-local; y and diagonal scans
  run column-sharded over an all-gathered bitmask and return to row
  sharding with an all_to_all -- work-parallel and exact;
* pyramid levels too small to tile (local rows < threshold) are computed
  replicated from an all_gather: identical work on every device, a
  negligible fraction of total FLOPs (level sizes shrink by 0.9^2).

Known deviations from the untiled program, both confined and validated by
the tiled-vs-untiled SSIM/EPE tests: (a) global top/bottom boundary rows
of stencil stages see reflect-fill instead of each op's native border
mode; (b) flow sampling in the relaxation clamps to the halo extent, so
|flow_y| influence beyond the per-level halo is truncated.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from panorama_opticalflow_tpu.models import novel_view, pixflow, stitcher
from panorama_opticalflow_tpu.ops import image as im
from panorama_opticalflow_tpu.ops.distance import (
    _shear,
    _strided_first_hit_axis0,
    _strided_first_hit_x,
    _unshear,
    two_class_hole_search,
)
from panorama_opticalflow_tpu.utils.config import FlowParams, StitchConfig


def derive_level_halo(params: FlowParams, flow_sample_margin: int = 22) -> int:
    """Exact per-level receptive radius of patch_match_level's stencil
    chain, plus a margin for the flow-guided gradient sampling.

    Chain (models/pixflow.patch_match_level): Sobel ksize-1 (1) + gradient
    gaussian (gk//2) feeding every error eval; blurred-flow gaussian
    (bk//2) on the incoming flow; per phase, ``iters`` one-pixel
    propagations plus a 5x5 median (2); the final diffusion blur (bk//2).
    The only unbounded term is the warp's |flow_y| reach (clamped to the
    halo extent -- documented deviation (b) in the module docstring),
    covered by ``flow_sample_margin`` and gated by the tiled==untiled
    EPE/SSIM tests."""
    grad = 1 + params.gradient_blur_kernel_width // 2
    bk = params.blurred_flow_kernel_width // 2
    phases = params.relax_phases * (params.relax_iters_per_phase
                                    + params.median_blur_size // 2)
    return grad + bk + phases + bk + flow_sample_margin


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Static tiling knobs (jit-static).

    min_tiled_rows: levels whose local row count would drop below this
      are computed replicated (they are tiny: total work of all levels
      below any fixed size is a geometrically-vanishing fraction).
    level_halo: per-level halo; must cover derive_level_halo(params)
      (asserted by the tiled solvers).  The default covers the default
      FlowParams schedule (2 + 7 + 1*(3+2) + 7 = 21 hard radius) with
      27 rows of |flow_y| sampling margin.
    flow_mode: how the sharded flow solve is structured, chosen
      statically.  "hybrid" runs the per-level solver outside shard_map
      on halo-extended row-tile stacks under GSPMD, with the relax
      kernel partitioned over the tile batch dim by a one-kernel
      shard_map (parallel/hybrid.py, ops/pallas/partition.py).
      "shardmap" runs the whole pair stitch, flow solve included, inside
      one shard_map body.
    """

    min_tiled_rows: int = 48
    level_halo: int = 48
    flow_mode: str = "hybrid"

    @classmethod
    def for_params(cls, params: FlowParams, **kw) -> "TileConfig":
        return cls(level_halo=derive_level_halo(params), **kw)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _exchange_rows(x: jax.Array, halo: int, axis: str, fill: str | float = "reflect"
                   ) -> jax.Array:
    """Extend a local row tile by ``halo`` rows on each side with
    neighbours' edge rows; at the global top/bottom the halo is
    reflect-filled (approximating the ops' border modes) or constant.

    halo < local rows: one ppermute each way (the common, fine-level
    case).  halo >= local rows: the tile is small relative to the halo,
    so all_gather the (small) global array and slice -- same semantics.
    """
    if halo == 0:
        return x
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    h = x.shape[0]

    if halo >= h:
        full = jax.lax.all_gather(x, axis, axis=0, tiled=True)  # (n*h, ...)
        hg = full.shape[0]
        if fill == "reflect":
            r = min(halo, hg - 1)
            top_fill = full[1:r + 1][::-1]
            bot_fill = full[-r - 1:-1][::-1]
            if r < halo:  # beyond one reflection: edge-repeat
                top_fill = jnp.concatenate(
                    [jnp.repeat(full[-1:], halo - r, 0), top_fill], 0)
                bot_fill = jnp.concatenate(
                    [bot_fill, jnp.repeat(full[:1], halo - r, 0)], 0)
        else:
            top_fill = jnp.full((halo,) + full.shape[1:], fill, full.dtype)
            bot_fill = top_fill
        ext_full = jnp.concatenate([top_fill, full, bot_fill], axis=0)
        start = (idx * h,) + (0,) * (x.ndim - 1)
        return jax.lax.dynamic_slice(ext_full, start,
                                     (h + 2 * halo,) + x.shape[1:])

    top = jax.lax.ppermute(x[-halo:], axis, [(d, d + 1) for d in range(n - 1)])
    bot = jax.lax.ppermute(x[:halo], axis, [(d + 1, d) for d in range(n - 1)])
    if fill == "reflect":
        top_fill = x[1:halo + 1][::-1]
        bot_fill = x[-halo - 1:-1][::-1]
    else:
        top_fill = jnp.full_like(x[:halo], fill)
        bot_fill = jnp.full_like(x[:halo], fill)
    is_first = (idx == 0)
    is_last = (idx == n - 1)
    top = jnp.where(is_first, top_fill, top)
    bot = jnp.where(is_last, bot_fill, bot)
    return jnp.concatenate([top, x, bot], axis=0)


def _crop_rows(x: jax.Array, halo: int) -> jax.Array:
    return x[halo:x.shape[0] - halo] if halo else x


def _tiled_stencil(x: jax.Array, fn, radius: int, axis: str) -> jax.Array:
    """Run a local stencil op of receptive radius ``radius`` exactly on a
    row tile: halo-extend, apply, crop."""
    return _crop_rows(fn(_exchange_rows(x, radius, axis)), radius)


# ---------------------------------------------------------------------------
# Tiled resize along rows (global-index gather)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowResizePlan:
    """Static plan for a row-sharded axis-0 resize H_a -> H_b over n tiles."""

    h_a: int            # local rows held per device (ceil(H_a / n))
    h_b: int            # local output rows per device
    halo: int           # source halo needed
    idx: np.ndarray     # (n * h_b, K) global source rows (clamped)
    w: np.ndarray       # (n * h_b, K) weights


def make_row_resize_plan(h_from: int, h_to: int, n: int, method: str
                         ) -> RowResizePlan:
    idx, w = im._resize_axis_plan(h_from, h_to, method)
    h_a, h_b = _cdiv(h_from, n), _cdiv(h_to, n)
    # pad the plan to n*h_b rows (repeat last row; outputs there are pad)
    pad = n * h_b - h_to
    idx_p = np.concatenate([idx, np.repeat(idx[-1:], pad, 0)], 0)
    w_p = np.concatenate([w, np.repeat(w[-1:], pad, 0)], 0)
    halo = 0
    for d in range(n):
        rows = idx_p[d * h_b:(d + 1) * h_b]
        halo = max(halo, d * h_a - int(rows.min()),
                   int(rows.max()) - (d * h_a + h_a - 1))
    return RowResizePlan(h_a, h_b, max(halo, 0), idx_p, w_p)


def _tiled_resize_rows(x: jax.Array, plan: RowResizePlan, axis: str) -> jax.Array:
    """Axis-0 resize of a row tile using the static global-index plan.

    The K-tap plan is materialised as a banded matrix applied as one
    matmul (same trick as models.pixflow._plan_to_matrix) instead of a
    row gather.  Tap accumulation order is identical to the gather
    formulation, so
    weights and sums match bit-for-bit up to matmul reduction order."""
    d = jax.lax.axis_index(axis)
    ext = _exchange_rows(x, plan.halo, axis)
    k = plan.idx.shape[1]
    idx = jax.lax.dynamic_slice(
        jnp.asarray(plan.idx), (d * plan.h_b, 0), (plan.h_b, k))
    w = jax.lax.dynamic_slice(
        jnp.asarray(plan.w), (d * plan.h_b, 0), (plan.h_b, k))
    local = jnp.clip(idx - (d * plan.h_a - plan.halo), 0, ext.shape[0] - 1)
    r_iota = jax.lax.broadcasted_iota(jnp.int32, (plan.h_b, ext.shape[0]), 1)
    a = jnp.zeros((plan.h_b, ext.shape[0]), jnp.float32)
    for m in range(k):
        a = a + jnp.where(r_iota == local[:, m:m + 1],
                          w[:, m:m + 1].astype(jnp.float32), 0.0)
    flat = ext.astype(jnp.float32).reshape(ext.shape[0], -1)
    out = jnp.dot(a, flat, precision=jax.lax.Precision.HIGHEST)
    return out.reshape((plan.h_b,) + x.shape[1:])


def _tiled_resize_cols(x: jax.Array, out_w: int, method: str) -> jax.Array:
    """Column resize is row-local (x stays whole per device)."""
    return jnp.swapaxes(
        im._resize_axis0(jnp.swapaxes(x.astype(jnp.float32), 0, 1), out_w, method),
        0, 1)


# ---------------------------------------------------------------------------
# Distributed eight-ray distance field
# ---------------------------------------------------------------------------


def _sharded_strided_first_hit_axis0(mask: jax.Array, step: int,
                                     reverse: bool, axis: str) -> jax.Array:
    """Row-sharded twin of ops.distance._strided_first_hit_axis0.

    Each device scans its own rows locally on the stride-decimated view
    and exchanges only a per-device (step, W) class/column summary --
    the min (max for reverse) masked decimated position over its rows.
    The old formulation all_gathered the full global mask and
    column-sharded full-height scans: collective bytes AND scan work
    were per-device-constant in the canvas height; here both shrink
    ~n-fold, and the only collective is an all_gather of
    n * step * W summary floats.

    Decimation classes are GLOBAL (y mod step): local rows are placed
    at padded offset (d*h) mod step so the (blocks, step, W) reshape
    aligns classes across devices; positions are global decimated
    indices q = y // step, so cross-device combination is one masked
    min over gathered summaries.  Output: pixel distance (steps *
    ``step``) to the first True at-or-after (before, for reverse) each
    row in its class; +inf (-inf never escapes) where none.
    """
    n = jax.lax.axis_size(axis)
    d = jax.lax.axis_index(axis)
    h, w = mask.shape
    if step == 1:
        # degenerate stride: every row is its own class boundary-free
        # scan; fall through with step 1 (blocks == rows)
        pass
    hb = _cdiv(h + step, step) * step
    sh = (d * h) % step
    base_q = (d * h - sh) // step  # multiple-of-step global row / step

    buf = jnp.zeros((hb, w), bool)
    buf = jax.lax.dynamic_update_slice(buf, mask, (sh, 0))
    nb = hb // step
    mb = buf.reshape(nb, step, w)
    # global decimated position of block b on this device
    q_iota = (jax.lax.broadcasted_iota(jnp.int32, (nb, step, w), 0)
              + base_q).astype(jnp.float32)

    inf = jnp.float32(jnp.inf)
    if not reverse:
        pos = jnp.where(mb, q_iota, inf)
        local = jax.lax.associative_scan(jnp.minimum, pos, reverse=True,
                                         axis=0)
        summary = local[0]                                # (step, w)
        gath = jax.lax.all_gather(summary, axis, axis=0)  # (n, step, w)
        dev = jax.lax.broadcasted_iota(jnp.int32, gath.shape, 0)
        fut = jnp.min(jnp.where(dev > d, gath, inf), axis=0)
        best = jnp.minimum(local, fut[None])
        dist = (best - q_iota) * step
    else:
        pos = jnp.where(mb, q_iota, -inf)
        local = jax.lax.associative_scan(jnp.maximum, pos, axis=0)
        summary = local[-1]                               # (step, w)
        gath = jax.lax.all_gather(summary, axis, axis=0)
        dev = jax.lax.broadcasted_iota(jnp.int32, gath.shape, 0)
        past = jnp.max(jnp.where(dev < d, gath, -inf), axis=0)
        best = jnp.maximum(local, past[None])
        dist = (q_iota - best) * step
    out = dist.reshape(hb, w)
    return jax.lax.dynamic_slice(out, (sh, 0), (h, w))


def _tiled_eight_ray_multi(masks: list, step: int, max_i: float,
                           diag_scale: float, axis: str,
                           h_global: int) -> list:
    """Distributed version of ops.distance.eight_ray_min_distance for M
    row-sharded boolean masks ((h_local, W) each, global rows =
    n * h_local with possible dead pad rows at the bottom; pad rows must
    be False).  Returns a list of M distance fields.

    x scans are row-local.  y and diagonal scans use the summary-
    exchange scan (_sharded_strided_first_hit_axis0): shears are
    row-local (a row's shear shift depends only on its global index), so
    no full-canvas gather or all_to_all remains -- per-device work and
    collective bytes now shrink with the mesh instead of staying
    canvas-sized.  The M masks are column-concatenated so each scan
    direction runs once.  Semantics identical to the untiled op,
    including the reference's row-0/col-0 exclusions for negative
    directions.
    """
    n = jax.lax.axis_size(axis)
    d = jax.lax.axis_index(axis)
    h, w = masks[0].shape
    hp = h * n  # padded global rows
    m = len(masks)

    inf = jnp.float32(jnp.inf)

    def keep(dist):
        return jnp.where(dist < max_i, dist, inf)

    # ---- straight x (row-local, per mask) ----
    d_x = []
    for mask in masks:
        no_col0 = mask.at[:, 0].set(False)
        d_xp = keep(_strided_first_hit_x(mask, step, reverse=False))
        d_xm = keep(_strided_first_hit_x(no_col0, step, reverse=True))
        d_x.append(jnp.minimum(d_xp, d_xm))

    # global row-0 / col-0 exclusion masks on LOCAL tiles
    g_rows = jnp.arange(h)[:, None] + d * h
    row0 = g_rows == 0
    col0 = jnp.arange(w)[None, :] == 0

    def scan_cat(parts, reverse):
        """One summary-exchange scan over column-concatenated masks."""
        return _sharded_strided_first_hit_axis0(
            jnp.concatenate(parts, axis=1), step, reverse, axis)

    # ---- straight y (one batched scan per direction) ----
    cat = masks
    cat_nr0 = [jnp.where(row0, False, f) for f in masks]
    yp_cat = scan_cat(cat, False)
    ym_cat = scan_cat(cat_nr0, True)

    # ---- diagonals (shear row-locally, scan batched) ----
    sq2 = diag_scale
    ws = w + hp - 1

    def shear(mask, sign):
        return _shear(mask, sign, row_offset=d * h, total_h=hp)

    def unshear(dist_rows, sign):
        return _unshear(dist_rows, sign, w, row_offset=d * h, total_h=hp)

    sh_pp, sh_pp_ex, sh_pm, sh_pm_ex = [], [], [], []
    for full in masks:
        f_nr0 = jnp.where(row0, False, full)
        f_nc0 = jnp.where(col0, False, full)
        f_nb = jnp.where(col0, False, f_nr0)
        sh_pp.append(shear(full, +1))     # conserves x - y: (+1,+1) down
        sh_pp_ex.append(shear(f_nb, +1))  # (-1,-1) up
        sh_pm.append(shear(f_nc0, -1))    # conserves x + y: (+1,-1) down
        sh_pm_ex.append(shear(f_nr0, -1))  # (-1,+1) up

    dr_cat = scan_cat(sh_pp, False)
    ul_cat = scan_cat(sh_pp_ex, True)
    dl_cat = scan_cat(sh_pm, False)
    ur_cat = scan_cat(sh_pm_ex, True)

    outs = []
    for k in range(m):
        out = jnp.minimum(
            d_x[k],
            jnp.minimum(keep(yp_cat[:, k * w:(k + 1) * w]),
                        keep(ym_cat[:, k * w:(k + 1) * w])))
        for cat_d, sign in ((dr_cat, +1), (ul_cat, +1),
                            (dl_cat, -1), (ur_cat, -1)):
            dist = keep(cat_d[:, k * ws:(k + 1) * ws])
            out = jnp.minimum(out, unshear(dist, sign) * sq2)
        outs.append(out)
    return outs


def _tiled_eight_ray(mask: jax.Array, step: int, max_i: float,
                     diag_scale: float, axis: str, h_global: int) -> jax.Array:
    """Single-mask convenience wrapper over _tiled_eight_ray_multi."""
    return _tiled_eight_ray_multi([mask], step, max_i, diag_scale, axis,
                                  h_global)[0]


# ---------------------------------------------------------------------------
# Tiled pixflow
# ---------------------------------------------------------------------------


def _tiled_gaussian_blur(x, ksize, sigma, axis):
    return _tiled_stencil(x, lambda e: im.gaussian_blur(e, ksize, sigma),
                          ksize // 2, axis)


def _build_tiled_pyramid(img, sizes, tiled_level, n, axis, dh):
    """Finest->coarsest pyramid of a row-tiled plane; levels too small to
    tile are replicated from an all_gather (the transition happens
    once)."""
    if not tiled_level[0]:
        # even the base level is too small to tile: replicate throughout
        img = jax.lax.all_gather(img, axis, axis=0, tiled=True)[:dh]
        pyr = [img]
        for k in range(1, len(sizes)):
            pyr.append(im.resize(pyr[-1], sizes[k], "linear"))
        return pyr
    pyr = [img]
    replicated = False
    for k in range(1, len(sizes)):
        prev = pyr[-1]
        (ph, _), (nh, nw) = sizes[k - 1], sizes[k]
        if not replicated and tiled_level[k]:
            plan = make_row_resize_plan(ph, nh, n, "linear")
            cur = _tiled_resize_cols(_tiled_resize_rows(prev, plan, axis),
                                     nw, "linear")
        else:
            if not replicated:  # transition: gather previous level
                prev = jax.lax.all_gather(prev, axis, axis=0,
                                          tiled=True)[:ph]
                replicated = True
            cur = im.resize(prev, (nh, nw), "linear")
        pyr.append(cur)
    return pyr


def _upsample_replicated(flow, level, *, sizes, tiled_level, n, axis,
                         params):
    """Post-level cubic upsample of a replicated flow toward level - 1,
    slicing this device's rows when the next level is tiled."""
    nh, nw = sizes[level - 1]
    up = im.resize(flow, (nh, nw), "cubic") * (1.0 / params.pyr_scale_factor)
    if tiled_level[level - 1]:
        hb = _cdiv(nh, n)
        up = jnp.pad(up, ((0, n * hb - nh), (0, 0), (0, 0)))
        d = jax.lax.axis_index(axis)
        up = jax.lax.dynamic_slice(up, (d * hb, 0, 0),
                                   (hb, nw, up.shape[-1]))
    return up


def tiled_compute_optical_flow(
    rgba0: jax.Array, rgba1: jax.Array, params: FlowParams, hint: str,
    axis: str, n: int, h_global: int, tc: TileConfig = TileConfig(),
) -> jax.Array:
    """Row-tiled pixflow solver; local tiles are (h_local, W', 4) uint8.

    Mirrors models.pixflow.compute_optical_flow level by level; each level
    is either tiled (halo-exchange + local patch_match_level + crop) or,
    when too small, computed replicated from an all_gather.
    """
    h_loc, w = rgba0.shape[:2]
    assert h_loc * n >= h_global
    assert tc.level_halo >= derive_level_halo(params, flow_sample_margin=0), \
        (tc.level_halo, derive_level_halo(params, flow_sample_margin=0))
    dh = int(h_global * params.downscale_factor)
    dw = int(w * params.downscale_factor)

    plan_ds = make_row_resize_plan(h_global, dh, n, "cubic")
    r0 = _tiled_resize_cols(_tiled_resize_rows(rgba0.astype(jnp.float32),
                                               plan_ds, axis), dw, "cubic")
    r1 = _tiled_resize_cols(_tiled_resize_rows(rgba1.astype(jnp.float32),
                                               plan_ds, axis), dw, "cubic")
    r0 = jnp.clip(jnp.rint(r0), 0, 255).astype(jnp.uint8)
    r1 = jnp.clip(jnp.rint(r1), 0, 255).astype(jnp.uint8)

    def gray_alpha(r):
        i = im.rgba_to_gray_u8(r).astype(jnp.float32) / 255.0
        a = r[..., 3].astype(jnp.float32) / 255.0
        return i, a

    i0, a0 = gray_alpha(r0)
    i1, a1 = gray_alpha(r1)
    i0 = _tiled_gaussian_blur(i0, params.pre_blur_kernel_width,
                              params.pre_blur_sigma, axis)
    i1 = _tiled_gaussian_blur(i1, params.pre_blur_kernel_width,
                              params.pre_blur_sigma, axis)

    sizes = pixflow.pyramid_sizes(dh, dw, params)
    # a level is tiled only when the local tile exceeds both the minimum
    # and the halo (single-hop neighbour exchange)
    tiled_level = [sizes[k][0] // n >= max(tc.min_tiled_rows,
                                           tc.level_halo + 1)
                   for k in range(len(sizes))]

    # ---- build pyramids (finest -> coarsest) ----
    build = partial(_build_tiled_pyramid, sizes=sizes,
                    tiled_level=tiled_level, n=n, axis=axis, dh=dh)
    p_i0, p_i1 = build(i0), build(i1)
    p_a0, p_a1 = build(a0), build(a1)

    upsample_rep = partial(_upsample_replicated, sizes=sizes,
                           tiled_level=tiled_level, n=n, axis=axis,
                           params=params)

    # rung-scan the replicated coarse suffix (same compile-time
    # restructure as models.pixflow; tiled levels cannot be scanned)
    r0 = next((k for k in range(len(sizes)) if not tiled_level[k]),
              len(sizes))
    first_scanned, rungs = pixflow._plan_rungs(sizes, params, lo=r0)

    # ---- coarse -> fine ----
    flow = None
    start = len(sizes) - 1
    if rungs:
        nl = len(sizes)
        flow = pixflow.patch_match_level(
            p_i0[nl - 1], p_i1[nl - 1], p_a0[nl - 1], p_a1[nl - 1],
            None, hint, params)

        def rbody(imgs_i, alphas_i, f):
            return pixflow.patch_match_level(imgs_i[0], imgs_i[1],
                                             alphas_i[0], alphas_i[1],
                                             f, hint, params)

        flow = pixflow._run_rungs(rungs, sizes, [p_i0, p_i1],
                                  [p_a0, p_a1], flow, rbody, params)
        flow = upsample_rep(flow, first_scanned)
        start = first_scanned - 1
    for level in range(start, -1, -1):
        lh, lw = sizes[level]
        if not tiled_level[level]:
            flow = pixflow.patch_match_level(
                p_i0[level], p_i1[level], p_a0[level], p_a1[level],
                flow, hint, params)
            if level > 0:
                flow = upsample_rep(flow, level)
        else:
            halo = tc.level_halo
            ex = partial(_exchange_rows, halo=halo, axis=axis)
            args = [ex(p_i0[level]), ex(p_i1[level]),
                    ex(p_a0[level]), ex(p_a1[level])]
            f_ext = None if flow is None else ex(flow)
            f_ext = pixflow.patch_match_level(*args, f_ext, hint, params)
            flow = _crop_rows(f_ext, halo)
            if level > 0:
                nh, nw = sizes[level - 1]
                plan = make_row_resize_plan(lh, nh, n, "cubic")
                flow = _tiled_resize_cols(_tiled_resize_rows(flow, plan, axis),
                                          nw, "cubic") \
                    * (1.0 / params.pyr_scale_factor)

    # ---- final upsample to input size ----
    if not tiled_level[0]:
        # whole pyramid was replicated; slice rows back to tiles
        hb = _cdiv(dh, n)
        flow = jnp.pad(flow, ((0, n * hb - dh), (0, 0), (0, 0)))
        d = jax.lax.axis_index(axis)
        flow = jax.lax.dynamic_slice(flow, (d * hb, 0, 0), (hb, dw, 2))
    plan_up = make_row_resize_plan(dh, h_global, n, "linear")
    flow = _tiled_resize_cols(_tiled_resize_rows(flow, plan_up, axis),
                              w, "linear")
    flow = flow * (1.0 / params.downscale_factor)
    flow = _tiled_gaussian_blur(flow, params.final_flow_blur_kernel_width,
                                params.final_flow_blur_sigma, axis)
    return flow


def tiled_compute_optical_flow_pair(
    rgba0: jax.Array, rgba1: jax.Array, params: FlowParams,
    hints: tuple[str, str], axis: str, n: int, h_global: int,
    tc: TileConfig = TileConfig(),
) -> tuple[jax.Array, jax.Array]:
    """Direction-batched row-tiled pixflow (the sharded twin of
    models.pixflow.compute_optical_flow_pair): both directions of a pair
    share one set of tiled pyramids and halo exchanges, and every level
    runs as one batched program.  Flow rides through the tiled resize /
    blur helpers in a (h, w, 4) channel layout
    ``[f01x, f01y, f10x, f10y]``; returns (flow01, flow10) local tiles.
    """
    h_loc, w = rgba0.shape[:2]
    assert h_loc * n >= h_global
    assert tc.level_halo >= derive_level_halo(params, flow_sample_margin=0), \
        (tc.level_halo, derive_level_halo(params, flow_sample_margin=0))
    dh = int(h_global * params.downscale_factor)
    dw = int(w * params.downscale_factor)

    plan_ds = make_row_resize_plan(h_global, dh, n, "cubic")

    def prep(rgba):
        r = _tiled_resize_cols(_tiled_resize_rows(rgba.astype(jnp.float32),
                                                  plan_ds, axis), dw, "cubic")
        r = jnp.clip(jnp.rint(r), 0, 255).astype(jnp.uint8)
        i = im.rgba_to_gray_u8(r).astype(jnp.float32) / 255.0
        a = r[..., 3].astype(jnp.float32) / 255.0
        i = _tiled_gaussian_blur(i, params.pre_blur_kernel_width,
                                 params.pre_blur_sigma, axis)
        return i, a

    i0, a0 = prep(rgba0)
    i1, a1 = prep(rgba1)

    sizes = pixflow.pyramid_sizes(dh, dw, params)
    tiled_level = [sizes[k][0] // n >= max(tc.min_tiled_rows,
                                           tc.level_halo + 1)
                   for k in range(len(sizes))]
    build = partial(_build_tiled_pyramid, sizes=sizes,
                    tiled_level=tiled_level, n=n, axis=axis, dh=dh)
    p_i0, p_i1 = build(i0), build(i1)
    p_a0, p_a1 = build(a0), build(a1)

    def to_b(fc):   # (h, w, 4) channels -> (2, h, w, 2) batch
        return jnp.stack([fc[..., :2], fc[..., 2:]], axis=0)

    def to_c(fb):   # inverse
        return jnp.concatenate([fb[0], fb[1]], axis=-1)

    upsample_rep = partial(_upsample_replicated, sizes=sizes,
                           tiled_level=tiled_level, n=n, axis=axis,
                           params=params)
    r0 = next((k for k in range(len(sizes)) if not tiled_level[k]),
              len(sizes))
    first_scanned, rungs = pixflow._plan_rungs(sizes, params, lo=r0)

    flow_c = None
    start = len(sizes) - 1
    if rungs:
        nl = len(sizes)
        fb = pixflow.patch_match_level_batched(
            jnp.stack([p_i0[nl - 1], p_i1[nl - 1]]),
            jnp.stack([p_a0[nl - 1], p_a1[nl - 1]]), None, hints, params)

        def rbody(imgs_i, alphas_i, f):
            return pixflow.patch_match_level_batched(imgs_i, alphas_i, f,
                                                     hints, params)

        fb = pixflow._run_rungs(rungs, sizes, [p_i0, p_i1], [p_a0, p_a1],
                                fb, rbody, params)
        flow_c = upsample_rep(to_c(fb), first_scanned)
        start = first_scanned - 1
    for level in range(start, -1, -1):
        lh, lw = sizes[level]
        if not tiled_level[level]:
            imgs = jnp.stack([p_i0[level], p_i1[level]])
            alphas = jnp.stack([p_a0[level], p_a1[level]])
            fb = None if flow_c is None else to_b(flow_c)
            flow_c = to_c(pixflow.patch_match_level_batched(
                imgs, alphas, fb, hints, params))
            if level > 0:
                flow_c = upsample_rep(flow_c, level)
        else:
            halo = tc.level_halo
            ex = partial(_exchange_rows, halo=halo, axis=axis)
            imgs = jnp.stack([ex(p_i0[level]), ex(p_i1[level])])
            alphas = jnp.stack([ex(p_a0[level]), ex(p_a1[level])])
            fb = None if flow_c is None else to_b(ex(flow_c))
            fb = pixflow.patch_match_level_batched(imgs, alphas, fb, hints,
                                                   params)
            flow_c = _crop_rows(to_c(fb), halo)
            if level > 0:
                nh, nw = sizes[level - 1]
                plan = make_row_resize_plan(lh, nh, n, "cubic")
                flow_c = _tiled_resize_cols(
                    _tiled_resize_rows(flow_c, plan, axis), nw, "cubic") \
                    * (1.0 / params.pyr_scale_factor)

    if not tiled_level[0]:
        hb = _cdiv(dh, n)
        flow_c = jnp.pad(flow_c, ((0, n * hb - dh), (0, 0), (0, 0)))
        d = jax.lax.axis_index(axis)
        flow_c = jax.lax.dynamic_slice(flow_c, (d * hb, 0, 0), (hb, dw, 4))
    plan_up = make_row_resize_plan(dh, h_global, n, "linear")
    flow_c = _tiled_resize_cols(_tiled_resize_rows(flow_c, plan_up, axis),
                                w, "linear")
    flow_c = flow_c * (1.0 / params.downscale_factor)
    flow_c = _tiled_gaussian_blur(flow_c, params.final_flow_blur_kernel_width,
                                  params.final_flow_blur_sigma, axis)
    return flow_c[..., :2], flow_c[..., 2:]


# ---------------------------------------------------------------------------
# Tiled stitch pipeline
# ---------------------------------------------------------------------------


def _tiled_generate_blend(canvas_map: jax.Array, cfg: StitchConfig,
                          axis: str, n: int, h_global: int,
                          window: tuple | None = None):
    """Row-tiled stitcher.generate_blend.

    ``window`` is an optional (roll, width) column window (roll may be a
    traced scalar; width is static): the field is computed on the rolled
    slice only, mirroring the single-chip windowed blend (same SSIM-gated
    approximation, stitcher.generate_blend docstring) -- x stays whole
    per device, so the roll+slice is row-local.  Returns (blend,
    merged_dis) of width ``width`` when windowed.
    """
    h_loc, w = canvas_map.shape
    step = max(1, min(h_global, w) // cfg.blend_step_div)
    max_i = w / 2.0

    g_rows = jnp.arange(h_loc)[:, None] + jax.lax.axis_index(axis) * h_loc
    live = g_rows < h_global  # guard pad rows

    windowed = window is not None and window[1] < w
    if windowed:
        roll, width = window
        center = jnp.roll(canvas_map, -roll, axis=1)[:, :width]
        d_l, d_r = _tiled_eight_ray_multi(
            [(center == 100) & live, (center == 50) & live],
            step, max_i, math.sqrt(2.0), axis, h_global)
        out_w = width
    else:
        length = w // cfg.blend_extend_div
        ext = im.wrap_extend_x(canvas_map, length)  # local: x is whole
        d_l, d_r = _tiled_eight_ray_multi(
            [(ext == 100) & live, (ext == 50) & live],
            step, max_i, math.sqrt(2.0), axis, h_global)
        d_l = im.crop_x(d_l, length)
        d_r = im.crop_x(d_r, length)
        center = canvas_map
        out_w = w

    none_val = jnp.float32(10.0 * w)
    d_l = jnp.where(jnp.isinf(d_l), none_val, d_l)
    d_r = jnp.where(jnp.isinf(d_r), none_val, d_r)
    counted = d_l / (d_l + d_r)
    merged_dis = jnp.minimum(d_l, d_r)

    blend = jnp.where(center == 100, 0.0,
                      jnp.where(center == 50, 1.0,
                                jnp.where(center == 150, counted, 0.5)))
    merged_dis = jnp.where(center == 150, merged_dis, 0.0)

    k_sel = h_global // cfg.blend_smooth_kernel_div
    if k_sel >= 2:
        blurred = _tiled_stencil(
            blend, lambda e: im.box_blur(e, k_sel, k_sel), k_sel, axis)
        # selection grid from global block top-left pixels: sample the
        # local grid rows, all_gather, and rebuild the global grid
        hq, wq = h_global // step, out_w // step
        d_idx = jax.lax.axis_index(axis)
        rows = jnp.arange(0, h_loc, step)
        sel_rows = merged_dis[rows[:, None], jnp.arange(0, wq * step, step)[None, :]]
        # rows global ids
        sel_rows_gid = rows[:, None] + d_idx * h_loc
        # all_gather both and rebuild the global grid on each device
        all_sel = jax.lax.all_gather(sel_rows, axis, axis=0, tiled=True)
        all_gid = jax.lax.all_gather(sel_rows_gid, axis, axis=0, tiled=True)
        # scatter into (hq, wq): only rows where gid % step == 0 are valid
        grid = jnp.zeros((hq, wq), jnp.float32)
        valid = (all_gid[:, 0] % step == 0) & (all_gid[:, 0] // step < hq)
        tgt = jnp.clip(all_gid[:, 0] // step, 0, hq - 1)
        grid = grid.at[tgt].set(jnp.where(valid[:, None], all_sel, 0.0),
                                mode="drop")
        sel = grid > step
        qy_ok = jnp.arange(hq) * step + step < h_global
        if windowed:
            gx = (jnp.arange(wq) * step + window[0]) % w
            qx_ok = gx + step < w
        else:
            qx_ok = jnp.arange(wq) * step + step < w
        sel = sel & qy_ok[:, None] & qx_ok[None, :]
        # expand to pixels, slice my rows
        sel_up = jnp.repeat(jnp.repeat(sel, step, axis=0), step, axis=1)
        sel_full = jnp.zeros((n * h_loc, out_w), bool)
        sel_full = sel_full.at[: hq * step, : wq * step].set(sel_up)
        my_sel = jax.lax.dynamic_slice(sel_full, (d_idx * h_loc, 0),
                                       (h_loc, out_w))
        blend = jnp.where(my_sel, blurred, blend)

    k_glob = h_global // cfg.blend_global_blur_div
    if k_glob >= 2:
        blend = _tiled_stencil(
            blend, lambda e: im.box_blur(e, k_glob, k_glob), k_glob, axis)
    return blend.astype(jnp.float32), merged_dis


def _tiled_combine(ol, orr, flr, frl, blend, axis, tc: TileConfig):
    """Row-tiled novel_view.combine_novel_views: vertical sampling reaches
    +-|t*flow_y| rows; halo-extend all inputs, combine, crop."""
    halo = tc.level_halo
    args = [_exchange_rows(a, halo, axis) for a in (ol, orr, flr, frl, blend)]
    out = novel_view.combine_novel_views(*args)
    return _crop_rows(out, halo)


def _tiled_gather(canvas_map, image_l, image_r, merged, cfg, axis, h_global,
                  window: tuple | None = None):
    """Row-tiled stitcher.gather_composite: rays reach at most
    gather_search_radius - 1 rows -> halo exchange with an invalid-code
    fill, global row-0 exclusion applied by global index.

    ``window`` is an optional (roll, width) column window; when the
    caller verified crop.gather_window_safe the hole search runs on the
    window slice bit-identically (rays are radius-bounded), row-local."""
    r = cfg.gather_search_radius
    merged_a = im.threshold_binary(merged[..., 3], 0, 75)
    code = canvas_map + merged_a

    h_loc, w = code.shape
    d = jax.lax.axis_index(axis)
    g_rows = jnp.arange(h_loc)[:, None] + d * h_loc
    live = g_rows < h_global
    code_l = jnp.where(live, code, 255)

    def hole_from(codes, img_l, img_r):
        ext = _exchange_rows(codes, r, axis, fill=255)
        # reference boundary semantics: GLOBAL row 0 invisible to -y rays
        # (local col 0 is global col 0, the helper's default)
        g_rows_ext = jnp.arange(-r, h_loc + r)[:, None] + d * h_loc
        row0 = jnp.broadcast_to(g_rows_ext == 0, ext.shape)
        found, take_l = two_class_hole_search(ext == 100, ext == 50, r,
                                              row0_excluded=row0)
        found = _crop_rows(found, r)
        take_l = _crop_rows(take_l, r)
        hole_black = jnp.array([0, 0, 0, 255], jnp.uint8)
        return jnp.where(found[..., None],
                         jnp.where(take_l[..., None], img_l, img_r),
                         hole_black)

    if window is None:
        hole = hole_from(code_l, image_l, image_r)
    else:
        roll, width = window

        def win(a):
            return jnp.roll(a, -roll, axis=1)[:, :width]

        hole_w = hole_from(win(code_l), win(image_l), win(image_r))
        hole = jnp.zeros((h_loc, w, 4), jnp.uint8)
        hole = jax.lax.dynamic_update_slice(hole, hole_w, (0, 0, 0))
        hole = jnp.roll(hole, roll, axis=1)

    zero = jnp.zeros((4,), jnp.uint8)
    out = jnp.where((code == 100)[..., None], image_l, zero)
    out = jnp.where((code == 50)[..., None], image_r, out)
    is_merged = (code == 225) | (code == 175) | (code == 125)
    out = jnp.where(is_merged[..., None], merged, out)
    out = jnp.where((code == 150)[..., None], hole, out)
    return out


def _tiled_stitch_pair_body(image_l, image_r, roll=None, *,
                            cfg: StitchConfig, axis: str,
                            n: int, h_global: int,
                            tc: TileConfig = TileConfig(),
                            width: int | None = None,
                            gather_windowed: bool = False):
    """Local (per-shard) body of the tiled stitch.

    With ``width`` (static) and ``roll`` (replicated traced scalar) the
    flow/blend/combine stages run on the planned overlap column window
    only -- the same work-saving the single-chip stitch_pair_auto path
    uses (models/crop.py); x stays whole per device so every roll+slice
    is row-local.  ``gather_windowed`` additionally windows the hole
    search (caller checked crop.gather_window_safe).
    """
    canvas_map = stitcher.match_images(image_l, image_r)
    ol = stitcher.extract_overlap(image_l, canvas_map)
    orr = stitcher.extract_overlap(image_r, canvas_map)
    h_loc, w = canvas_map.shape
    params = cfg.flow_params

    windowed = width is not None and width < w
    if windowed:
        def win(a):
            return jnp.roll(a, -roll, axis=1)[:, :width]

        blend_w, _ = _tiled_generate_blend(canvas_map, cfg, axis, n,
                                           h_global, window=(roll, width))
        # window already covers overlap + margin + cols/20 extension
        # (crop._window_from_cols): solve flow directly on the slice,
        # exactly like the single-chip crop.cropped_flows_window
        flr_w, frl_w = tiled_compute_optical_flow_pair(
            win(ol), win(orr), params, ("left", "right"),
            axis, n, h_global, tc)
        merged_w = _tiled_combine(win(ol), win(orr), flr_w, frl_w,
                                  blend_w, axis, tc)
        merged = jnp.zeros((h_loc, w, 4), jnp.uint8)
        merged = jax.lax.dynamic_update_slice(merged, merged_w, (0, 0, 0))
        merged = jnp.roll(merged, roll, axis=1)
        gw = (roll, width) if gather_windowed else None
        return _tiled_gather(canvas_map, image_l, image_r, merged, cfg,
                             axis, h_global, window=gw)

    blend, _ = _tiled_generate_blend(canvas_map, cfg, axis, n, h_global)
    length = w // cfg.flow_extend_div
    ext_l = im.wrap_extend_x(ol, length)
    ext_r = im.wrap_extend_x(orr, length)
    flr, frl = tiled_compute_optical_flow_pair(
        ext_l, ext_r, params, ("left", "right"), axis, n, h_global, tc)
    flr = im.crop_x(flr, length)
    frl = im.crop_x(frl, length)

    merged = _tiled_combine(ol, orr, flr, frl, blend, axis, tc)
    return _tiled_gather(canvas_map, image_l, image_r, merged, cfg,
                         axis, h_global)


# ---------------------------------------------------------------------------
# Hybrid stitch segments (flow solved OUTSIDE shard_map, see
# parallel/hybrid.py): the per-pair stitch splits into a pre-flow
# shard_map segment (map/overlap/blend), the hybrid flow solve, and a
# post-flow shard_map segment (combine/gather).
# ---------------------------------------------------------------------------


def _pre_flow_body(image_l, image_r, roll=None, *, cfg: StitchConfig,
                   axis: str, n: int, h_global: int,
                   width: int | None = None):
    """Pre-flow shard_map segment: canvas map, overlap extraction and
    the blend field.  Returns (flow_in_l, flow_in_r, blend): the flow
    solver's inputs are the windowed overlaps (windowed path) or the
    wrap-extended overlaps (full path, extension cropped off the flows
    in the post segment)."""
    canvas_map = stitcher.match_images(image_l, image_r)
    ol = stitcher.extract_overlap(image_l, canvas_map)
    orr = stitcher.extract_overlap(image_r, canvas_map)
    w = canvas_map.shape[1]
    if width is not None and width < w:
        def win(a):
            return jnp.roll(a, -roll, axis=1)[:, :width]

        blend_w, _ = _tiled_generate_blend(canvas_map, cfg, axis, n,
                                           h_global, window=(roll, width))
        return win(ol), win(orr), blend_w
    blend, _ = _tiled_generate_blend(canvas_map, cfg, axis, n, h_global)
    length = w // cfg.flow_extend_div
    return (im.wrap_extend_x(ol, length), im.wrap_extend_x(orr, length),
            blend)


def _post_flow_body(image_l, image_r, fl, fr, flr, frl, blend, roll=None, *,
                    cfg: StitchConfig, axis: str, h_global: int,
                    tc: "TileConfig", width: int | None = None,
                    gather_windowed: bool = False):
    """Post-flow shard_map segment: combine the novel views and gather
    the final composite.  ``fl``/``fr`` are the same arrays the pre
    segment handed to the flow solver."""
    canvas_map = stitcher.match_images(image_l, image_r)
    h_loc, w = canvas_map.shape
    if width is not None and width < w:
        merged_w = _tiled_combine(fl, fr, flr, frl, blend, axis, tc)
        merged = jnp.zeros((h_loc, w, 4), jnp.uint8)
        merged = jax.lax.dynamic_update_slice(merged, merged_w, (0, 0, 0))
        merged = jnp.roll(merged, roll, axis=1)
        gw = (roll, width) if gather_windowed else None
        return _tiled_gather(canvas_map, image_l, image_r, merged, cfg,
                             axis, h_global, window=gw)
    length = w // cfg.flow_extend_div
    ol = im.crop_x(fl, length)
    orr = im.crop_x(fr, length)
    flr_c = im.crop_x(flr, length)
    frl_c = im.crop_x(frl, length)
    merged = _tiled_combine(ol, orr, flr_c, frl_c, blend, axis, tc)
    return _tiled_gather(canvas_map, image_l, image_r, merged, cfg,
                         axis, h_global)


def tiled_stitch_pair(image_l: jax.Array, image_r: jax.Array,
                      cfg: StitchConfig, mesh, axis: str = "y",
                      tc: TileConfig = TileConfig(),
                      window: tuple | None = None) -> jax.Array:
    """Stitch one canvas pair, row-sharded over ``mesh``.

    Inputs are global (H, W, 4) uint8 arrays; rows are padded to a
    multiple of the mesh size with transparent rows, stitched tiled, and
    cropped back.  ``window`` is an optional precomputed
    (roll, width[, gather_safe]) overlap column window (e.g. from
    crop.pair_window / crop.plan_chain_windows) -- the sharded twin of
    stitch_pair_auto's work-saving crop; pass it to avoid full-canvas
    flow/blend/combine work.
    """
    h, w = image_l.shape[:2]
    n = int(np.prod([mesh.shape[a] for a in (axis,)]))
    hp = _cdiv(h, n) * n
    pad = ((0, hp - h), (0, 0), (0, 0))
    # place inputs onto the mesh explicitly: callers may hand over
    # arrays committed to a single device (e.g. another pipeline
    # stage's output), which would otherwise conflict with the
    # mesh-spanning shard_map
    from jax.sharding import NamedSharding
    sh = NamedSharding(mesh, P(axis))
    lp = jax.device_put(jnp.pad(image_l, pad), sh)
    rp = jax.device_put(jnp.pad(image_r, pad), sh)

    if window is not None and window[1] < w:
        roll, width, gsafe = (window if len(window) == 3
                              else (*window, False))
        fn = _tiled_stitch_jit(mesh, axis, n, h, cfg, tc, width, bool(gsafe))
        out = fn(lp, rp, jnp.asarray(roll, jnp.int32))
    else:
        out = _tiled_stitch_jit(mesh, axis, n, h, cfg, tc, None, False)(lp, rp)
    return out[:h]


@functools.lru_cache(maxsize=None)
def _tiled_stitch_jit(mesh, axis: str, n: int, h_global: int,
                      cfg: StitchConfig, tc: TileConfig,
                      width: int | None, gsafe: bool):
    """Cached jitted sharded-stitch program.

    Building `jax.jit(shard_map(partial(...)))` inline on every
    tiled_stitch_pair call defeated jit's callable-identity cache: each
    call RETRACED the full program (tens of seconds at 2+ MP) even when
    the persistent XLA cache supplied the executable.  check_vma=False:
    the relax kernel's out_shapes carry no varying-mesh-axes annotation
    (the kernel is per-tile local; the check adds nothing here)."""
    if tc.flow_mode == "hybrid":
        return _hybrid_stitch_jit(mesh, axis, n, h_global, cfg, tc, width,
                                  gsafe)
    if tc.flow_mode != "shardmap":
        raise ValueError(f"unknown flow_mode {tc.flow_mode!r}")
    if width is not None:
        body = partial(_tiled_stitch_pair_body, cfg=cfg, axis=axis, n=n,
                       h_global=h_global, tc=tc, width=width,
                       gather_windowed=gsafe)
        return jax.jit(shard_map(body, mesh=mesh,
                                 in_specs=(P(axis), P(axis), P()),
                                 out_specs=P(axis), check_vma=False))
    body = partial(_tiled_stitch_pair_body, cfg=cfg, axis=axis, n=n,
                   h_global=h_global, tc=tc)
    return jax.jit(shard_map(body, mesh=mesh,
                             in_specs=(P(axis), P(axis)),
                             out_specs=P(axis), check_vma=False))


@functools.lru_cache(maxsize=None)
def _hybrid_stitch_jit(mesh, axis: str, n: int, h_global: int,
                       cfg: StitchConfig, tc: TileConfig,
                       width: int | None, gsafe: bool):
    """Cached jitted hybrid sharded-stitch program: pre-flow shard_map
    segment -> hybrid flow (solver outside shard_map, see
    parallel/hybrid.py) -> post-flow shard_map segment, all one jit
    (one dispatch per pair, like the all-inside-shard_map program)."""
    from panorama_opticalflow_tpu.parallel import hybrid

    params = cfg.flow_params
    win = width is not None
    pre_specs = (P(axis), P(axis)) + ((P(),) if win else ())
    pre = shard_map(
        partial(_pre_flow_body, cfg=cfg, axis=axis, n=n,
                h_global=h_global, width=width),
        mesh=mesh, in_specs=pre_specs,
        out_specs=(P(axis), P(axis), P(axis)), check_vma=False)
    post_specs = (P(axis),) * 7 + ((P(),) if win else ())
    post = shard_map(
        partial(_post_flow_body, cfg=cfg, axis=axis, h_global=h_global,
                tc=tc, width=width, gather_windowed=gsafe),
        mesh=mesh, in_specs=post_specs, out_specs=P(axis),
        check_vma=False)

    def prog(lp, rp, roll=None):
        extra = (roll,) if win else ()
        fl, fr, blend = pre(lp, rp, *extra)
        flr, frl = hybrid.hybrid_flow_pair(
            fl, fr, params, ("left", "right"), mesh, axis, n, h_global, tc)
        return post(lp, rp, fl, fr, flr, frl, blend, *extra)

    return jax.jit(prog)


def tiled_stitch_pair_auto(image_l: jax.Array, image_r: jax.Array,
                           cfg: StitchConfig, mesh, axis: str = "y",
                           tc: TileConfig = TileConfig()) -> jax.Array:
    """tiled_stitch_pair with the overlap window derived from the pair's
    canvas map (one tiny host sync, exactly like stitch_pair_auto)."""
    from panorama_opticalflow_tpu.models import crop

    window = crop.pair_window(stitcher.match_images(image_l, image_r), cfg)
    return tiled_stitch_pair(image_l, image_r, cfg, mesh, axis, tc,
                             window=window)
