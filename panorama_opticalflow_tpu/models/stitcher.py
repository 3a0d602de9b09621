"""Stitch orchestration: canvas map, overlap extraction, seam-blend field,
and final composite.

Array-program re-design of the reference ``Stitchtools`` class
(CPU/StitchTool.{hpp,cpp}): instead of stateful Mats and per-pixel loops,
each stage is a pure, jit-compatible function over the shared
equirectangular canvas.  Canvas images are (H, W, 4) uint8 RGBA where
alpha encodes footprint/validity (SURVEY.md section 1).

Map codes (CPU/StitchTool.hpp:27, CPU/StitchTool.cpp:38-50):
  0 = empty, 100 = L only, 50 = R only, 150 = overlap.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from panorama_opticalflow_tpu.ops import image as im
from panorama_opticalflow_tpu.ops.distance import (
    eight_ray_min_distance,
    two_class_hole_search,
)
from panorama_opticalflow_tpu.utils.config import StitchConfig


class StitchContext(NamedTuple):
    """Per-pair stitch state (the reference's Stitchtools fields)."""

    map: jax.Array          # (H, W) uint8 canvas map, codes {0,50,100,150}
    overlapped_l: jax.Array  # (H, W, 4) uint8, L masked to overlap
    overlapped_r: jax.Array  # (H, W, 4) uint8, R masked to overlap
    blend: jax.Array        # (H, W) float32 in [0,1]
    merged_dis: jax.Array   # (H, W) float32 distance to nearest pure region


def match_images(image_l: jax.Array, image_r: jax.Array) -> jax.Array:
    """Canvas map from the two alpha footprints (CPU/StitchTool.cpp:38-50)."""
    a_l = im.threshold_binary(image_l[..., 3], 0, 100)
    a_r = im.threshold_binary(image_r[..., 3], 0, 50)
    return (a_l + a_r).astype(jnp.uint8)


def extract_overlap(image: jax.Array, canvas_map: jax.Array) -> jax.Array:
    """Zero the image outside the overlap region (CPU/StitchTool.cpp:17-33).

    The reference multiplies every channel by the 0/1 mask Map > 140."""
    mask = (canvas_map > 140).astype(jnp.uint8)
    return image * mask[..., None]


def generate_blend(
    canvas_map: jax.Array, cfg: StitchConfig,
    window: tuple | None = None, scale: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Seam-blend weight field over the overlap (CPU/StitchTool.cpp:98-191).

    For each overlap pixel: the distance-weighted mix
    ``blend = dL / (dL + dR)`` where dL/dR are the 8-ray strided min
    distances to the pure-L (100) / pure-R (50) regions, computed on the
    cols/5 wrap-extended map.  Vectorised here as scan-based distance
    fields (ops/distance.py) instead of a per-pixel search -- the CUDA
    variant's one-thread-per-pixel walk (GPU/StitchTool_GPU.cu:10-66)
    becomes eight log-depth scans.

    Returns (blend, merged_dis), both (H, W) float32 -- or (H, width)
    when ``window`` is given.

    ``window`` is an optional (roll, width) column window around the
    overlap band: the field is computed on the rolled slice only, with
    all size-derived constants (ray stride, ray bound, blur kernels,
    none_val) still taken from the full canvas.  This is an
    *approximation*, gated by the pipeline SSIM tests: rays stop at the
    window edges (instead of cols/2 away or across the full
    wrap-extension), and the window edges see the blurs' replicate
    border.  Both effects live >= the planner's margin away from the
    overlap band that the combiner actually consumes.  The caller should
    align ``roll`` to the selective-smoothing block stride
    (crop aligns it) so the step x step block grid matches the
    full-canvas one; on a window that crosses the x=0 seam the grid
    phase beyond the seam is off by (W mod step), and the window's
    blurs run *continuously across the seam* while the full-canvas op
    (like the reference, which blurs the already-cropped field,
    CPU/StitchTool.cpp:127-143) sees an x=0 blur border -- both within
    the gate (and the seam-continuous field is the better panorama
    semantics).

    Known deviation from the reference: its selective smoothing box-blurs
    each step x step block *in place* in raster order so later blocks read
    earlier blurred borders (CPU/StitchTool.cpp:134-142); we blur once
    globally and select per block, which differs only at block borders and
    is then smoothed again by the global rows/400 blur.
    """
    h, w = canvas_map.shape
    step = max(1, min(h, w) // cfg.blend_step_div)
    max_i = w / 2.0  # ray index bound i < cols/2 (CPU/StitchTool.cpp:158)
    none_val = jnp.float32(10.0 * w)  # reference init (CPU/StitchTool.cpp:155)
    # Decimation factor (cfg.blend_scale): the whole field -- ray scans,
    # selective smoothing, blurs -- runs on an s-decimated map (codes
    # survive nearest decimation) with all size-derived constants still
    # taken from the FULL canvas and distances scaled back to full-pixel
    # units; only the final field is bilinearly upsampled.  s == 1 is
    # bit-identical to the reference-exact formulation below.
    s = cfg.blend_scale_resolved if scale is None else scale
    step_s = max(1, step // s)

    windowed = window is not None and window[1] < w
    if windowed:
        roll, width = window
        center = jnp.roll(canvas_map, -roll, axis=1)[:, :width]
        out_w = width
    else:
        center = canvas_map
        out_w = w
    cs = center[::s, ::s] if s > 1 else center

    if windowed:
        d_l = eight_ray_min_distance(cs == 100, step_s, max_i / s)
        d_r = eight_ray_min_distance(cs == 50, step_s, max_i / s)
    else:
        length_s = (w // cfg.blend_extend_div) // s
        ext = im.wrap_extend_x(cs, length_s)
        d_l = im.crop_x(eight_ray_min_distance(ext == 100, step_s,
                                               max_i / s), length_s)
        d_r = im.crop_x(eight_ray_min_distance(ext == 50, step_s,
                                               max_i / s), length_s)
    if s > 1:
        d_l = d_l * s
        d_r = d_r * s

    d_l = jnp.where(jnp.isinf(d_l), none_val, d_l)
    d_r = jnp.where(jnp.isinf(d_r), none_val, d_r)

    counted = d_l / (d_l + d_r)
    merged_dis = jnp.minimum(d_l, d_r)

    blend = jnp.where(cs == 100, 0.0,
                      jnp.where(cs == 50, 1.0,
                                jnp.where(cs == 150, counted, 0.5)))
    merged_dis = jnp.where(cs == 150, merged_dis, 0.0)
    h_s, out_w_s = blend.shape

    # Selective smoothing: blocks whose top-left MergedDis > step get a
    # rows/130 box blur (CPU/StitchTool.cpp:130-142), then a global
    # rows/400 box blur (CPU/StitchTool.cpp:143).
    k_sel = h // cfg.blend_smooth_kernel_div
    if k_sel >= 2:
        blurred = im.box_blur(blend, max(1, k_sel // s), max(1, k_sel // s))
        # block (by, bx) covers rows [by*step, by*step+step); only blocks
        # fully inside (loop bound y + step < H) are smoothed.  With a
        # step-aligned window the block grid matches the full canvas; the
        # x in-bounds test uses global column ids.
        hq, wq = h_s // step_s, out_w_s // step_s
        sel = merged_dis[: hq * step_s : step_s, : wq * step_s : step_s] \
            > step
        # a block starting at q*step is processed iff q*step + step < dim
        qy = jnp.arange(hq) * step_s + step_s < h_s
        if windowed:
            gx = (jnp.arange(wq) * step_s * s + window[0]) % w
            qx = gx + step < w
        else:
            qx = jnp.arange(wq) * step_s * s + step < w
        sel = sel & qy[:, None] & qx[None, :]
        sel_full = jnp.zeros((h_s, out_w_s), bool)
        sel_up = jnp.repeat(jnp.repeat(sel, step_s, axis=0), step_s, axis=1)
        sel_full = sel_full.at[: hq * step_s, : wq * step_s].set(sel_up)
        blend = jnp.where(sel_full, blurred, blend)

    k_glob = h // cfg.blend_global_blur_div
    if k_glob >= 2:
        blend = im.box_blur(blend, max(1, k_glob // s), max(1, k_glob // s))

    if s > 1:
        blend = im.resize(blend, (h, out_w), "linear")
        merged_dis = im.resize(merged_dis, (h, out_w), "linear")

    return blend.astype(jnp.float32), merged_dis


def prepare(
    image_l: jax.Array, image_r: jax.Array, cfg: StitchConfig
) -> StitchContext:
    """Stitchtools::prepare (CPU/StitchTool.cpp:7-36)."""
    canvas_map = match_images(image_l, image_r)
    overlapped_l = extract_overlap(image_l, canvas_map)
    overlapped_r = extract_overlap(image_r, canvas_map)
    blend, merged_dis = generate_blend(canvas_map, cfg)
    return StitchContext(canvas_map, overlapped_l, overlapped_r, blend, merged_dis)


def gather_composite(
    ctx_map: jax.Array,
    image_l: jax.Array,
    image_r: jax.Array,
    merged_middle: jax.Array,
    cfg: StitchConfig,
    window: tuple | None = None,
) -> jax.Array:
    """Final composite (CPU/StitchTool.cpp:52-96).

    code = Map + 75*(merged alpha > 0):
      100 -> L, 50 -> R, {225,175,125} -> merged, 0 -> transparent,
      75 -> zeros, 150 (overlap where the flow merge left a hole) ->
      take L or R of the nearest pure region within ``gather_search_radius``
      unit-stride ray steps (L wins ties), else opaque black.

    The reference's per-pixel ray loop reads out of bounds (UB); here rays
    simply stop at the canvas edge.

    ``window`` is an optional (roll, width) column window.  Holes only
    occur at code==150 (overlap) and the search rays are bounded by
    ``gather_search_radius``, so when the caller guarantees every overlap
    column sits >= radius inside the window and >= radius away from the
    true canvas x-edges (crop.gather_window_safe), running the distance
    scans on the window slice is bit-identical at a fraction of the
    cost; the elementwise composite stays full-canvas.
    """
    h, w = ctx_map.shape
    merged_a = im.threshold_binary(merged_middle[..., 3], 0, 75)
    code = ctx_map + merged_a  # uint8, max 225

    r = cfg.gather_search_radius

    def hole_from(codes, img_l, img_r):
        # one class-encoded int16 doubling field; L wins distance ties
        found, take_l = two_class_hole_search(codes == 100, codes == 50, r)
        hole_black = jnp.array([0, 0, 0, 255], jnp.uint8)
        return jnp.where(found[..., None],
                         jnp.where(take_l[..., None], img_l, img_r),
                         hole_black)

    if window is None:
        hole = hole_from(code, image_l, image_r)
    else:
        roll, width = window

        def win(a):
            return jnp.roll(a, -roll, axis=1)[:, :width]

        hole_w = hole_from(win(code), win(image_l), win(image_r))
        hole = jnp.zeros((h, w, 4), jnp.uint8)
        hole = jax.lax.dynamic_update_slice(hole, hole_w, (0, 0, 0))
        hole = jnp.roll(hole, roll, axis=1)

    zero = jnp.zeros((4,), jnp.uint8)
    out = jnp.where((code == 100)[..., None], image_l, zero)
    out = jnp.where((code == 50)[..., None], image_r, out)
    is_merged = (code == 225) | (code == 175) | (code == 125)
    out = jnp.where(is_merged[..., None], merged_middle, out)
    out = jnp.where((code == 150)[..., None], hole, out)
    return out
