"""End-to-end stitch pipelines: the 6-input iterative driver and the
4-input single-pass driver.

Re-design of the two reference mains (CPU/main.cpp:47-110,
CPU_4Input/main.cpp:47-119).  ``stitch_pair`` -- one full
prepare -> flow -> novel-view -> gather pass over a canvas pair -- is a
single jit-compiled program; the 6-input driver calls it 5 times with the
accumulating panorama as R (all pairs share the canvas shape, so there is
exactly one compilation).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from panorama_opticalflow_tpu.models import novel_view, stitcher
from panorama_opticalflow_tpu.ops import image as im
from panorama_opticalflow_tpu.utils.config import StitchConfig


@partial(jax.jit, static_argnames=("cfg",))
def stitch_pair(
    image_l: jax.Array, image_r: jax.Array, cfg: StitchConfig
) -> jax.Array:
    """Stitch one canvas pair (the body of the reference's per-part loop,
    CPU/main.cpp:60-101).  Inputs/outputs are (H, W, 4) uint8 RGBA on the
    shared equirectangular canvas."""
    ctx = stitcher.prepare(image_l, image_r, cfg)
    flows = novel_view.prepare_flows(ctx.overlapped_l, ctx.overlapped_r, cfg)
    merged = novel_view.combine_novel_views(
        ctx.overlapped_l, ctx.overlapped_r,
        flows.flow_l_to_r, flows.flow_r_to_l, ctx.blend)
    return stitcher.gather_composite(ctx.map, image_l, image_r, merged, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _prepare_jit(image_l, image_r, cfg: StitchConfig):
    return stitcher.prepare(image_l, image_r, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _geometry_jit(image_l, image_r, cfg: StitchConfig):
    """Map + overlap extraction only (no blend) -- the cheap part of
    prepare, enough to derive the crop window."""
    canvas_map = stitcher.match_images(image_l, image_r)
    return (canvas_map,
            stitcher.extract_overlap(image_l, canvas_map),
            stitcher.extract_overlap(image_r, canvas_map))


@partial(jax.jit, static_argnames=("cfg", "width"))
def _blend_window_jit(canvas_map, roll, width: int, cfg: StitchConfig):
    blend, _ = stitcher.generate_blend(canvas_map, cfg, window=(roll, width))
    return blend


@partial(jax.jit, static_argnames=("cfg", "width"))
def _flows_window_jit(ol, orr, roll, width: int, cfg: StitchConfig):
    from panorama_opticalflow_tpu.models.crop import cropped_flows_window

    return cropped_flows_window(ol, orr, roll, width, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _finish_jit(ctx, image_l, image_r, flow_lr, flow_rl, cfg: StitchConfig):
    merged = novel_view.combine_novel_views(
        ctx.overlapped_l, ctx.overlapped_r, flow_lr, flow_rl, ctx.blend)
    return stitcher.gather_composite(ctx.map, image_l, image_r, merged, cfg)


@partial(jax.jit, static_argnames=("cfg", "width", "gather_windowed"))
def _finish_windowed_jit(canvas_map, overlapped_l, overlapped_r, blend_w,
                         image_l, image_r, flow_lr_w, flow_rl_w,
                         roll, width: int, cfg: StitchConfig,
                         gather_windowed: bool = False):
    """Combine on the overlap window only (flow is zero elsewhere, so the
    merged view is transparent there -- exact), then composite on the
    full canvas.  ``blend_w`` is the window-sized blend field (windowed
    blend is an SSIM-gated approximation, see stitcher.generate_blend).
    With ``gather_windowed`` (caller checked crop.gather_window_safe) the
    hole search also runs on the window."""
    h, w = image_l.shape[:2]
    if width >= w:
        merged = novel_view.combine_novel_views(
            overlapped_l, overlapped_r, flow_lr_w, flow_rl_w, blend_w)
        return stitcher.gather_composite(canvas_map, image_l, image_r,
                                         merged, cfg)

    def win(a):
        return jnp.roll(a, -roll, axis=1)[:, :width]

    merged_w = novel_view.combine_novel_views(
        win(overlapped_l), win(overlapped_r),
        flow_lr_w, flow_rl_w, blend_w)
    merged = jnp.zeros((h, w, 4), jnp.uint8)
    merged = jax.lax.dynamic_update_slice(merged, merged_w, (0, 0, 0))
    merged = jnp.roll(merged, roll, axis=1)
    gw = (roll, width) if gather_windowed else None
    return stitcher.gather_composite(canvas_map, image_l, image_r, merged,
                                     cfg, window=gw)


def stitch_pair_auto(
    image_l: jax.Array, image_r: jax.Array, cfg: StitchConfig,
    window: tuple | None = None,
) -> jax.Array:
    """stitch_pair with overlap-cropped work (models/crop.py): the dense
    solver, the blend field, the novel-view combiner, and (when provably
    exact) the gather hole search all run only on a bucketed column
    window around the overlap band.  The composite is bit-identical away
    from the overlap; inside it the windowed flow/blend are SSIM-gated
    approximations (tests/test_crop.py).  ``window`` is a precomputed
    (roll, width, gather_safe) (e.g. from crop.plan_chain_windows); when
    None it is derived from the pair's map with one tiny host-device
    sync."""
    from panorama_opticalflow_tpu.models import crop

    # Commit both inputs to one device: the chain's later pairs pass a
    # committed device array as R while the first pair gets host numpy --
    # mismatched placements gave _geometry_jit/_finish_windowed_jit a
    # second trace (and a second, differently-sized executable) per
    # chain.  device_put is a no-op when already there.
    dev = jax.devices()[0]
    image_l = jax.device_put(image_l, dev)
    image_r = jax.device_put(image_r, dev)
    canvas_map, ol, orr = _geometry_jit(image_l, image_r, cfg)
    if window is None:
        roll, width, gsafe = crop.pair_window(canvas_map, cfg)
    else:
        roll, width, gsafe = (window if len(window) == 3
                              else (*window, False))
    roll_j = jnp.asarray(roll)
    blend_w = _blend_window_jit(canvas_map, roll_j, width, cfg)
    flow_lr_w, flow_rl_w = _flows_window_jit(ol, orr, roll_j, width, cfg)
    return _finish_windowed_jit(canvas_map, ol, orr, blend_w,
                                image_l, image_r, flow_lr_w, flow_rl_w,
                                roll_j, width, cfg, gather_windowed=gsafe)


def _stitch_pair_windowed_body(image_l, image_r, roll, width: int, gsafe,
                               cfg: StitchConfig):
    """One full windowed pair stitch as a single traced body: geometry,
    windowed blend field, windowed bidirectional flow, windowed combine,
    composite.  ``roll`` is a traced int32 scalar, ``width`` static, and
    ``gsafe`` a traced bool -- the gather hole search runs on the window
    (bit-identical when crop.gather_window_safe held at plan time) or
    the full canvas under ``lax.cond``.  Same math as the split
    _geometry/_blend_window/_flows_window/_finish_windowed programs, in
    ONE program -- the chain driver scans it so a whole 6-photo stitch
    is a single dispatch (the split path costs 4 dispatches/pair)."""
    from panorama_opticalflow_tpu.models.crop import cropped_flows_window

    h, w = image_l.shape[:2]
    canvas_map = stitcher.match_images(image_l, image_r)
    ol = stitcher.extract_overlap(image_l, canvas_map)
    orr = stitcher.extract_overlap(image_r, canvas_map)
    blend_w, _ = stitcher.generate_blend(canvas_map, cfg,
                                         window=(roll, width))
    flow_lr_w, flow_rl_w = cropped_flows_window(ol, orr, roll, width, cfg)

    def win(a):
        return jnp.roll(a, -roll, axis=1)[:, :width]

    merged_w = novel_view.combine_novel_views(
        win(ol), win(orr), flow_lr_w, flow_rl_w, blend_w)
    merged = jnp.zeros((h, w, 4), jnp.uint8)
    merged = jax.lax.dynamic_update_slice(merged, merged_w, (0, 0, 0))
    merged = jnp.roll(merged, roll, axis=1)
    return jax.lax.cond(
        gsafe,
        lambda: stitcher.gather_composite(canvas_map, image_l, image_r,
                                          merged, cfg,
                                          window=(roll, width)),
        lambda: stitcher.gather_composite(canvas_map, image_l, image_r,
                                          merged, cfg))


@partial(jax.jit, static_argnames=("cfg", "width"))
def _chain_windowed_jit(photos, top, rolls, gsafes, width: int,
                        cfg: StitchConfig):
    """The whole iterative chain as ONE program: lax.scan of the fused
    windowed pair body over the photos, with the per-pair planned rolls
    and gather-safety flags as scan inputs.  Valid when every pair's
    planned window width coincides (they are bucketed to 256-multiples,
    so they almost always do)."""
    def step(acc, xs):
        img_l, roll, gs = xs
        return _stitch_pair_windowed_body(img_l, acc, roll, width, gs,
                                          cfg), None

    out, _ = jax.lax.scan(step, top, (photos, rolls, gsafes))
    return out


def stitch_pair_debug(
    image_l: jax.Array, image_r: jax.Array, cfg: StitchConfig
) -> tuple[jax.Array, dict]:
    """stitch_pair that also returns the intermediates the reference can
    dump (Map, Blend, OverlappedL/R, mergedmiddle, flows -- the
    commented imwrites at CPU/main.cpp:73-76,91 and the visualisers of
    CPU/OpticalFlow.cpp:147-204)."""
    ctx = _prepare_jit(image_l, image_r, cfg)
    flows = novel_view.prepare_flows(ctx.overlapped_l, ctx.overlapped_r, cfg)
    merged = novel_view.combine_novel_views(
        ctx.overlapped_l, ctx.overlapped_r,
        flows.flow_l_to_r, flows.flow_r_to_l, ctx.blend)
    out = stitcher.gather_composite(ctx.map, image_l, image_r, merged, cfg)
    inter = {
        "Map": ctx.map,
        "Blend": ctx.blend,
        "OverlappedL": ctx.overlapped_l,
        "OverlappedR": ctx.overlapped_r,
        "mergedmiddle": merged,
        "flowLtoR": flows.flow_l_to_r,
        "flowRtoL": flows.flow_r_to_l,
    }
    return out, inter


def dump_intermediates(inter: dict, out_dir: str, tag: str,
                       flow_alg: str) -> None:
    """Write the debug intermediates like the reference's (commented)
    dumps, plus the three flow visualisations."""
    import os

    import numpy as np

    from panorama_opticalflow_tpu.utils import visualize
    from panorama_opticalflow_tpu.utils.native_io import write_image_fast

    os.makedirs(out_dir, exist_ok=True)

    def w8(name, arr):
        write_image_fast(os.path.join(out_dir, f"{tag}_{name}.png"),
                         np.asarray(arr))

    w8("Map", np.asarray(inter["Map"]))
    w8("Blend", (np.asarray(inter["Blend"]) * 255).astype("uint8"))
    w8("OverlappedL", inter["OverlappedL"])
    w8("OverlappedR", inter["OverlappedR"])
    w8("mergedmiddle", inter["mergedmiddle"])
    for key in ("flowLtoR", "flowRtoL"):
        flow = np.asarray(inter[key])
        grey = visualize.flow_as_grey_disparity(flow)
        wheel = visualize.flow_color_wheel(flow)
        field = visualize.flow_as_vector_field(
            flow, np.asarray(inter["OverlappedL"]))
        vis = visualize.stack_horizontal(
            [np.stack([grey] * 3, -1), wheel, field])
        w8(f"{key}_{flow_alg}", vis)


def stitch_six(
    images: list[jax.Array], top: jax.Array, cfg: StitchConfig,
    on_part=None, use_crop: bool = True,
) -> jax.Array:
    """Iterative 6-input stitch (CPU/main.cpp:60-105): R starts as the top
    image and accumulates the panorama; L is photo i for i = 1..5.
    ``on_part(i, result)`` is called after each pass (the reference writes
    ProcessResult{i}.png there).

    With ``use_crop`` every pair's overlap window is planned up front
    from the input alpha footprints (crop.plan_chain_windows), so the
    whole 5-pair chain enqueues without a single blocking host sync."""
    result = top
    if use_crop:
        from panorama_opticalflow_tpu.models import crop

        windows = crop.plan_chain_windows(images, top, cfg)
        h, w = top.shape[:2]
        widths = {wd for _, wd, _ in windows}
        if on_part is None and len(widths) == 1 and min(widths) < w:
            # all pairs share one window bucket and nobody needs the
            # intermediates: run the WHOLE chain as one scanned program
            # (one dispatch, one executable)
            width = next(iter(widths))
            dev = jax.devices()[0]
            photos_j = jax.device_put(
                jnp.stack([jnp.asarray(p) for p in images]), dev)
            top_j = jax.device_put(jnp.asarray(top), dev)
            rolls = jnp.asarray([r for r, _, _ in windows], jnp.int32)
            gsafes = jnp.asarray([g for _, _, g in windows], bool)
            return _chain_windowed_jit(photos_j, top_j, rolls, gsafes,
                                       width, cfg)
        for i, (image_l, window) in enumerate(zip(images, windows), start=1):
            result = stitch_pair_auto(image_l, result, cfg, window=window)
            if on_part is not None:
                on_part(i, result)
        return result
    for i, image_l in enumerate(images, start=1):
        result = stitch_pair(image_l, result, cfg)
        if on_part is not None:
            on_part(i, result)
    return result


def precrop_columns(image: jax.Array) -> jax.Array:
    """4-input column pre-crop (CPU_4Input/main.cpp:65-76): zero every
    column whose middle-row alpha is zero."""
    mid = image[image.shape[0] // 2, :, 3]
    keep = (mid != 0).astype(image.dtype)[None, :, None]
    return image * keep


@jax.jit
def compose_four(images: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Pre-crop and composite 4 wide-angle photos into the two canvases
    (opposite cameras do not overlap): L = 1 + 3, R = 2 + 4
    (CPU_4Input/main.cpp:79-80)."""
    i1, i2, i3, i4 = (precrop_columns(images[k]) for k in range(4))
    image_l = im.saturating_add_u8(i1, i3)
    image_r = im.saturating_add_u8(i2, i4)
    return image_l, image_r


def stitch_four(images: list[jax.Array], cfg: StitchConfig,
                use_crop: bool = True) -> jax.Array:
    """Single-pass 4-input stitch (CPU_4Input/main.cpp:47-119)."""
    image_l, image_r = compose_four(jnp.stack(images))
    fn = stitch_pair_auto if use_crop else stitch_pair
    return fn(image_l, image_r, cfg)
