#!/usr/bin/env python
"""Device-loop timing of each stitch_pair stage at a given canvas size,
to find where the end-to-end time actually goes."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from panorama_opticalflow_tpu.utils.runtime import init_runtime  # noqa: E402

init_runtime(verbose=False)

from panorama_opticalflow_tpu.utils.runtime import time_call  # noqa: E402
from panorama_opticalflow_tpu.models import novel_view, pixflow, stitcher  # noqa: E402
from panorama_opticalflow_tpu.ops import image as im  # noqa: E402
from panorama_opticalflow_tpu.ops.relax_fast import warp_by_flow_tiled  # noqa: E402
from panorama_opticalflow_tpu.utils import io as pio  # noqa: E402
from panorama_opticalflow_tpu.utils.config import StitchConfig  # noqa: E402


def main():
    h, w = (int(t) for t in (sys.argv[1] if len(sys.argv) > 1
                             else "1000x2250").split("x"))
    cfg = StitchConfig()
    photos, top = pio.synthesize_fisheye_set(h, w, n=5, seed=0)
    il = jnp.asarray(photos[1])
    ir = jnp.asarray(top)

    t = time_call(lambda a, b: stitcher.match_images(a, b), il, ir, iters=20)
    print(f"match_images:        {t*1e3:8.2f} ms")

    cmap = stitcher.match_images(il, ir)
    t = time_call(lambda m: stitcher.generate_blend(m, cfg)[0], cmap,
                    iters=5)
    print(f"generate_blend:      {t*1e3:8.2f} ms")

    ol = stitcher.extract_overlap(il, cmap)
    orr = stitcher.extract_overlap(ir, cmap)

    # flow input: wrap-extended overlap, downscaled
    length = w // cfg.flow_extend_div
    ext_l = im.wrap_extend_x(ol, length)
    ext_r = im.wrap_extend_x(orr, length)
    we = ext_l.shape[1]
    dh, dw = h // 2, we // 2

    t = time_call(lambda a: im.resize_u8(a, (dh, dw), "cubic"), ext_l,
                    iters=5)
    print(f"downscale u8 cubic:  {t*1e3:8.2f} ms")

    params = cfg.flow_params
    sizes = pixflow.pyramid_sizes(dh, dw, params)
    print(f"pyramid: {len(sizes)} levels, base {sizes[0]}")
    g = jnp.zeros((dh, dw), jnp.float32)
    t = time_call(lambda a: im.resize(a, sizes[1], "linear"), g, iters=10)
    print(f"one pyr resize:      {t*1e3:8.2f} ms")

    flow = jnp.zeros((dh, dw, 2), jnp.float32)
    t = time_call(lambda f: im.resize(f, (sizes[0][0] + 40,
                                            sizes[0][1] + 44), "cubic"),
                    flow, iters=10)
    print(f"one flow upsample:   {t*1e3:8.2f} ms")

    i1g = jnp.stack([g, g], -1)
    t = time_call(lambda f: warp_by_flow_tiled(i1g, f), flow, iters=5)
    print(f"warp_by_flow_tiled:  {t*1e3:8.2f} ms")

    t = time_call(lambda f: im.gaussian_blur(f, 15, 8.0), flow, iters=10)
    print(f"blurred-flow blur:   {t*1e3:8.2f} ms")

    fl = jnp.zeros((h, w, 2), jnp.float32)
    blend = jnp.zeros((h, w), jnp.float32)
    t = time_call(lambda a, b, f1, f2, bl:
                    novel_view.combine_novel_views(a, b, f1, f2, bl),
                    ol, orr, fl, fl, blend, iters=5)
    print(f"combine_novel_views: {t*1e3:8.2f} ms")

    merged = jnp.zeros((h, w, 4), jnp.uint8)
    t = time_call(lambda m, a, b, mm:
                    stitcher.gather_composite(m, a, b, mm, cfg),
                    cmap, il, ir, merged, iters=5)
    print(f"gather_composite:    {t*1e3:8.2f} ms")

    # one full mid-pyramid level via the solver's fast path
    lv = len(sizes) // 3
    lh, lw = sizes[lv]
    i0 = jnp.zeros((lh, lw), jnp.float32)
    a0 = jnp.ones((lh, lw), jnp.float32)
    fl0 = jnp.zeros((lh, lw, 2), jnp.float32)
    t = time_call(lambda a, b, c, d, f:
                    pixflow.patch_match_level(a, b, c, d, f, "left", params),
                    i0, i0, a0, a0, fl0, iters=3)
    print(f"patch_match_level {lh}x{lw}: {t*1e3:8.2f} ms")

    # the direction-batched level (what the pair solver actually runs)
    imgs = jnp.zeros((2, lh, lw), jnp.float32)
    alphas = jnp.ones((2, lh, lw), jnp.float32)
    flb = jnp.zeros((2, lh, lw, 2), jnp.float32)
    t = time_call(lambda a, b, f:
                    pixflow.patch_match_level_batched(
                        a, b, f, ("left", "right"), params),
                    imgs, alphas, flb, iters=3)
    print(f"patch_match_level_batched(2) {lh}x{lw}: {t*1e3:8.2f} ms")

    # the finest level, batched (the bulk of the pyramid's work)
    lh0, lw0 = sizes[0]
    imgs0 = jnp.zeros((2, lh0, lw0), jnp.float32)
    alphas0 = jnp.ones((2, lh0, lw0), jnp.float32)
    flb0 = jnp.zeros((2, lh0, lw0, 2), jnp.float32)
    t = time_call(lambda a, b, f:
                    pixflow.patch_match_level_batched(
                        a, b, f, ("left", "right"), params),
                    imgs0, alphas0, flb0, iters=3)
    print(f"patch_match_level_batched(2) {lh0}x{lw0}: {t*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
