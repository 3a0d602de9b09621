#!/usr/bin/env python
"""Per-level cost decomposition of the batched pixflow solver.

The pyramid has ~42 levels whose areas decay by
0.81x, so if per-level cost were pure area-proportional compute the
total would be ~5.26x the finest level's cost; any excess is per-level
FIXED overhead (kernel launches, block-gather warps, layout changes).
This tool device-times each component of patch_match_level_batched at
two level shapes and fits cost = a*area + b to locate the overhead.

Usage: python tools/bench_flow_level.py [WxH of the flow canvas]
       (default 1792x2000 -- the solver-resolution window of the
        9000x4000 headline's 3584-wide crop window at downscale 0.5)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from panorama_opticalflow_tpu.utils.runtime import init_runtime  # noqa: E402

init_runtime(verbose=False)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from panorama_opticalflow_tpu.models import pixflow  # noqa: E402
from panorama_opticalflow_tpu.ops import image as im  # noqa: E402
from panorama_opticalflow_tpu.ops.pallas import relax  # noqa: E402
from panorama_opticalflow_tpu.ops.relax_fast import warp_by_flow_tiled  # noqa: E402
from panorama_opticalflow_tpu.utils.config import flow_params_by_name  # noqa: E402
from panorama_opticalflow_tpu.utils.runtime import time_call  # noqa: E402


def level_components(h, w, params, iters=6):
    rng = np.random.RandomState(0)
    imgs = jnp.asarray(rng.rand(2, h, w).astype(np.float32))
    flow = jnp.asarray((rng.rand(2, h, w, 2) - 0.5).astype(np.float32))
    planes = jnp.asarray(rng.rand(4, h, w).astype(np.float32))
    mask = jnp.asarray((rng.rand(2, h, w) > 0.1).astype(np.float32))
    i1g = jnp.asarray(rng.rand(2, h, w, 2).astype(np.float32))

    gk, gs = params.gradient_blur_kernel_width, params.gradient_blur_sigma
    out = {}

    t = time_call(lambda g: jax.vmap(
        lambda x: im.gaussian_blur(im.sobel_x(x), gk, gs))(g), imgs,
        iters=iters)
    out["gradients(x2: x+y)"] = 2 * t

    t = time_call(lambda p: jax.vmap(lambda x: im.gaussian_blur(
        x, params.blurred_flow_kernel_width,
        params.blurred_flow_sigma))(p), planes, iters=iters)
    out["blur15(x2: bf+diff)"] = 2 * t

    t = time_call(lambda g, f: jax.vmap(warp_by_flow_tiled)(g, f),
                    i1g, flow, iters=iters)
    out["warp(x%d: phases)" % params.relax_phases] = \
        params.relax_phases * t

    if relax.use_relax_kernel(h, w):
        bf = flow + 0.1
        t = time_call(lambda f, g, m, b: relax.relax_phase_batched(
            f, f, g, imgs, imgs, b, m > 0.5, params,
            params.relax_iters_per_phase, params.fast_window),
            flow, i1g, mask, bf, iters=iters)
        out["relax kernel(x%d: phases)" % params.relax_phases] = \
            params.relax_phases * t

    t = time_call(lambda p: jax.vmap(im.median5)(p), planes, iters=iters)
    out["median(x%d: phases)" % params.relax_phases] = \
        params.relax_phases * t

    nh, nw = int(h / 0.9 + 0.5), int(w / 0.9 + 0.5)
    t = time_call(lambda p: jax.vmap(
        lambda x: im.resize(x, (nh, nw), "cubic"))(p),
        planes, iters=iters)
    out["resize_up"] = t
    return out


def whole_level(h, w, params, iters=4):
    rng = np.random.RandomState(0)
    imgs = jnp.asarray(rng.rand(2, h, w).astype(np.float32))
    alphas = jnp.asarray((rng.rand(2, h, w) > 0.05).astype(np.float32))
    flow = jnp.asarray((rng.rand(2, h, w, 2) - 0.5).astype(np.float32))

    def lvl(i, a, f):
        return pixflow.patch_match_level_batched(
            i, a, f, ("left", "right"), params)

    return time_call(lvl, imgs, alphas, flow, iters=iters)


def main():
    w, h = (int(t) for t in (sys.argv[1] if len(sys.argv) > 1
                             else "1792x2000").split("x"))
    params = flow_params_by_name("pixflow_low")
    sizes = pixflow.pyramid_sizes(h, w, params)
    areas = [sh * sw for sh, sw in sizes]
    area_sum = sum(areas)
    print(f"# pyramid: {len(sizes)} levels, finest {sizes[0]}, "
          f"area_sum/finest = {area_sum / areas[0]:.2f}")

    small = sizes[min(8, len(sizes) - 1)]
    for (lh, lw) in (sizes[0], small):
        t0 = time.time()
        comp = level_components(lh, lw, params)
        tot = whole_level(lh, lw, params)
        csum = sum(comp.values())
        print(f"level {lh}x{lw}: whole={tot*1e3:7.2f} ms  "
              f"sum(components)={csum*1e3:7.2f} ms  "
              f"(bench wall {time.time()-t0:.0f}s)")
        for k, v in comp.items():
            print(f"    {k:22s} {v*1e3:7.2f} ms")

    # fixed-overhead fit from the two whole-level points:
    a0, a1 = sizes[0][0] * sizes[0][1], small[0] * small[1]
    print("# extrapolation: per-pair flows total ~= "
          "sum_l (a*area_l + b) over levels; fit a,b from the two "
          "whole-level numbers above by hand or rerun with more sizes.")


if __name__ == "__main__":
    main()
