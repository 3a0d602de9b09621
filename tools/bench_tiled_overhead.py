#!/usr/bin/env python
"""Measure the sharding (tiling) overhead term of scaling efficiency on
one device: a 1-device-mesh tiled_stitch_pair
vs the untiled stitch_pair on identical inputs -- same arithmetic path,
plus the halo exchanges (self-copies on 1 device), tiled resizes, and
distance-scan all_to_alls.  Prints one JSON line.

Usage: python tools/bench_tiled_overhead.py [--canvas WxH] [--window]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--canvas", default="4500x2000")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--window", action="store_true",
                    help="use the planned overlap column window on both")
    args = ap.parse_args()
    w, h = (int(t) for t in args.canvas.split("x"))

    from panorama_opticalflow_tpu.utils.runtime import init_runtime

    init_runtime(verbose=False)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from panorama_opticalflow_tpu.models import crop, pipeline, stitcher
    from panorama_opticalflow_tpu.parallel import tiled
    from panorama_opticalflow_tpu.parallel.mesh import make_mesh
    from panorama_opticalflow_tpu.utils import io as pio
    from panorama_opticalflow_tpu.utils.config import StitchConfig
    from panorama_opticalflow_tpu.utils.metrics import ssim

    cfg = StitchConfig(flow_alg="pixflow_low")
    dev = jax.devices()[0]
    photos, top = pio.synthesize_fisheye_set(h, w, n=5, seed=0,
                                             with_top=True)
    il = jax.device_put(photos[0], dev)
    ir = jax.device_put(top, dev)
    # production halo: includes the |flow_y| sampling margin (a
    # zero-margin run scored SSIM 0.915 on a vertical-flow pair)
    tc = tiled.TileConfig.for_params(cfg.flow_params)
    mesh = make_mesh(1)

    window = None
    if args.window:
        window = crop.pair_window(
            np.asarray(stitcher.match_images(il, ir)), cfg)

    force = jax.block_until_ready

    def timed(fn):
        t0 = time.time()
        out = fn()
        force(out)
        compile_s = time.time() - t0
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.time()
            force(fn())
            best = min(best, time.time() - t0)
        return out, best, compile_s

    if args.window:
        untiled = lambda: pipeline.stitch_pair_auto(il, ir, cfg,
                                                    window=window)
    else:
        untiled = lambda: pipeline.stitch_pair(il, ir, cfg)
    ref, t_untiled, c_untiled = timed(untiled)

    tiled_fn = lambda: tiled.tiled_stitch_pair(il, ir, cfg, mesh, "y", tc,
                                               window=window)
    out, t_tiled, c_tiled = timed(tiled_fn)

    s = ssim(np.asarray(out)[..., :3].astype(np.float32),
             np.asarray(ref)[..., :3].astype(np.float32))
    print(json.dumps({
        "metric": f"tiled(1-dev mesh) vs untiled pair stitch {w}x{h}"
                  f"{' windowed' if args.window else ''} ({dev.platform})",
        "untiled_s": round(t_untiled, 4),
        "tiled_s": round(t_tiled, 4),
        "tiling_overhead": round(t_tiled / t_untiled - 1.0, 4),
        "ssim_tiled_vs_untiled": round(float(s), 5),
        "compile_untiled_s": round(c_untiled, 1),
        "compile_tiled_s": round(c_tiled, 1),
        "flow_mode": tc.flow_mode,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
