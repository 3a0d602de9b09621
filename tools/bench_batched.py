#!/usr/bin/env python
"""Benchmark batched stitching: B panorama pairs in flight via jax.vmap
(BASELINE.json config: "Batched stitching: 8 panoramas in flight,
vmapped flow/warp across image pairs on one host").

Prints one JSON line with sequential vs batched latency and MP/s.

Usage:
  python tools/bench_batched.py [--canvas WxH] [--batch B] [--repeats N]

Notes: vmapping the full-canvas stitch_pair (not the windowed auto
path -- the window roll is data-dependent per pair, so the batched
program uses the full-width program, exactly like the reference would
process B panoramas).  Every timing ends in block_until_ready.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--canvas", default="1152x512")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", action="store_true",
                    help="also time the jitted batched and single-pair "
                         "programs with runtime.time_call (median of "
                         "warm calls)")
    args = ap.parse_args()
    w, h = (int(t) for t in args.canvas.split("x"))

    from panorama_opticalflow_tpu.utils.runtime import init_runtime

    init_runtime(verbose=False)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from panorama_opticalflow_tpu.models import pipeline
    from panorama_opticalflow_tpu.utils import io as pio
    from panorama_opticalflow_tpu.utils.config import StitchConfig

    cfg = StitchConfig(flow_alg="pixflow_low")
    dev = jax.devices()[0]

    pairs = []
    for seed in range(args.batch):
        photos = pio.synthesize_four_input_set(h, w, seed=seed)
        pl_, pr = pipeline.compose_four(jnp.stack([jnp.asarray(p)
                                                   for p in photos]))
        pairs.append((pl_, pr))
    ls = jax.device_put(jnp.stack([p[0] for p in pairs]), dev)
    rs = jax.device_put(jnp.stack([p[1] for p in pairs]), dev)

    force = jax.block_until_ready

    seq = jax.jit(lambda a, b: pipeline.stitch_pair(a, b, cfg))
    batched = jax.jit(jax.vmap(lambda a, b: pipeline.stitch_pair(a, b, cfg)))

    # warm both programs
    force(seq(ls[0], rs[0]))
    force(batched(ls, rs))

    t_seq = float("inf")
    for _ in range(args.repeats):
        t0 = time.time()
        outs = [seq(ls[k], rs[k]) for k in range(args.batch)]
        for o in outs:
            force(o)
        t_seq = min(t_seq, time.time() - t0)

    t_bat = float("inf")
    for _ in range(args.repeats):
        t0 = time.time()
        force(batched(ls, rs))
        t_bat = min(t_bat, time.time() - t0)

    extra = {}
    if args.device:
        from panorama_opticalflow_tpu.utils.runtime import time_call

        td_one = time_call(
            lambda a, b: pipeline.stitch_pair(a, b, cfg), ls[0], rs[0],
            iters=2)
        td_bat = time_call(
            lambda a, b: jax.vmap(
                lambda x, y: pipeline.stitch_pair(x, y, cfg))(a, b),
            ls, rs, iters=2)
        extra = {
            "device_single_s": round(td_one, 4),
            "device_batched_s": round(td_bat, 4),
            "device_batch_speedup": round(args.batch * td_one / td_bat, 2),
            "device_batched_mp_per_s":
                round(h * w * args.batch / 1e6 / td_bat, 3),
        }

    mp = h * w * args.batch / 1e6
    print(json.dumps({
        "metric": f"batched {args.batch}x pair-stitch {w}x{h} "
                  f"({jax.devices()[0].platform})",
        "batch": args.batch,
        "sequential_s": round(t_seq, 4),
        "batched_s": round(t_bat, 4),
        "speedup": round(t_seq / t_bat, 2),
        "batched_mp_per_s": round(mp / t_bat, 3),
        **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
