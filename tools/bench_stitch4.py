#!/usr/bin/env python
"""Benchmark the 4-input single-pass stitch (BASELINE config 1;
CPU_4Input/main.cpp:47-119).  The reference binary measured on this box:
3.45 s at 2250x1000 (MEASURED_BASELINE.json).

Prints one JSON line.  Usage:
  python tools/bench_stitch4.py [--canvas WxH] [--repeats N]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--canvas", default="2250x1000")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--flow_alg", default="pixflow_low")
    args = ap.parse_args()
    w, h = (int(t) for t in args.canvas.split("x"))

    from panorama_opticalflow_tpu.utils.runtime import init_runtime

    init_runtime(verbose=False)

    import jax
    import numpy as np

    from panorama_opticalflow_tpu.models import pipeline
    from panorama_opticalflow_tpu.utils import io as pio
    from panorama_opticalflow_tpu.utils.config import StitchConfig

    cfg = StitchConfig(flow_alg=args.flow_alg)
    dev = jax.devices()[0]
    photos = [jax.device_put(p, dev)
              for p in pio.synthesize_four_input_set(h, w, seed=0)]

    force = jax.block_until_ready

    t0 = time.time()
    force(pipeline.stitch_four(photos, cfg))
    compile_s = time.time() - t0

    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.time()
        force(pipeline.stitch_four(photos, cfg))
        best = min(best, time.time() - t0)

    measured = None
    try:
        with open(os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "MEASURED_BASELINE.json")) as f:
            measured = json.load(f)[f"stitch4_{args.flow_alg}"].get(
                f"{w}x{h}")
    except Exception:  # noqa: BLE001
        pass
    extra = {}
    if measured:
        extra = {"measured_ref_s": measured,
                 "vs_measured_ref": round(measured / best, 2)}
    print(json.dumps({
        "metric": f"4-input {w}x{h} single-pass stitch "
                  f"({args.flow_alg}, {dev.platform})",
        "value": round(best, 4),
        "unit": "s",
        "mp_per_s": round(h * w / 1e6 / best, 1),
        "compile_s": round(compile_s, 1),
        "device": str(dev),
        **extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
