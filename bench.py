#!/usr/bin/env python
"""Benchmark: end-to-end 6-photo equirectangular stitch latency.

Headline config (BASELINE.md): 6 photos onto a 9000x4000 canvas,
iterative 5-pair stitching -- the reference reports <30 s on a
CUDA-era GPU (README.md:10-12,35).

Prints ONE json line:
  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": x, ...}
vs_baseline = reference_seconds / ours (>1 means faster than reference).
The line names the device and, on the GPU, the card's name and power
limit as nvidia-smi reports them.  Any failure exits non-zero.

Env overrides:
  PANOSTITCH_BENCH_CANVAS=WxH   (default 9000x4000)
  PANOSTITCH_BENCH_REPEATS=N    (default 1 timed repeat after warmup)
  PANOSTITCH_BENCH_ALG=NAME     (default pixflow_low_fast; also
                                 pixflow_low | pixflow_search_20 | ...)

The default preset is the framework's fast one (0.8-factor pyramid);
set PANOSTITCH_BENCH_ALG=pixflow_low for the reference-parity preset.
"""

import json
import os
import subprocess
import sys
import time

# the reference reports <30 s for the 9000x4000 (36 MP) stitch; scale
# the budget by canvas area when benching smaller sizes so vs_baseline
# stays apples-to-apples
REFERENCE_SECONDS = 30.0
REFERENCE_MP = 36.0


def card() -> str | None:
    """nvidia-smi's name and power limit of the card, None off the GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def run(w: int, h: int, repeats: int, alg: str) -> dict:
    from panorama_opticalflow_tpu.utils.runtime import init_runtime

    init_runtime(verbose=False)

    import jax

    from panorama_opticalflow_tpu.models import pipeline
    from panorama_opticalflow_tpu.utils import io as pio
    from panorama_opticalflow_tpu.utils.config import StitchConfig

    photos_np, top_np = pio.synthesize_fisheye_set(h, w, n=5, seed=0)
    dev = jax.devices()[0]
    photos = [jax.device_put(p, dev) for p in photos_np]
    top = jax.device_put(top_np, dev)
    cfg = StitchConfig(flow_alg=alg)

    # warmup / compile: the full chain
    t0 = time.perf_counter()
    jax.block_until_ready(pipeline.stitch_six(photos, top, cfg))
    compile_s = time.perf_counter() - t0

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(pipeline.stitch_six(photos, top, cfg))
        best = min(best, time.perf_counter() - t0)

    mp = h * w / 1e6
    ref_s = REFERENCE_SECONDS * mp / REFERENCE_MP
    return {
        "metric": f"6-photo {w}x{h} stitch latency ({alg}, {dev.platform})",
        "value": best,
        "unit": "s",
        "vs_baseline": ref_s / best,
        "reference_s_scaled": ref_s,
        "canvas_mp": mp,
        "mp_per_s": 5 * mp / best,
        "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card(),
    }


def main() -> int:
    canvas = os.environ.get("PANOSTITCH_BENCH_CANVAS", "9000x4000")
    repeats = int(os.environ.get("PANOSTITCH_BENCH_REPEATS", "1"))
    alg = os.environ.get("PANOSTITCH_BENCH_ALG", "pixflow_low_fast")
    w, h = (int(t) for t in canvas.split("x"))
    print(json.dumps(run(w, h, repeats, alg)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
