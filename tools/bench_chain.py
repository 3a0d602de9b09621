#!/usr/bin/env python
"""End-to-end and per-stage timing of the 6-photo chain (stitch_six).

    python tools/bench_chain.py [WxH] [alg] [--stages] [--xla-relax]
                                [--repeats N]

Prints JSON lines: compile seconds, the warm end-to-end latency (one
timed run after the compiling one, ending in block_until_ready) and the
device's peak memory.  ``--stages`` adds the split-program per-pair
stage times (geometry, blend, flows, finish), each ending in
block_until_ready, so they serialize the chain.  ``--xla-relax``
compiles the chain program twice, with the relax kernel and with XLA's
plain relaxation, and times them alternately (N rounds, default 5, the
order swapped every round, inputs already on the device): the
comparison that decides whether the kernel stays.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from panorama_opticalflow_tpu.utils.runtime import init_runtime  # noqa: E402

init_runtime(verbose=False)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from panorama_opticalflow_tpu.models import crop, pipeline  # noqa: E402
from panorama_opticalflow_tpu.utils import io as pio  # noqa: E402
from panorama_opticalflow_tpu.utils.config import StitchConfig  # noqa: E402


def end_to_end(photos, top, cfg, label):
    t0 = time.perf_counter()
    jax.block_until_ready(pipeline.stitch_six(photos, top, cfg))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(pipeline.stitch_six(photos, top, cfg))
    warm = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    print(json.dumps({"run": label, "alg": cfg.flow_alg,
                      "compile_s": compile_s, "latency_s": warm,
                      "peak_bytes_in_use": stats.get("peak_bytes_in_use")}),
          flush=True)


def stages(photos, top, cfg):
    windows = crop.plan_chain_windows(photos, top, cfg)
    result = top
    for i, (image_l, (roll, width, gsafe)) in enumerate(
            zip(photos, windows), 1):
        roll_j = jnp.asarray(roll)
        times = {}

        def run(name, fn, *a):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*a))
            times[name] = time.perf_counter() - t0
            return out

        canvas_map, ol, orr = run("geometry", pipeline._geometry_jit,
                                  image_l, result, cfg)
        blend_w = run("blend", pipeline._blend_window_jit, canvas_map,
                      roll_j, width, cfg)
        flr, frl = run("flows", pipeline._flows_window_jit, ol, orr, roll_j,
                       width, cfg)
        result = run("finish", lambda *a: pipeline._finish_windowed_jit(
            *a, gather_windowed=gsafe), canvas_map, ol, orr, blend_w,
            image_l, result, flr, frl, roll_j, width, cfg)
        print(json.dumps({"pair": i, "width": width,
                          **{k: v for k, v in times.items()}}), flush=True)


def chain_program(photos, top, cfg):
    """The compiled whole-chain program stitch_six dispatches to, and
    its arguments."""
    windows = crop.plan_chain_windows(photos, top, cfg)
    (width,) = {wd for _, wd, _ in windows}
    args = (jnp.stack(photos), top,
            jnp.asarray([r for r, _, _ in windows], jnp.int32),
            jnp.asarray([g for _, _, g in windows], bool))
    t0 = time.perf_counter()
    prog = pipeline._chain_windowed_jit.lower(*args, width, cfg).compile()
    return prog, args, time.perf_counter() - t0


def kernel_vs_xla(photos, top, cfg, repeats):
    """Relax kernel vs XLA's relaxation, alternating, on one device."""
    from panorama_opticalflow_tpu.ops.pallas import relax

    progs = {"relax kernel": chain_program(photos, top, cfg)}
    kept = relax.MIN_PIXELS
    relax.MIN_PIXELS = 1 << 62         # no level takes the kernel
    jax.clear_caches()
    try:
        progs["xla relax"] = chain_program(photos, top, cfg)
    finally:
        relax.MIN_PIXELS = kept
    times = {k: [] for k in progs}
    for k, (prog, args, _) in progs.items():
        jax.block_until_ready(prog(*args))
    for r in range(repeats):
        for k in (list(progs) if r % 2 == 0 else list(progs)[::-1]):
            prog, args, _ = progs[k]
            t0 = time.perf_counter()
            jax.block_until_ready(prog(*args))
            times[k].append(time.perf_counter() - t0)
    for k, ts in times.items():
        print(json.dumps({"run": k, "alg": cfg.flow_alg,
                          "compile_s": progs[k][2],
                          "median_s": statistics.median(ts),
                          "min_s": min(ts), "max_s": max(ts),
                          "times_s": ts}), flush=True)
    med = {k: statistics.median(ts) for k, ts in times.items()}
    print(json.dumps({"kernel_speedup_median":
                      med["xla relax"] / med["relax kernel"]}), flush=True)


def main():
    argv = sys.argv[1:]
    if "--repeats" in argv:
        del argv[argv.index("--repeats"):argv.index("--repeats") + 2]
    pos = [a for a in argv if not a.startswith("--")]
    w, h = (int(t) for t in (pos[0] if pos else "2250x1000").split("x"))
    alg = pos[1] if len(pos) > 1 else "pixflow_low_fast"
    cfg = StitchConfig(flow_alg=alg)
    photos_np, top_np = pio.synthesize_fisheye_set(h, w, n=5, seed=0)
    dev = jax.devices()[0]
    photos = [jax.device_put(p, dev) for p in photos_np]
    top = jax.device_put(top_np, dev)
    end_to_end(photos, top, cfg, "relax kernel")
    if "--stages" in sys.argv:
        stages(photos, top, cfg)
    if "--xla-relax" in sys.argv:
        repeats = 5
        if "--repeats" in sys.argv:
            repeats = int(sys.argv[sys.argv.index("--repeats") + 1])
        kernel_vs_xla(photos, top, cfg, repeats)


if __name__ == "__main__":
    main()
