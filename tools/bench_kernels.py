#!/usr/bin/env python
"""Relax kernel and median variants against XLA's plain versions, at the
finest flow level of the 36 MP chain (both directions batched).

    python tools/bench_kernels.py [--sweep] [--threshold] [--out FILE]

Prints one JSON line per measurement.  ``--sweep`` times the relax
kernel over a grid of program tiles and warp counts, ``--threshold``
over small level sizes.  Needs the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def finest_level_shape(alg: str, h: int = 4000, w: int = 9000):
    """(rows, cols) of the finest flow level of the 6-photo chain."""
    import jax.numpy as jnp

    from panorama_opticalflow_tpu.models import crop
    from panorama_opticalflow_tpu.utils import io as pio
    from panorama_opticalflow_tpu.utils.config import StitchConfig

    cfg = StitchConfig(flow_alg=alg)
    photos, top = pio.synthesize_fisheye_set(h, w, n=5, seed=0)
    wins = crop.plan_chain_windows([jnp.asarray(p) for p in photos],
                                   jnp.asarray(top), cfg)
    width = max(wd for _, wd, _ in wins)
    p = cfg.flow_params
    return int(h * p.downscale_factor), int(width * p.downscale_factor)


def relax_inputs(shape, seed: int = 0):
    """Smooth random level inputs, (2, H, W[, 2]) per plane."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    b, h, w = 2, *shape

    def smooth(scale, c=None):
        sh = (b, h // 8 + 2, w // 8 + 2) + ((c,) if c else ())
        x = rng.standard_normal(sh).astype(np.float32)
        x = np.repeat(np.repeat(x, 8, 1), 8, 2)[:, :h, :w]
        return x * scale

    grad = lambda: smooth(0.05) + rng.standard_normal(  # noqa: E731
        (b, h, w)).astype(np.float32) * 0.02
    flow = smooth(2.0, 2)
    f_base = flow + smooth(0.3, 2)
    w1g = np.stack([grad(), grad()], -1)
    bf = flow + smooth(0.2, 2)
    mask = rng.random((b, h, w)) > 0.05
    return [jnp.asarray(a) for a in
            (flow, f_base, w1g, grad(), grad(), bf, mask)]


def flow_diff_stats(got, ref) -> dict:
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    return {"mean_abs": float(d.mean()),
            "p9999_abs": float(np.quantile(d, 0.9999)),
            "max_abs": float(d.max()),
            "finite": bool(np.isfinite(np.asarray(got)).all())}


def bench_relax(shape, params, iters: int, configs):
    """Yields one row for XLA's plain relax, then one per kernel config
    (block, num_warps), each with its compile time."""
    import time

    import jax

    from panorama_opticalflow_tpu.ops import relax_fast as rf
    from panorama_opticalflow_tpu.ops.pallas import relax
    from panorama_opticalflow_tpu.utils.runtime import time_call

    args = relax_inputs(shape)
    D = params.fast_window
    xla = jax.jit(jax.vmap(
        lambda *a: rf.relax_phase_fast(*a, params, iters, D)))
    t0 = time.perf_counter()
    ref = np.asarray(xla(*args))
    compile_s = time.perf_counter() - t0
    t_xla = time_call(xla, *args, iters=10)
    yield {"phase": "relax", "impl": "xla", "shape": [2, *shape],
           "iters": iters, "ms": t_xla * 1e3, "compile_s": compile_s}
    for block, warps in configs:
        block = block or relax.BLOCK
        warps = warps or relax.NUM_WARPS
        kern = jax.jit(jax.vmap(lambda *a, block=block, warps=warps:
                                relax.relax_phase_kernel(
                                    *a, params, iters, D, block=block,
                                    num_warps=warps)))
        t0 = time.perf_counter()
        got = np.asarray(kern(*args))
        compile_s = time.perf_counter() - t0
        t = time_call(kern, *args, iters=10)
        yield {"phase": "relax", "impl": "kernel", "block": list(block),
               "num_warps": warps, "shape": [2, *shape], "iters": iters,
               "ms": t * 1e3, "compile_s": compile_s,
               "speedup_vs_xla": t_xla / t, **flow_diff_stats(got, ref)}


def bench_median(shape) -> list[dict]:
    """The sorting-network median against a sort of the 25-stack."""
    import jax
    import jax.numpy as jnp

    from panorama_opticalflow_tpu.ops import image as im
    from panorama_opticalflow_tpu.utils.runtime import time_call

    def by_sort(p):
        return jnp.sort(jnp.stack(im._median5_shifts(p)), axis=0)[12]

    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (4, *shape)).astype(np.float32))
    res = {}
    for name, fn in (("sort", by_sort), ("network", im.median5)):
        f = jax.jit(jax.vmap(fn))
        res[name] = (np.asarray(f(x)), time_call(f, x, iters=10))
    equal = bool(np.array_equal(res["sort"][0], res["network"][0]))
    return [{"phase": "median5", "impl": k, "shape": [4, *shape],
             "ms": v[1] * 1e3, "equal_to_sort": equal}
            for k, v in res.items()]


def bench_threshold(params) -> list[dict]:
    """Relax kernel vs XLA on small levels: where the kernel starts to
    pay (relax.MIN_PIXELS)."""
    out = []
    for shape in ((64, 256), (128, 256), (128, 512), (256, 512),
                  (256, 1024), (512, 1024)):
        xla, kern = bench_relax(shape, params, params.relax_iters_per_phase,
                                [(None, None)])
        out.append({"phase": "threshold", "shape": list(shape),
                    "pixels": shape[0] * shape[1], "xla_ms": xla["ms"],
                    "kernel_ms": kern["ms"],
                    "speedup_vs_xla": kern["speedup_vs_xla"]})
    return out


def gpu_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--threshold", action="store_true",
                    help="also time kernel vs XLA on small levels")
    ap.add_argument("--alg", default="pixflow_low_fast")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from panorama_opticalflow_tpu.utils.runtime import init_runtime

    init_runtime(verbose=False)
    import jax

    from panorama_opticalflow_tpu.ops.pallas import relax
    from panorama_opticalflow_tpu.utils.config import flow_params_by_name

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs the GPU, found {dev.platform}", file=sys.stderr)
        return 1
    print(gpu_name())
    shape = finest_level_shape(args.alg)
    params = flow_params_by_name(args.alg)
    configs = [(relax.BLOCK, relax.NUM_WARPS)]
    if args.sweep:
        configs += [((8, 64), 4), ((16, 64), 4), ((4, 128), 4),
                    ((8, 128), 8), ((8, 32), 2)]
    print(json.dumps({"finest_level": list(shape)}), flush=True)
    rows = []
    for r in bench_median(shape):
        rows.append(r)
        print(json.dumps({**r, "device": dev.device_kind}), flush=True)
    for r in bench_relax(shape, params, params.relax_iters_per_phase,
                         configs):
        rows.append(r)
        print(json.dumps({**r, "device": dev.device_kind}), flush=True)
    if args.threshold:
        for r in bench_threshold(params):
            rows.append(r)
            print(json.dumps({**r, "device": dev.device_kind}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
