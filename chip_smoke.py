#!/usr/bin/env python
"""Smoke run of the stitcher on one NVIDIA GPU, through its entry points.

    python chip_smoke.py                 # one card, phases 0-5
    python chip_smoke.py --four-cards    # the row-sharded pair on 4 cards

Phases, one JSON line each; any failure exits non-zero:

0. device check: JAX must find the GPU; the card's name and power limit.
1. the relax kernel against XLA's plain version at the finest flow level
   of the 36 MP chain (both directions batched): parity and time.
2. the three npz goldens of tests/golden, stitched on the card.
3. card vs CPU: the same 6-photo stitch in a child process held to the
   CPU, at a canvas where the relax kernel engages at the finest level.
4. the 36 MP main path: stitch_six (pixflow_low_fast, pixflow_low) and
   stitch_four (pixflow_low) at 9000x4000 -- compile time, one warm
   latency, peak device memory, output checks.

The last line is {"ok": true, "device": {...}}.  Inputs are synthetic,
from numpy with fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CANVAS = (4000, 9000)                 # (rows, cols): the 36 MP headline
GOLDENS = (                           # tests/test_golden.py
    ("six_96x320_s7", "six", (96, 320), 7, "pixflow_low"),
    ("four_96x320_s1", "four", (96, 320), 1, "pixflow_low"),
    ("six_64x256_s3_search20", "six", (64, 256), 3, "pixflow_search_20"),
)
# card-vs-CPU canvases, smallest first; the first whose finest flow
# level engages the relax kernel is used
PARITY_CANVASES = ((400, 900), (1000, 2250))


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------


def device_check(jax) -> dict:
    """The first device must be a GPU; returns the contract's device
    record.  Raises SmokeFailure on any other platform."""
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SmokeFailure(
            f"needs an NVIDIA GPU; JAX found platform {d.platform!r}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def gpu_name_and_limit() -> str:
    """nvidia-smi's own line, from a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# shared checks
# ---------------------------------------------------------------------------


def image_agreement(out: np.ndarray, ref: np.ndarray) -> dict:
    """The golden gate of tests/test_golden.py: alpha exact, SSIM, and
    the share of pixels off by more than 8."""
    from panorama_opticalflow_tpu.utils.metrics import ssim

    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    return {"alpha_equal": bool(np.array_equal(out[..., 3], ref[..., 3])),
            "ssim": float(ssim(out, ref)),
            "frac_off_gt8": float((diff > 8).mean())}


def agreement_ok(a: dict) -> bool:
    return a["alpha_equal"] and a["ssim"] >= 0.995 and a["frac_off_gt8"] < 0.01


def synth(kind: str, hw: tuple[int, int], seed: int):
    from panorama_opticalflow_tpu.utils import io as pio

    h, w = hw
    if kind == "six":
        return pio.synthesize_fisheye_set(h, w, n=5, seed=seed)
    return pio.synthesize_four_input_set(h, w, seed=seed), None


def stitch(kind: str, photos, top, alg: str):
    import jax.numpy as jnp

    from panorama_opticalflow_tpu.models import pipeline
    from panorama_opticalflow_tpu.utils.config import StitchConfig

    cfg = StitchConfig(flow_alg=alg)
    if kind == "six":
        return pipeline.stitch_six([jnp.asarray(p) for p in photos],
                                   jnp.asarray(top), cfg)
    return pipeline.stitch_four([jnp.asarray(p) for p in photos], cfg)


def finest_level(photos, top, alg: str) -> tuple[tuple[int, int], list]:
    """(rows, cols) of the chain's finest flow level and its windows."""
    import jax.numpy as jnp

    from panorama_opticalflow_tpu.models import crop
    from panorama_opticalflow_tpu.utils.config import StitchConfig

    cfg = StitchConfig(flow_alg=alg)
    wins = crop.plan_chain_windows([jnp.asarray(p) for p in photos],
                                   jnp.asarray(top), cfg)
    p = cfg.flow_params
    width = max(wd for _, wd, _ in wins)
    return (int(top.shape[0] * p.downscale_factor),
            int(width * p.downscale_factor)), wins


# ---------------------------------------------------------------------------
# phases 1-4
# ---------------------------------------------------------------------------


def phase_kernels(level: tuple[int, int], alg: str) -> None:
    from panorama_opticalflow_tpu.ops.pallas import relax
    from panorama_opticalflow_tpu.utils.config import flow_params_by_name

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from bench_kernels import bench_relax

    params = flow_params_by_name(alg)
    xla, kern = bench_relax(level, params, params.relax_iters_per_phase,
                            [(relax.BLOCK, relax.NUM_WARPS)])
    ok = (kern["finite"] and kern["mean_abs"] <= 1e-5
          and kern["p9999_abs"] <= 1e-3)
    emit("1_kernels", kernel="relax_propagate+relax_descend", alg=alg,
         shape=kern["shape"], iters=kern["iters"], block=kern["block"],
         num_warps=kern["num_warps"], kernel_ms=kern["ms"],
         xla_ms=xla["ms"], speedup_vs_xla=kern["speedup_vs_xla"],
         kernel_compile_s=kern["compile_s"], xla_compile_s=xla["compile_s"],
         mean_abs=kern["mean_abs"], p9999_abs=kern["p9999_abs"],
         max_abs=kern["max_abs"], ok=ok)
    require(ok, "relax kernel outside its tolerance against XLA's version")


def phase_goldens() -> None:
    for name, kind, hw, seed, alg in GOLDENS:
        golden = np.load(os.path.join(REPO, "tests", "golden",
                                      f"{name}.npz"))["output"]
        photos, top = synth(kind, hw, seed)
        out = np.asarray(stitch(kind, photos, top, alg))
        a = image_agreement(out, golden)
        ok = out.shape == golden.shape and agreement_ok(a)
        emit("2_golden", golden=name, alg=alg, **a, ok=ok)
        require(ok, f"golden {name} mismatch")


_CPU_CHILD = """
import sys, numpy as np
sys.path.insert(0, {repo!r})
import chip_smoke as cs
import jax
assert jax.default_backend() == "cpu", jax.default_backend()
photos, top = cs.synth("six", {hw!r}, 0)
outs = {{alg: np.asarray(cs.stitch("six", photos, top, alg))
        for alg in {algs!r}}}
np.savez({path!r}, **outs)
"""


def parity_canvas(algs) -> tuple[int, int]:
    """The smallest PARITY_CANVASES entry whose finest flow level
    engages the relax kernel for every preset."""
    from panorama_opticalflow_tpu.ops.pallas import relax

    for hw in PARITY_CANVASES:
        photos, top = synth("six", hw, 0)
        if all(relax.use_relax_kernel(*finest_level(photos, top, alg)[0])
               for alg in algs):
            return hw
    raise SmokeFailure("no parity canvas engages the relax kernel")


def start_cpu_child(hw, algs, path: str) -> subprocess.Popen:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    code = _CPU_CHILD.format(repo=REPO, hw=hw, algs=tuple(algs), path=path)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def phase_card_vs_cpu(child: subprocess.Popen, hw, algs, path: str) -> None:
    photos, top = synth("six", hw, 0)
    outs = {alg: np.asarray(stitch("six", photos, top, alg)) for alg in algs}
    t0 = time.perf_counter()
    _, err = child.communicate(timeout=900)
    require(child.returncode == 0,
            f"CPU child failed:\n{err[-2000:]}")
    cpu = np.load(path)
    for alg in algs:
        a = image_agreement(outs[alg], cpu[alg])
        ok = agreement_ok(a)
        emit("3_card_vs_cpu", canvas=[hw[1], hw[0]], alg=alg, **a,
             cpu_wait_s=time.perf_counter() - t0, ok=ok)
        require(ok, f"card vs CPU mismatch ({alg})")


def phase_main_path(jax, kind: str, alg: str, photos, top) -> None:
    t0 = time.perf_counter()
    out = jax.block_until_ready(stitch(kind, photos, top, alg))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(stitch(kind, photos, top, alg))
    latency_s = time.perf_counter() - t0
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    if kind == "six":
        _, wins = finest_level(photos, top, alg)
        widths = [wd for _, wd, _ in wins]
    else:
        from panorama_opticalflow_tpu.models import crop, pipeline, stitcher
        from panorama_opticalflow_tpu.utils.config import StitchConfig
        import jax.numpy as jnp

        il, ir = pipeline.compose_four(jnp.stack(
            [jnp.asarray(p) for p in photos]))
        widths = [crop.pair_window(stitcher.match_images(il, ir),
                                   StitchConfig(flow_alg=alg))[1]]
    out = np.asarray(out)
    opaque = float((out[..., 3] > 0).mean())
    ok = (out.shape == (*CANVAS, 4) and bool(np.isfinite(out).all())
          and opaque > 0.99)
    emit("4_main_path", entry=f"stitch_{kind}", alg=alg,
         canvas=[CANVAS[1], CANVAS[0]], compile_s=compile_s,
         latency_s=latency_s, peak_bytes_in_use=peak, window_widths=widths,
         opaque_frac=opaque, ok=ok)
    require(ok, f"stitch_{kind} {alg}: bad output")


def run_one_card(jax) -> None:
    algs = ("pixflow_low_fast", "pixflow_low")
    photos, top = synth("six", CANVAS, 0)
    level, _ = finest_level(photos, top, algs[0])
    hw = parity_canvas(algs)
    cache = os.path.join(REPO, ".cache")
    os.makedirs(cache, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cache) as tmp:
        path = os.path.join(tmp, "cpu.npz")
        # the CPU child runs while the card works on phases 1-2
        child = start_cpu_child(hw, algs, path)
        try:
            phase_kernels(level, algs[0])
            phase_goldens()
            phase_card_vs_cpu(child, hw, algs, path)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    for alg in algs:
        phase_main_path(jax, "six", alg, photos, top)
    del photos, top
    four, _ = synth("four", CANVAS, 0)
    phase_main_path(jax, "four", "pixflow_low", four, None)


def run_four_cards(jax) -> None:
    """The row-sharded pair on a 4-card mesh vs one card."""
    import jax.numpy as jnp

    from panorama_opticalflow_tpu.models import crop, pipeline, stitcher
    from panorama_opticalflow_tpu.parallel import tiled
    from panorama_opticalflow_tpu.parallel.mesh import make_mesh
    from panorama_opticalflow_tpu.utils.config import StitchConfig
    from panorama_opticalflow_tpu.utils.metrics import ssim

    require(len(jax.devices()) >= 4, "--four-cards needs 4 GPUs")
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    photos, top = synth("six", CANVAS, 0)
    il = jax.device_put(photos[0], jax.devices()[0])
    ir = jax.device_put(top, jax.devices()[0])
    mesh = make_mesh(4)
    fns = {"one_card": lambda: pipeline.stitch_pair_auto(il, ir, cfg),
           "four_cards": lambda: tiled.tiled_stitch_pair_auto(
               il, ir, cfg, mesh)}
    first = {}

    def first_call(name):
        t0 = time.perf_counter()
        jax.block_until_ready(fns[name]())
        first[name] = time.perf_counter() - t0

    # the two programs compile side by side (XLA compiles off the GIL);
    # each first call's time is its compile under that contention
    with ThreadPoolExecutor(len(fns)) as pool:
        for job in [pool.submit(first_call, name) for name in fns]:
            job.result()
    emit("four_cards_compiled", **{f"{k}_compile_s": v
                                   for k, v in first.items()})
    times = {}
    for name, fn in fns.items():
        t0 = time.perf_counter()
        times[name] = (np.asarray(jax.block_until_ready(fn())), first[name],
                       time.perf_counter() - t0)
    one, four = times["one_card"][0], times["four_cards"][0]
    roll, width, _ = crop.pair_window(stitcher.match_images(il, ir), cfg)
    win = np.roll(np.arange(CANVAS[1]), -roll)[:width]
    s_win = float(ssim(four[:, win], one[:, win]))
    interior = np.s_[16:-16]
    same = float((four[interior] == one[interior]).all(-1).mean())
    ok = four.shape == one.shape and s_win >= 0.995
    emit("four_cards", alg=cfg.flow_alg, canvas=[CANVAS[1], CANVAS[0]],
         window_width=width, ssim_window=s_win,
         frac_interior_bit_identical=same,
         one_card_compile_s=times["one_card"][1],
         one_card_latency_s=times["one_card"][2],
         four_cards_compile_s=times["four_cards"][1],
         four_cards_latency_s=times["four_cards"][2], ok=ok)
    require(ok, "4-card stitch disagrees with one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the row-sharded pair on 4 cards")
    args = ap.parse_args(argv)

    import jax

    try:
        device = device_check(jax)
    except SmokeFailure as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    smi = gpu_name_and_limit()
    emit("0_device", **device, nvidia_smi=smi)
    print(smi, flush=True)

    sys.path.insert(0, REPO)
    from panorama_opticalflow_tpu.utils.runtime import init_runtime

    init_runtime(verbose=False)
    try:
        if args.four_cards:
            run_four_cards(jax)
        else:
            run_one_card(jax)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if args.four_cards:
        device["count"] = len(jax.devices())
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
