#!/usr/bin/env python
"""Fidelity sweep of the relaxation schedule (phases x iters, hat D).

Runs ONE schedule variant per invocation (separate processes keep the
jit cache honest: StitchConfig hashes identically across variants) and
prints oracle-EPE + reference-binary-golden SSIM so schedules can be
compared before changing the FlowParams defaults.

The reference's own GPU build licenses the single-phase shape: 10
relaxation rounds, then ONE median, then diffusion per level
(GPU/PixFlow_GPU.cu:273-295) -- vs the CPU build's median after each of
2 sweeps (CPU/PixFlow.hpp:315-338).

Usage: python tools/sweep_schedule.py PHASES ITERS D [--e2e]
"""

import dataclasses
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

from panorama_opticalflow_tpu.utils.runtime import init_runtime  # noqa: E402

init_runtime(verbose=False)


def main():
    phases, iters, d = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

    from panorama_opticalflow_tpu.models import pixflow
    from panorama_opticalflow_tpu.utils import config as cfgmod

    base_factory = cfgmod.flow_params_by_name

    def patched(name):
        return dataclasses.replace(
            base_factory(name), relax_phases=phases,
            relax_iters_per_phase=iters, fast_window=d)

    cfgmod.flow_params_by_name = patched
    params = patched("pixflow_low")

    import oracle_pixflow as opf

    rng = np.random.default_rng(0)

    def shifted_pair(h, w, shift):
        base = (rng.random((h, w + 8, 4)) * 255).astype(np.uint8)
        base[..., 3] = 255
        import cv2

        sm = cv2.GaussianBlur(base[..., :3].astype(np.float32), (0, 0), 3)
        base[..., :3] = np.clip(sm, 0, 255).astype(np.uint8)
        i0 = base[:, :w].copy()
        i1 = base[:, shift:w + shift].copy()
        return i0, i1

    t0 = time.time()
    i0, i1 = shifted_pair(56, 88, 3)
    ours = np.asarray(pixflow.compute_optical_flow(
        jnp.asarray(i0), jnp.asarray(i1), params, "left"))
    ref = opf.compute_optical_flow(i0, i1, opf.P(0), "left")
    epe = float(np.sqrt(((ours - ref) ** 2).sum(-1)).mean())
    print(f"schedule {phases}x{iters} D={d}: oracle EPE {epe:.4f} "
          f"({time.time() - t0:.0f}s)")

    if "--e2e" in sys.argv:
        from panorama_opticalflow_tpu.models import pipeline
        from panorama_opticalflow_tpu.utils import io as pio
        from panorama_opticalflow_tpu.utils.config import StitchConfig
        from panorama_opticalflow_tpu.utils.metrics import ssim

        golden = pio.read_image_rgba(os.path.join(
            os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "golden"), "reference_binary_900x400_low.png"))
        photos, top = pio.synthesize_fisheye_set(400, 900, n=5, seed=0)
        t0 = time.time()
        out = np.asarray(pipeline.stitch_six(
            [jnp.asarray(p) for p in photos], jnp.asarray(top),
            StitchConfig(flow_alg="pixflow_low")))
        s = ssim(out[..., :3].astype(np.float32),
                 golden[..., :3].astype(np.float32))
        print(f"schedule {phases}x{iters} D={d}: reference-binary golden "
              f"SSIM {s:.4f} ({time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
