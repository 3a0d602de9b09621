#!/usr/bin/env python
"""Regenerate the golden stitched outputs pinned by tests/test_golden.py.

Run on the CPU backend (deterministic, no accelerator needed):

    python tools/make_golden.py

Goldens pin the *current* pipeline output so future optimisation rounds
can detect unintentional semantic drift; intentional algorithm changes
regenerate them (and the SSIM-vs-oracle gates in tests/test_pipeline.py
still guard absolute fidelity).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from panorama_opticalflow_tpu.models import pipeline  # noqa: E402
from panorama_opticalflow_tpu.utils import io as pio  # noqa: E402
from panorama_opticalflow_tpu.utils.config import StitchConfig  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden")


def cases():
    yield "six_96x320_s7", lambda: _six(96, 320, 7, "pixflow_low")
    yield "four_96x320_s1", lambda: _four(96, 320, 1, "pixflow_low")
    yield "six_64x256_s3_search20", lambda: _six(64, 256, 3,
                                                 "pixflow_search_20")


def _six(h, w, seed, alg):
    photos, top = pio.synthesize_fisheye_set(h, w, n=5, seed=seed)
    cfg = StitchConfig(flow_alg=alg)
    out = pipeline.stitch_six([jnp.asarray(p) for p in photos],
                              jnp.asarray(top), cfg)
    return np.asarray(out)


def _four(h, w, seed, alg):
    photos = pio.synthesize_four_input_set(h, w, seed=seed)
    cfg = StitchConfig(flow_alg=alg)
    out = pipeline.stitch_four([jnp.asarray(p) for p in photos], cfg)
    return np.asarray(out)


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, fn in cases():
        out = fn()
        path = os.path.join(GOLDEN_DIR, f"{name}.npz")
        np.savez_compressed(path, output=out)
        print(f"wrote {path}  shape={out.shape}")


if __name__ == "__main__":
    main()
