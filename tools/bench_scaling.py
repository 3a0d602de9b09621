#!/usr/bin/env python
"""Multi-device scaling-efficiency benchmark for the row-tiled stitch.

Runs tiled_stitch_pair over meshes of 1, 2, 4, ..., N devices on the
same canvas and reports throughput and parallel efficiency (the
BASELINE.md multi-host metric; on a single host this exercises the
host's devices (or virtual CPU devices), on a cluster run one process per host with
JAX_COORDINATOR_ADDRESS set and parallel/mesh.maybe_init_distributed).

Usage: python tools/bench_scaling.py [WxH] [--cpu N]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    canvas = sys.argv[1] if len(sys.argv) > 1 else "1152x512"
    w, h = (int(t) for t in canvas.split("x"))

    import jax

    if "--cpu" in sys.argv:
        n = int(sys.argv[sys.argv.index("--cpu") + 1])
        import os

        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={n}")
        jax.config.update("jax_platforms", "cpu")
    from panorama_opticalflow_tpu.utils.runtime import init_runtime

    init_runtime(verbose=False)

    import jax.numpy as jnp

    from panorama_opticalflow_tpu.models import pipeline
    from panorama_opticalflow_tpu.parallel import tiled
    from panorama_opticalflow_tpu.parallel.mesh import (make_mesh,
                                                        maybe_init_distributed)
    from panorama_opticalflow_tpu.utils import io as pio
    from panorama_opticalflow_tpu.utils.config import StitchConfig

    maybe_init_distributed()
    ndev = jax.device_count()
    photos = pio.synthesize_four_input_set(h, w, seed=0)
    il, ir = pipeline.compose_four(jnp.stack([jnp.asarray(p)
                                              for p in photos]))
    il, ir = np.asarray(il), np.asarray(ir)
    import os

    cfg = StitchConfig(flow_alg=os.environ.get("PANOSTITCH_BENCH_ALG",
                                               "pixflow_low"))
    tc = tiled.TileConfig.for_params(cfg.flow_params)

    devlist = os.environ.get("PANOSTITCH_SCALE_DEVICES")
    if devlist:
        ns = [int(t) for t in devlist.split(",") if int(t) <= ndev]
    else:
        ns, n = [], 1
        while n <= ndev:
            ns.append(n)
            n *= 2
    results = []
    for n in ns:
        mesh = make_mesh(n)
        t0 = time.time()
        out = tiled.tiled_stitch_pair(jnp.asarray(il), jnp.asarray(ir),
                                      cfg, mesh, "y", tc)
        _ = np.asarray(out)
        compile_s = time.time() - t0
        t0 = time.time()
        reps = 2
        for _ in range(reps):
            out = tiled.tiled_stitch_pair(jnp.asarray(il), jnp.asarray(ir),
                                          cfg, mesh, "y", tc)
        _ = np.asarray(out)
        dt = max((time.time() - t0) / reps, 1e-6)
        mp_s = h * w / 1e6 / dt
        results.append({"devices": n, "s": round(dt, 3),
                        "mp_per_s": round(mp_s, 2),
                        "compile_s": round(compile_s, 1)})

    base = results[0]["mp_per_s"]
    for r in results:
        r["efficiency"] = round(r["mp_per_s"] / (base * r["devices"]), 3)
    print(json.dumps({"canvas": canvas, "scaling": results}))


if __name__ == "__main__":
    main()
