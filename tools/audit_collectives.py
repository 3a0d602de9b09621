#!/usr/bin/env python
"""Static collective audit of the sharded stitch program (VERDICT r3 #8).

Lowers the production windowed ``tiled_stitch_pair`` program on an
N-virtual-device CPU mesh at a given canvas and counts every collective
in the StableHLO -- op kind, operand shape, bytes moved, and the source
function it lowered from -- then aggregates.  This is the analytic
backing for the scaling claim: the per-device-constant overhead term is
exactly these collectives plus halo recompute, and their bytes must
shrink (or stay constant) per device as the mesh grows.

Usage: python tools/audit_collectives.py [WxH] [--n N] [--alg NAME]
"""

import json
import os
import re
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    canvas = args[0] if args else "9000x4000"
    w, h = (int(t) for t in canvas.split("x"))
    n = int(sys.argv[sys.argv.index("--n") + 1]) if "--n" in sys.argv else 8
    alg = (sys.argv[sys.argv.index("--alg") + 1]
           if "--alg" in sys.argv else "pixflow_low_fast")

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={n}")
    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from panorama_opticalflow_tpu.models import crop
    from panorama_opticalflow_tpu.parallel import tiled
    from panorama_opticalflow_tpu.parallel.mesh import make_mesh
    from panorama_opticalflow_tpu.utils.config import StitchConfig

    cfg = StitchConfig(flow_alg=alg)
    tc = tiled.TileConfig.for_params(cfg.flow_params)
    mesh = make_mesh(n)

    # production overlap window width at this canvas (the 6-input chain
    # windows are all this shape class): side photos overlap by half a
    # photo width; crop.pair_window's width for the synthetic layout is
    # ~0.45 * w -- use a representative 40% window
    width = crop.choose_bucket(int(0.40 * w), w)
    fn = tiled._tiled_stitch_jit(mesh, "y", n, h, cfg, tc, width, True,
                                 False)
    hp = -(-h // n) * n
    sd = jax.ShapeDtypeStruct((hp, w, 4), jnp.uint8)
    roll = jax.ShapeDtypeStruct((), jnp.int32)
    print(f"tracing {w}x{h} on {n}-device mesh (alg={alg}, "
          f"window width={width})...", flush=True)
    lowered = fn.lower(sd, sd, roll)
    txt = lowered.as_text(debug_info=True)

    # operand signature is after ": (" -- the first tensor<> on the line
    # may be a replica_groups attribute; loc(...) is usually a #locN
    # reference into the module's trailing loc table
    pat = re.compile(
        r'"stablehlo\.(all_gather|all_to_all|collective_permute|all_reduce|'
        r'reduce_scatter)"[^\n]*?: \(tensor<([^>]*)>[^\n]*?loc\((#?[\w]+)')
    loc_defs = dict(re.findall(r'^(#loc[\w]+) = loc\((.*)\)\s*$', txt,
                               re.MULTILINE))

    def resolve_loc(ref, depth=0):
        if depth > 3:
            return ""
        body = loc_defs.get(ref, ref)
        out = body
        for sub in re.findall(r'#loc[\w]+', body):
            out += " " + resolve_loc(sub, depth + 1)
        return out
    dt_bytes = {"f32": 4, "f64": 8, "bf16": 2, "f16": 2, "i32": 4,
                "ui32": 4, "i8": 1, "ui8": 1, "i16": 2, "ui16": 2,
                "i1": 1, "i64": 8}

    def shape_bytes(s):
        parts = s.split("x")
        dims = [int(p) for p in parts[:-1] if p.isdigit()]
        b = dt_bytes.get(parts[-1], 4)
        for d in dims:
            b *= d
        return b

    agg = defaultdict(lambda: [0, 0])
    total = [0, 0]
    for m in pat.finditer(txt):
        kind, shape, loc = m.group(1), m.group(2), resolve_loc(m.group(3))
        srcs = re.findall(r'/[\w/]*?([\w.]+\.py)":(\d+)', loc)
        src = f"{srcs[0][0]}:{srcs[0][1]}" if srcs else "?"
        by = shape_bytes(shape)
        key = (kind, src)
        agg[key][0] += 1
        agg[key][1] += by
        total[0] += 1
        total[1] += by

    rows = sorted(((k, v) for k, v in agg.items()),
                  key=lambda kv: -kv[1][1])
    print(f"{'op':<20} {'source':<28} {'count':>6} "
          f"{'MB total (per-shard)':>22}")
    for (kind, src), (cnt, by) in rows:
        print(f"{kind:<20} {src:<28} {cnt:>6} {by/1e6:>12.2f}")
    print(json.dumps({"canvas": canvas, "devices": n, "alg": alg,
                      "collective_count": total[0],
                      "collective_mb": round(total[1] / 1e6, 2)}))


if __name__ == "__main__":
    main()
