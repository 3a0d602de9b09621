"""Hybrid sharded pixflow: the per-level solver OUTSIDE shard_map.

The sharded flow solve is structured as:

* shard_map bodies keep ONLY data movement and collectives -- halo
  exchanges (ppermute), row/column resizes, the final blur;
* the per-level solver runs BETWEEN those segments on halo-extended
  row-tile stacks ``(T, 2, h_loc + 2*halo, W)`` under ordinary
  GSPMD/Shardy partitioning (the tile batch dim is sharded over the row
  mesh), with the relax kernel partitioned over that batch dim through
  a minimal one-kernel shard_map (ops/pallas/partition.PartitionedKernels);
* pyramid levels too small to tile are computed replicated (plain
  ``models.pixflow`` calls on replicated arrays, the relax kernel in the
  same one-kernel shard_map with replicated operands), identical work
  per device, exactly like the all-inside-shard_map path.

Semantics match parallel.tiled.tiled_compute_optical_flow_pair level by
level (same halo widths, same resize plans, same replication threshold),
so the tiled-vs-untiled fidelity gates transfer.  The reference parallel
analogue is the CUDA data-parallel sweep kernel + device dispatch
(GPU/PixFlow_GPU.cu:153-296, GPU/OpticalFlow.cpp:132-155); scaling
beyond one device has no reference counterpart.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from panorama_opticalflow_tpu.models import pixflow
from panorama_opticalflow_tpu.ops import image as im
from panorama_opticalflow_tpu.utils.config import FlowParams


def _seg(mesh, body, in_specs, out_specs):
    """A tiny shard_map segment (halo exchange / resize / collectives
    only -- never the solver)."""
    return shard_map(body, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)


def _resize_rows_tiles(x: jax.Array, plan, halo: int, n: int) -> jax.Array:
    """Per-tile axis-1 row resize of a halo-extended tile stack, in
    GSPMD-land (no shard_map segment): ``x`` is (n, h_a + 2*halo, W, C)
    -- the solver's halo-extended output -- and the static per-tile
    local source indices come straight from the global resize plan
    (plan.halo <= halo, asserted by the caller).  Row taps within
    ``plan.halo`` of a tile edge read the tile's own halo rows instead
    of the neighbour's canonical interior values; those rows sit
    ``halo - plan.halo`` deep, beyond the solver's hard receptive
    radius, so the difference is bounded by the same flow-sample-margin
    approximation the tiled path already documents (gated by the
    tiled-vs-untiled SSIM tests).  Saves one shard_map segment (an
    exchange + two region transitions) per pyramid level."""
    import numpy as np

    nb, hh, w, c = x.shape
    assert nb == n
    k = plan.idx.shape[1]
    idx = plan.idx.reshape(n, plan.h_b, k)
    base = (np.arange(n) * plan.h_a - halo)[:, None, None]
    local = np.clip(idx - base, 0, hh - 1)
    wts = plan.w.reshape(n, plan.h_b, k).astype(np.float32)

    r_iota = jax.lax.broadcasted_iota(jnp.int32, (n, plan.h_b, hh), 2)
    a = jnp.zeros((n, plan.h_b, hh), jnp.float32)
    for m in range(k):
        a = a + jnp.where(r_iota == jnp.asarray(local[:, :, m:m + 1]),
                          jnp.asarray(wts[:, :, m:m + 1]), 0.0)
    flat = x.astype(jnp.float32).reshape(n, hh, w * c)
    out = jnp.einsum("nij,njk->nik", a, flat,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape(n, plan.h_b, w, c)


def _rep(mesh):
    return NamedSharding(mesh, P())


def _rows(mesh, axis):
    return NamedSharding(mesh, P(axis))


def hybrid_flow_pair(rgba0: jax.Array, rgba1: jax.Array, params: FlowParams,
                     hints: tuple[str, str], mesh, axis: str, n: int,
                     h_global: int, tc) -> tuple[jax.Array, jax.Array]:
    """Row-sharded pixflow pair on GLOBAL arrays.

    ``rgba0``/``rgba1`` are (n * h_loc, W, 4) uint8 with rows sharded
    P(axis) (pad rows transparent); returns (flow01, flow10) global
    (n * h_loc, W, 2) float32, rows sharded.  Must be called inside a
    jit (the stitch program builder, parallel.tiled._tiled_stitch_jit).
    """
    # local import: tiled imports this module lazily, avoid a cycle
    from panorama_opticalflow_tpu.parallel import tiled as T
    from panorama_opticalflow_tpu.ops.pallas import partition

    h_pad, w = rgba0.shape[:2]
    assert h_pad % n == 0
    # partitioned wrappers engage at n == 1 too, so one device runs the
    # exact kernel-invocation path the mesh uses
    knd = partition.PartitionedKernels(mesh, axis)
    knd_rep = partition.PartitionedKernels(mesh, None)

    dh = int(h_global * params.downscale_factor)
    dw = int(w * params.downscale_factor)
    sf = params.pyr_scale_factor

    sizes = pixflow.pyramid_sizes(dh, dw, params)
    tiled_level = [sizes[k][0] // n >= max(tc.min_tiled_rows,
                                           tc.level_halo + 1)
                   for k in range(len(sizes))]
    # the coarsest level always runs replicated: it needs the
    # zero/search init (direction hints), is tiny at production aspect
    # ratios anyway, and whole-canvas init matches the untiled solver's
    # semantics exactly (per-tile init would fragment the search)
    tiled_level[-1] = False
    # leading tiled span [0, n_tiled) -- tiled_level is monotone (rows
    # shrink), so one flag flip
    n_tiled = next((k for k in range(len(sizes)) if not tiled_level[k]),
                   len(sizes))

    # ---- ONE segment: prep (downscale + grey/alpha + pre-blur) and
    # every tiled pyramid level, channel-stacked [i0, a0, i1, a1] ----
    plan_ds = T.make_row_resize_plan(h_global, dh, n, "cubic")

    def prep_pyr_body(r0, r1):
        outs = []
        for rgba in (r0, r1):
            r = T._tiled_resize_cols(
                T._tiled_resize_rows(rgba.astype(jnp.float32), plan_ds, axis),
                dw, "cubic")
            r = jnp.clip(jnp.rint(r), 0, 255).astype(jnp.uint8)
            i = im.rgba_to_gray_u8(r).astype(jnp.float32) / 255.0
            a = r[..., 3].astype(jnp.float32) / 255.0
            i = T._tiled_gaussian_blur(i, params.pre_blur_kernel_width,
                                       params.pre_blur_sigma, axis)
            outs.append(jnp.stack([i, a], axis=-1))
        levels = [jnp.concatenate(outs, axis=-1)]  # (hb0, dw, 4) local
        for k in range(1, n_tiled):
            (ph, _), (nh, nw) = sizes[k - 1], sizes[k]
            plan = T.make_row_resize_plan(ph, nh, n, "linear")
            levels.append(T._tiled_resize_cols(
                T._tiled_resize_rows(levels[-1], plan, axis), nw, "linear"))
        return tuple(levels)

    pyr = list(_seg(mesh, prep_pyr_body, (P(axis), P(axis)),
                    (P(axis),) * max(n_tiled, 1))(rgba0, rgba1))

    # ---- replicated tail levels (gather once, then plain resizes) ----
    replicated = n_tiled == 0
    if replicated:
        pyr[0] = jax.lax.with_sharding_constraint(pyr[0], _rep(mesh))[:dh]
    for k in range(max(n_tiled, 1), len(sizes)):
        (ph, _), (nh, nw) = sizes[k - 1], sizes[k]
        prev = pyr[-1]
        if not replicated:
            prev = jax.lax.with_sharding_constraint(prev, _rep(mesh))[:ph]
            replicated = True
        pyr.append(im.resize(prev, (nh, nw), "linear"))

    def rep_level_planes(k):
        p = pyr[k]
        return (jnp.stack([p[..., 0], p[..., 2]]),     # imgs  (2, h, w)
                jnp.stack([p[..., 1], p[..., 3]]))     # alphas (2, h, w)

    def to_b(fc):   # (h, w, 4) channels -> (2, h, w, 2) batch
        return jnp.stack([fc[..., :2], fc[..., 2:]], axis=0)

    def to_c(fb):   # inverse
        return jnp.concatenate([fb[0], fb[1]], axis=-1)

    def upsample_rep(fc, level):
        """Replicated channel-form flow -> level - 1 (sharding back to
        rows when the next level is tiled)."""
        nh, nw = sizes[level - 1]
        up = im.resize(fc, (nh, nw), "cubic") * (1.0 / sf)
        if tiled_level[level - 1]:
            hb = T._cdiv(nh, n)
            up = jnp.pad(up, ((0, n * hb - nh), (0, 0), (0, 0)))
            up = jax.lax.with_sharding_constraint(up, _rows(mesh, axis))
        return up

    # ---- replicated coarse tail (plain pixflow, GSPMD-replicated) ----
    r0 = next((k for k in range(len(sizes)) if not tiled_level[k]),
              len(sizes))
    first_scanned, rungs = pixflow._plan_rungs(sizes, params, lo=r0)

    p_i0 = [pyr[k][..., 0] if k >= r0 else None for k in range(len(sizes))]
    p_a0 = [pyr[k][..., 1] if k >= r0 else None for k in range(len(sizes))]
    p_i1 = [pyr[k][..., 2] if k >= r0 else None for k in range(len(sizes))]
    p_a1 = [pyr[k][..., 3] if k >= r0 else None for k in range(len(sizes))]

    flow_c = None
    start = len(sizes) - 1
    if rungs:
        nl = len(sizes)
        imgs, alphas = rep_level_planes(nl - 1)
        fb = pixflow.patch_match_level_batched(imgs, alphas, None, hints,
                                               params, knd_rep)

        def rbody(imgs_i, alphas_i, f):
            return pixflow.patch_match_level_batched(imgs_i, alphas_i, f,
                                                     hints, params, knd_rep)

        fb = pixflow._run_rungs(rungs, sizes, [p_i0, p_i1], [p_a0, p_a1],
                                fb, rbody, params)
        flow_c = upsample_rep(to_c(fb), first_scanned)
        start = first_scanned - 1

    for level in range(start, -1, -1):
        lh, lw = sizes[level]
        if not tiled_level[level]:
            imgs, alphas = rep_level_planes(level)
            fb = None if flow_c is None else to_b(flow_c)
            flow_c = to_c(pixflow.patch_match_level_batched(
                imgs, alphas, fb, hints, params, knd_rep))
            if level > 0:
                flow_c = upsample_rep(flow_c, level)
        else:
            halo = tc.level_halo
            hb = T._cdiv(lh, n)

            # halo-stack segment: one exchange over the 8 channels
            def hx_body(p, f):
                e = T._exchange_rows(jnp.concatenate([p, f], axis=-1),
                                     halo, axis)
                return e[None]

            st = _seg(mesh, hx_body, (P(axis), P(axis)), P(axis))(
                pyr[level], flow_c)               # (n, hb + 2*halo, lw, 8)
            imgs_t = jnp.stack([st[..., 0], st[..., 2]], axis=1)
            alphas_t = jnp.stack([st[..., 1], st[..., 3]], axis=1)
            flow_t = jnp.stack([st[..., 4:6], st[..., 6:8]], axis=1)

            ft = pixflow.patch_match_level_tiles(imgs_t, alphas_t, flow_t,
                                                 params, knd)
            fc = jnp.concatenate([ft[:, 0], ft[:, 1]], axis=-1)
            if level > 0:
                # in-GSPMD upsample straight off the halo-extended
                # solver output (level - 1 is finer, hence also tiled)
                nh, nw = sizes[level - 1]
                plan = T.make_row_resize_plan(lh, nh, n, "cubic")
                assert plan.halo <= halo, (plan.halo, halo)
                up = _resize_rows_tiles(fc, plan, halo, n)
                up = T._tiled_resize_cols(
                    up.reshape(n * plan.h_b, lw, 4), nw, "cubic") \
                    * (1.0 / sf)
                flow_c = jax.lax.with_sharding_constraint(
                    up, _rows(mesh, axis))
            else:
                fc = fc[:, halo:halo + hb]        # crop halos (local)
                flow_c = jax.lax.with_sharding_constraint(
                    fc.reshape(n * hb, lw, 4), _rows(mesh, axis))

    # ---- final upsample to the input size + final blur ----
    if not tiled_level[0]:
        hb = T._cdiv(dh, n)
        flow_c = jnp.pad(flow_c, ((0, n * hb - dh), (0, 0), (0, 0)))
        flow_c = jax.lax.with_sharding_constraint(flow_c, _rows(mesh, axis))
    plan_up = T.make_row_resize_plan(dh, h_global, n, "linear")

    def fin_body(f):
        f = T._tiled_resize_cols(T._tiled_resize_rows(f, plan_up, axis),
                                 w, "linear")
        f = f * (1.0 / params.downscale_factor)
        return T._tiled_gaussian_blur(f, params.final_flow_blur_kernel_width,
                                      params.final_flow_blur_sigma, axis)

    flow_c = _seg(mesh, fin_body, P(axis), P(axis))(flow_c)
    return flow_c[..., :2], flow_c[..., 2:]
