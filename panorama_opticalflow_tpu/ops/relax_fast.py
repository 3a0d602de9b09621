"""Gather-free relaxation: the fast path of the pixflow solver.

The reference error function's per-candidate bilinear fetch
(CPU/PixFlow.hpp:407-425,427-456) is a data-dependent gather in the hot
loop.  This module reformulates the per-level relaxation with two
standard coarse-to-fine identities, so that every sample is a fixed
stencil:

1. **Warp recentering**: each level's incoming flow ``f_base`` (the
   upsampled coarser-level estimate) is applied to the gradient images
   once -- ``W1g(u) = I1g(u + f_base(u))`` -- so in-level candidates only
   need samples at ``x + delta`` with ``delta = f - f_base(x)`` bounded by
   a small window D.  Because f_base is smooth (median-filtered, blurred,
   upsampled), ``I1g(x + f) ~ W1g(x + delta)`` to first order.
2. **Bounded bilinear as hat-weighted shift-select**: a bilinear sample
   at a bounded offset is sum_{o in window} hat(dy-oy) hat(dx-ox) *
   shift(img, o) -- fma over statically-shifted views, which XLA fuses.
   The same pass yields neighbouring-offset sample maps (for the 4
   propagation candidates) and the analytic derivative maps (for the
   descent step) at marginal cost.

The base warp itself runs per tile: a coarse vmapped dynamic_slice picks
each tile's window at the tile-mean integer offset (one coarse-grained
gather of ~1k blocks), then the smooth residual is applied with two 1-D
hat passes.

``relax_phase_fast`` is also the reference of the GPU relax kernel
(ops/pallas/relax.py).  Fidelity: validated against the exact-gather
path (the oracle EPE/SSIM gates).  Deviations are confined to clamps:
residual displacement beyond D per level and intra-tile flow variation
beyond the warp margin.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from panorama_opticalflow_tpu.utils.config import FlowParams


def _hat(t):
    return jnp.maximum(0.0, 1.0 - jnp.abs(t))


def _dhat(t):
    # d/dt max(0, 1-|t|): -sign(t) inside the support
    return jnp.where(jnp.abs(t) < 1.0, -jnp.sign(t), 0.0)


def warp_by_flow_tiled(img: jax.Array, flow: jax.Array, tile_h: int = 64,
                       tile_w: int = 128, margin: int = 8,
                       max_off: int = 96) -> jax.Array:
    """W(x) = img(x + flow(x)) with bilinear sampling, clamp-to-edge.

    Per tile: integer offset = round(mean flow) via a coarse vmapped
    dynamic_slice (block gather); smooth residual via two separable 1-D
    hat passes.  Residuals are clamped to +-(margin-1); tile offsets to
    +-max_off.
    """
    h, w, c = img.shape
    hp = -(-h // tile_h) * tile_h
    wp = -(-w // tile_w) * tile_w
    # channel-split planes (c = 2 for gradient pairs)
    img_p = jnp.pad(jnp.moveaxis(img, 2, 0),
                    ((0, 0), (0, hp - h), (0, wp - w)), mode="edge")
    flow_p = jnp.pad(flow, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    ty, tx = hp // tile_h, wp // tile_w

    f_t = flow_p.reshape(ty, tile_h, tx, tile_w, 2)
    mean = f_t.mean(axis=(1, 3))                       # (ty, tx, 2) (fx, fy)
    off = jnp.clip(jnp.rint(mean), -max_off, max_off).astype(jnp.int32)

    pad = max_off + margin + 1
    big = jnp.pad(img_p, ((0, 0), (pad, pad), (pad, pad)), mode="edge")

    bh, bw = tile_h + 2 * margin + 1, tile_w + 2 * margin + 1

    def get_block(t_y, t_x, o):
        start_y = t_y * tile_h + o[1] + pad - margin
        start_x = t_x * tile_w + o[0] + pad - margin
        return jax.lax.dynamic_slice(big, (0, start_y, start_x), (c, bh, bw))

    tys = jnp.repeat(jnp.arange(ty), tx)
    txs = jnp.tile(jnp.arange(tx), ty)
    blocks = jax.vmap(get_block)(tys, txs, off.reshape(-1, 2))  # (T,c,bh,bw)

    # residual per pixel (fx, fy) relative to tile offset
    res = (f_t.transpose(0, 2, 1, 3, 4).reshape(-1, tile_h, tile_w, 2)
           - off.reshape(-1, 1, 1, 2).astype(jnp.float32))
    rx = jnp.clip(res[..., 0], -(margin - 1e-3), margin - 1e-3)
    ry = jnp.clip(res[..., 1], -(margin - 1e-3), margin - 1e-3)

    # separable hat passes, vmapped over tiles.  The x pass is applied to
    # all bh rows using edge-extended per-column residuals (the residual
    # is smooth within a tile), then the y pass selects rows.
    def warp_one(block, rx, ry):
        rx_ext = jnp.pad(rx, ((margin, margin + 1), (0, 0)), mode="edge")
        accx = jnp.zeros((c, bh, tile_w), block.dtype)
        for ox in range(-margin, margin + 1):
            wx = _hat(rx_ext - ox)                   # (bh, tile_w)
            sl = jax.lax.slice(block, (0, 0, ox + margin),
                               (c, bh, ox + margin + tile_w))
            accx = accx + wx[None] * sl
        accy = jnp.zeros((c, tile_h, tile_w), block.dtype)
        for oy in range(-margin, margin + 1):
            wy = _hat(ry - oy)                       # (tile_h, tile_w)
            sl = jax.lax.slice(accx, (0, oy + margin, 0),
                               (c, oy + margin + tile_h, tile_w))
            accy = accy + wy[None] * sl
        return accy

    out_blocks = jax.vmap(warp_one)(blocks, rx, ry)   # (T, c, th, tw)
    out = out_blocks.reshape(ty, tx, c, tile_h, tile_w) \
        .transpose(2, 0, 3, 1, 4).reshape(c, hp, wp)
    return jnp.moveaxis(out, 0, 2)[:h, :w]




def sample_maps(w1g_pad: jax.Array, dx: jax.Array, dy: jax.Array, D: int,
                with_neighbors: bool, with_grad: bool,
                with_sample: bool = True):
    """Separable hat-window sampling over the pre-padded
    (H+2(D+1), W+2(D+1), 2) image.

    First an x-pass ``X(r,c) = sum_ox hat(dx(r,c)-ox) W1[r, c+ox]`` (with
    dx edge-extended over the X domain), then y-passes produce the sample
    maps.  This is the formulation the Pallas kernel implements; the two
    paths must match.  The separable weights use each *row's own* dx
    (exact would use the centre row's) -- a first-order approximation in
    the flow's smoothness, like the warp recentering itself.

    Returns (S, nbrs, Gx, Gy):
      S     -- sample at (x + dx, y + dy)                       (H, W, 2)
      nbrs  -- samples at +-1 offsets: dict with keys
               'xp','xm','yp','ym' (same position +(0,1),(0,-1),(1,0),(-1,0))
      Gx/Gy -- d/d dx, d/d dy of S (analytic bilinear derivative)
    """
    h, w = dx.shape
    pad = D + 1
    lim = D - 1e-3
    dxc = jnp.clip(dx, -lim, lim)
    dyc = jnp.clip(dy, -lim, lim)

    # x-pass domain: rows [-(D+1), h+D+1), cols [-1, w+1)
    r = D + 1
    dx_ext = jnp.pad(dxc, ((r, r), (1, 1)), mode="edge")
    xr = h + 2 * r
    xw = w + 2

    def x_pass(weight_fn):
        acc = jnp.zeros((xr, xw, 2), jnp.float32)
        for ox in range(-D, D + 1):
            wgt = weight_fn(dx_ext - ox)[..., None]
            v = jax.lax.slice(w1g_pad, (0, pad - 1 + ox, 0),
                              (xr, pad - 1 + ox + xw, 2))
            acc = acc + wgt * v
        return acc

    def y_pass(x_acc, weight_fn, ro, co):
        acc = jnp.zeros((h, w, 2), jnp.float32)
        for oy in range(-D, D + 1):
            wgt = weight_fn(dyc - oy)[..., None]
            v = jax.lax.slice(x_acc, (r + oy + ro, 1 + co, 0),
                              (r + oy + ro + h, 1 + co + w, 2))
            acc = acc + wgt * v
        return acc

    x_hat = x_pass(_hat)
    S = y_pass(x_hat, _hat, 0, 0) if with_sample else None
    nbrs = None
    if with_neighbors:
        nbrs = {
            "xp": y_pass(x_hat, _hat, 0, 1),
            "xm": y_pass(x_hat, _hat, 0, -1),
            "yp": y_pass(x_hat, _hat, 1, 0),
            "ym": y_pass(x_hat, _hat, -1, 0),
        }
    Gx = Gy = None
    if with_grad:
        Gy = y_pass(x_hat, _dhat, 0, 0)
        Gx = y_pass(x_pass(_dhat), _hat, 0, 0)
    return S, nbrs, Gx, Gy


def _err_terms(i0x, i0y, sample, cand, blurred_flow, params, w):
    d0 = i0x - sample[..., 0]
    d1 = i0y - sample[..., 1]
    data = jnp.sqrt(d0 * d0 + d1 * d1)
    fd = blurred_flow - cand
    smooth = jnp.sqrt(fd[..., 0] ** 2 + fd[..., 1] ** 2)
    reg = (params.vertical_regularization_coef * jnp.abs(cand[..., 1])
           + params.horizontal_regularization_coef * jnp.abs(cand[..., 0])) / w
    return data + params.smoothness_coef * smooth + reg


def _shift2(arr, dy, dx):
    """shifted[y, x] = arr[y - dy, x - dx], edge padded."""
    pad = [(max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))]
    pad += [(0, 0)] * (arr.ndim - 2)
    p = jnp.pad(arr, pad, mode="edge")
    return jax.lax.slice(
        p, (max(-dy, 0), max(-dx, 0)) + (0,) * (arr.ndim - 2),
        (max(-dy, 0) + arr.shape[0], max(-dx, 0) + arr.shape[1]) + arr.shape[2:])


def relax_phase_fast(
    flow: jax.Array,
    f_base: jax.Array,
    w1g: jax.Array,
    i0x: jax.Array,
    i0y: jax.Array,
    blurred_flow: jax.Array,
    update_mask: jax.Array,
    params: FlowParams,
    iters: int,
    D: int = 3,
) -> jax.Array:
    """``iters`` Jacobi rounds of 4-neighbour propagation + descent,
    gather-free.  Semantics mirror models.pixflow.relax_iteration with
    the recentering approximation."""
    h, w = i0x.shape
    pad = D + 1
    w1g_pad = jnp.pad(w1g, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    inf = jnp.float32(jnp.inf)
    valid_l = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) >= 1
    valid_r = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) < w - 1
    valid_u = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) >= 1
    valid_d = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) < h - 1

    def one_iter(flow, _):
        delta = flow - f_base
        # ---- pass A: propagation ----
        S, nbrs, _, _ = sample_maps(w1g_pad, delta[..., 0], delta[..., 1],
                                    D, True, False)
        e_self = _err_terms(i0x, i0y, S, flow, blurred_flow, params, w)
        best_flow, best_err, best_samp = flow, e_self, S

        # candidate from LEFT: its sample at x = (left's own +x1 map)
        # shifted right by one; same pattern for the other directions.
        cand_defs = (
            ("xp", 0, 1, valid_l),   # from left neighbour
            ("yp", 1, 0, valid_u),   # from up
            ("xm", 0, -1, valid_r),  # from right
            ("ym", -1, 0, valid_d),  # from down
        )
        for key, dy, dx, valid in cand_defs:
            cand = _shift2(flow, dy, dx)
            samp = _shift2(nbrs[key], dy, dx)
            e = _err_terms(i0x, i0y, samp, cand, blurred_flow, params, w)
            e = jnp.where(valid, e, inf)
            take = e < best_err
            best_flow = jnp.where(take[..., None], cand, best_flow)
            best_err = jnp.where(take, e, best_err)
            best_samp = jnp.where(take[..., None], samp, best_samp)

        # ---- pass B: descent at the accepted flow ----
        delta2 = best_flow - f_base
        if params.fold_descent_sample:
            # reuse the accepted candidate's sample from pass A; only the
            # derivative maps need fresh passes
            _, _, Gx, Gy = sample_maps(
                w1g_pad, delta2[..., 0], delta2[..., 1], D, False, True,
                with_sample=False)
            S2 = best_samp
        else:
            S2, _, Gx, Gy = sample_maps(
                w1g_pad, delta2[..., 0], delta2[..., 1], D, False, True)
        d0 = i0x - S2[..., 0]
        d1 = i0y - S2[..., 1]
        q = jnp.sqrt(d0 * d0 + d1 * d1)
        inv_q = jnp.where(q > 1e-12, 1.0 / q, 0.0)
        ddata_dfx = -(d0 * Gx[..., 0] + d1 * Gx[..., 1]) * inv_q
        ddata_dfy = -(d0 * Gy[..., 0] + d1 * Gy[..., 1]) * inv_q
        fd = blurred_flow - best_flow
        s = jnp.sqrt(fd[..., 0] ** 2 + fd[..., 1] ** 2)
        inv_s = jnp.where(s > 1e-12, 1.0 / s, 0.0)
        dsm_dfx = -fd[..., 0] * inv_s  # d|bf-f|/dfx = -(bfx-fx)/|bf-f|
        dsm_dfy = -fd[..., 1] * inv_s
        gx = (ddata_dfx + params.smoothness_coef * dsm_dfx
              + params.horizontal_regularization_coef
              * jnp.sign(best_flow[..., 0]) / w)
        gy = (ddata_dfy + params.smoothness_coef * dsm_dfy
              + params.vertical_regularization_coef
              * jnp.sign(best_flow[..., 1]) / w)
        new = best_flow - params.gradient_step_size \
            * jnp.stack([gx, gy], axis=-1)
        return jnp.where(update_mask[..., None], new, flow), None

    flow, _ = jax.lax.scan(one_iter, flow, None, length=iters)
    return flow
