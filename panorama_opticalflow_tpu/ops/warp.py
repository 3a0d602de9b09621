"""Flow-guided sampling primitives.

Two samplers with the reference's exact boundary semantics:

* ``bilinear_extend``   -- clamp-to-edge bilinear used inside the flow
  error function (CPU/PixFlow.hpp:407-425): coordinates are clamped to
  [0, W-2] x [0, H-2] before taking the 2x2 cell.
* ``sample_nearest_wrap`` -- the novel-view point sampler
  (CPU/OpticalFlow.cpp:9-28): truncation to int, single horizontal wrap
  (the 360-degree canvas), vertical clamp.

Both are expressed as flat-index gathers.  The flow solver's hot path
samples through the gather-free hat window of ops/relax_fast.py
instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bilinear_extend(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """Sample ``img`` ((H, W) or (H, W, C) float32) at float coords.

    Matches getPixBilinear32FExtend: x clamped to [0, W-2], y to [0, H-2],
    corners at (x0, y0)..(x0+1, y0+1), standard bilinear weights.
    ``x``/``y`` may be any (broadcastable) shape; returns that shape
    (+ channel dim).
    """
    h, w = img.shape[:2]
    x = jnp.clip(x, 0.0, w - 2.0)
    y = jnp.clip(y, 0.0, h - 2.0)
    x0 = x.astype(jnp.int32)
    y0 = y.astype(jnp.int32)
    xr = x - x0.astype(x.dtype)
    yr = y - y0.astype(y.dtype)

    flat = img.reshape((h * w,) + img.shape[2:])
    base = y0 * w + x0
    f00 = jnp.take(flat, base, axis=0)
    f10 = jnp.take(flat, base + 1, axis=0)
    f01 = jnp.take(flat, base + w, axis=0)
    f11 = jnp.take(flat, base + w + 1, axis=0)
    if img.ndim == 3:
        xr = xr[..., None]
        yr = yr[..., None]
    return f00 + (f10 - f00) * xr + (f01 - f00) * yr \
        + (f00 + f11 - f10 - f01) * xr * yr


def sample_nearest_wrap(img: jax.Array, flow: jax.Array, t: jax.Array) -> jax.Array:
    """generateNovelViewPoint for every pixel (CPU/OpticalFlow.cpp:9-28).

    src = img[clamp_y(int(y + t*fy)), wrap_x(int(x + t*fx))] with C-style
    truncation toward zero, one-period horizontal wrap, vertical clamp.
    ``img`` is (H, W, C); ``flow`` is (H, W, 2) as (fx, fy); ``t`` is a
    scalar or (H, W) per-pixel factor.  Returns (H, W, C).
    """
    h, w = img.shape[:2]
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    t = jnp.asarray(t, jnp.float32)
    sx = jnp.trunc(xs + flow[..., 0] * t).astype(jnp.int32)
    sy = jnp.trunc(ys + flow[..., 1] * t).astype(jnp.int32)
    # single wrap, exactly like the reference's two ifs
    sx = jnp.where(sx > w - 1, sx - w, sx)
    sx = jnp.where(sx < 0, sx + w, sx)
    sy = jnp.clip(sy, 0, h - 1)
    flat = img.reshape(h * w, -1)
    return jnp.take(flat, sy * w + sx, axis=0).reshape(img.shape)


def sample_nearest_wrap_tiled(
    img: jax.Array, flow: jax.Array, t: jax.Array,
    tile_h: int = 64, tile_w: int = 128, margin: int = 8, max_off: int = 96,
) -> jax.Array:
    """Gather-free ``sample_nearest_wrap``: the production path for large
    canvases (whether the exact gather is faster on the GPU is not
    measured yet).

    Identical semantics -- C-trunc, single horizontal wrap, vertical
    clamp -- expressed as a per-tile block fetch plus bounded residual
    selection:

    * per pixel, the integer source offset ``(ox, oy) = (sx - x, sy - y)``
      (with the horizontal wrap folded into a wrap-padded image so seam
      crossings stay exact);
    * per (tile_h, tile_w) tile, one ``dynamic_slice`` block fetch at the
      clamped rounded mean offset (a coarse ~1k-block fetch, not a
      per-pixel gather);
    * within the tile, two separable nearest select passes over the
      residual window ``[-margin, margin]``.

    Deviations from the exact gather (all gated by the oracle-diff test
    and the e2e SSIM/golden suites): residuals beyond ``margin`` and tile
    offsets beyond ``max_off`` clamp, and the x-select uses each block
    row's own residual (first-order in the flow's smoothness, as in
    ops.relax_fast).  The flow fields this samples (median-filtered,
    diffused, blurred) are smooth, so clamps engage only at rare
    disocclusion edges.
    """
    h, w, c = img.shape
    hp = -(-h // tile_h) * tile_h
    wp = -(-w // tile_w) * tile_w
    ty, tx = hp // tile_h, wp // tile_w

    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    t = jnp.asarray(t, jnp.float32)
    sx = jnp.trunc(xs + flow[..., 0] * t).astype(jnp.int32)
    sy = jnp.trunc(ys + flow[..., 1] * t).astype(jnp.int32)
    ox = sx - jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    oy = (jnp.clip(sy, 0, h - 1)
          - jax.lax.broadcasted_iota(jnp.int32, (h, w), 0))

    # channel-split planes; y edge-pad (clamp), x wrap-pad (the single
    # horizontal wrap), then tile-pad bottom/right with edge
    pad = max_off + margin
    img_p = jnp.moveaxis(img, 2, 0)
    img_p = jnp.pad(img_p, ((0, 0), (pad, pad), (0, 0)), mode="edge")
    img_p = jnp.pad(img_p, ((0, 0), (0, 0), (pad, pad)), mode="wrap")
    img_p = jnp.pad(img_p, ((0, 0), (0, hp - h), (0, wp - w)), mode="edge")

    def tiles(a):
        # edge-pad (not zero-pad): partial bottom/right tiles must take
        # their mean offset from valid pixels only -- zero fill skewed the
        # mean and corrupted the whole tile remainder on canvases whose
        # h/w are not multiples of (tile_h, tile_w)
        a = jnp.pad(a, ((0, hp - h), (0, wp - w)), mode="edge")
        return (a.reshape(ty, tile_h, tx, tile_w)
                .transpose(0, 2, 1, 3).reshape(-1, tile_h, tile_w))

    ox_t = tiles(ox)
    oy_t = tiles(oy)
    off_x = jnp.clip(jnp.rint(ox_t.mean(axis=(1, 2))),
                     -max_off, max_off).astype(jnp.int32)
    off_y = jnp.clip(jnp.rint(oy_t.mean(axis=(1, 2))),
                     -max_off, max_off).astype(jnp.int32)

    bh, bw = tile_h + 2 * margin, tile_w + 2 * margin

    def get_block(t_y, t_x, oyy, oxx):
        start_y = t_y * tile_h + oyy + pad - margin
        start_x = t_x * tile_w + oxx + pad - margin
        return jax.lax.dynamic_slice(img_p, (0, start_y, start_x),
                                     (c, bh, bw))

    tys = jnp.repeat(jnp.arange(ty), tx)
    txs = jnp.tile(jnp.arange(tx), ty)
    blocks = jax.vmap(get_block)(tys, txs, off_y, off_x)  # (T, c, bh, bw)

    rx = jnp.clip(ox_t - off_x[:, None, None], -margin, margin)
    ry = jnp.clip(oy_t - off_y[:, None, None], -margin, margin)

    def select_one(block, rx, ry):
        # x pass over all block rows (residual edge-extended vertically),
        # then y pass picks rows
        rx_ext = jnp.pad(rx, ((margin, margin), (0, 0)), mode="edge")
        accx = jnp.zeros((c, bh, tile_w), block.dtype)
        for o in range(-margin, margin + 1):
            sl = jax.lax.slice(block, (0, 0, o + margin),
                               (c, bh, o + margin + tile_w))
            accx = jnp.where((rx_ext == o)[None], sl, accx)
        accy = jnp.zeros((c, tile_h, tile_w), block.dtype)
        for o in range(-margin, margin + 1):
            sl = jax.lax.slice(accx, (0, o + margin, 0),
                               (c, o + margin + tile_h, tile_w))
            accy = jnp.where((ry == o)[None], sl, accy)
        return accy

    out = jax.vmap(select_one)(blocks, rx, ry)  # (T, c, th, tw)
    out = (out.reshape(ty, tx, c, tile_h, tile_w)
           .transpose(2, 0, 3, 1, 4).reshape(c, hp, wp))
    return jnp.moveaxis(out, 0, 2)[:h, :w]
