"""Pallas (Triton) relaxation kernels for the GPU: one Jacobi iteration
is two launches, propagation then descent.

The per-pixel layout of the reference's CUDA build (GPU/PixFlow_GPU.cu:
153-296: one thread per pixel, neighbours read from cache), without its
races: every launch reads the previous state and writes a new one.  The
semantics are those of ``ops.relax_fast.relax_phase_fast`` (the jnp
reference), iteration by iteration:

* ``relax_propagate`` (pass A) -- the pixel's own error and its four
  neighbours' candidates, each sampled from the warped gradient pair
  with a (2D+1)x(2D+1) separable hat window; stores the accepted flow
  and the accepted candidate's sample;
* ``relax_descend`` (pass B) -- the analytic-gradient step at the
  accepted flow; its x-pass reads the accepted flow of rows y-D..y+D.

The window sums are ``fori_loop``s over the taps, kept in registers.
All loads use clamped row/column indices, which is exactly the
edge-replicate semantics of the reference's pads and shifts, so no plane
is ever padded.  (A single launch per iteration that recomputes pass A
for the 2D+1 rows pass B reads measured 0.9x XLA's fused jnp on the
card; the two-launch form 2.5-2.8x, PERF.md.)

``relax_phase_kernel`` mirrors ``relax_phase_fast``'s signature on one
direction; ``jax.vmap`` batches it through ``pallas_call``'s own rule.
Where the kernels run is decided by ``use_relax_kernel`` alone.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from panorama_opticalflow_tpu.utils.config import FlowParams

# Program tile (rows, cols) and warps per program; see PERF.md for the
# sweep on the card that chose them.
BLOCK = (8, 64)
NUM_WARPS = 8
# Smallest level (pixels per direction) relaxed by the kernels on the
# GPU: the smallest size of the card sweep (64x256, 1.9x XLA's version;
# the kernels won at every size of that sweep, PERF.md).  Smaller
# levels are launch-bound either way and run the jnp reference.
MIN_PIXELS = 64 * 256


def kernel_platform(platform: str | None = None) -> bool:
    """True where the relax kernel is the relax path (the GPU), False
    where the jnp reference is (the CPU).  Any other platform is an
    error: the program has no path tuned for it."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(
        f"unsupported JAX platform {platform!r}: expected 'gpu' or 'cpu'")


def use_relax_kernel(h: int, w: int, platform: str | None = None) -> bool:
    """The one place that chooses kernel vs jnp relaxation for an
    (h, w) level: the kernels on the GPU for levels of at least
    ``MIN_PIXELS``, the jnp reference otherwise."""
    return kernel_platform(platform) and h * w >= MIN_PIXELS


def _hat(t):
    return jnp.maximum(0.0, 1.0 - jnp.abs(t))


def _dhat(t):
    return jnp.where(jnp.abs(t) < 1.0, -jnp.sign(t), 0.0)


class _Tile:
    """Index helpers and the shared window sums of one program's tile."""

    def __init__(self, h: int, w: int, D: int, bh: int, bw: int, coefs):
        self.h, self.w, self.D = h, w, D
        self.y = (pl.program_id(0) * bh
                  + jax.lax.broadcasted_iota(jnp.int32, (bh, 1), 0))
        self.x = (pl.program_id(1) * bw
                  + jax.lax.broadcasted_iota(jnp.int32, (1, bw), 1))
        self.x0 = self.cols(0)
        self.q0 = self.rows(0)
        self.zero = jnp.zeros((bh, bw), jnp.float32)
        self.lim = D - 1e-3
        self.smooth, self.vcoef, self.hcoef = coefs

    def rows(self, k):
        return jnp.clip(self.y + k, 0, self.h - 1)

    def cols(self, c):
        return jnp.clip(self.x + c, 0, self.w - 1)

    def clipd(self, f, b):
        return jnp.clip(f - b, -self.lim, self.lim)

    def x_pass(self, w1x_r, w1y_r, r, dx, with_dhat: bool):
        """sum_ox wgt(dx - ox) * W1[r, x + ox] for both channels, with
        the hat weights (and the hat's derivative when asked)."""
        def body(i, acc):
            ox = i - self.D
            t = dx - ox.astype(jnp.float32)
            c = self.cols(ox)
            vx, vy = w1x_r[r, c], w1y_r[r, c]
            wh = _hat(t)
            out = (acc[0] + wh * vx, acc[1] + wh * vy)
            if with_dhat:
                wd = _dhat(t)
                out += (acc[2] + wd * vx, acc[3] + wd * vy)
            return out

        return jax.lax.fori_loop(0, 2 * self.D + 1, body,
                                 (self.zero,) * (4 if with_dhat else 2))

    def err(self, sx, sy, cfx, cfy, i0x, i0y, bfx, bfy):
        d0 = i0x - sx
        d1 = i0y - sy
        data = jnp.sqrt(d0 * d0 + d1 * d1)
        fdx = bfx - cfx
        fdy = bfy - cfy
        sm = jnp.sqrt(fdx ** 2 + fdy ** 2)
        reg = (self.vcoef * jnp.abs(cfy) + self.hcoef * jnp.abs(cfx)) / self.w
        return data + self.smooth * sm + reg

    def propagate(self, q, fx_r, fy_r, bx_r, by_r, w1x_r, w1y_r, i0x_r,
                  i0y_r, bfx_r, bfy_r):
        """Pass A at pixel rows ``q`` (clamped, so real pixels): the
        accepted flow and the accepted candidate's sample."""
        h, D, x0 = self.h, self.D, self.x0
        up, dn = jnp.clip(q - 1, 0, h - 1), jnp.clip(q + 1, 0, h - 1)
        # self, then left, up, right, down -- the reference's order
        pos = ((q, x0), (q, self.cols(-1)), (up, x0), (q, self.cols(1)),
               (dn, x0))
        cands = [(fx_r[r, c], fy_r[r, c], self.clipd(fy_r[r, c], by_r[r, c]))
                 for r, c in pos]

        def body(i, acc):
            oy = i - D
            r = jnp.clip(q + oy, 0, h - 1)
            xs = self.x_pass(w1x_r, w1y_r, r,
                             self.clipd(fx_r[r, x0], bx_r[r, x0]), False)
            out = ()
            for k, (_, _, dy) in enumerate(cands):
                wgt = _hat(dy - oy.astype(jnp.float32))
                out += (acc[2 * k] + wgt * xs[0],
                        acc[2 * k + 1] + wgt * xs[1])
            return out

        samp = jax.lax.fori_loop(0, 2 * D + 1, body, (self.zero,) * 10)
        terms = (i0x_r[q, x0], i0y_r[q, x0], bfx_r[q, x0], bfy_r[q, x0])
        best_fx, best_fy = cands[0][0], cands[0][1]
        best_sx, best_sy = samp[0], samp[1]
        best_e = self.err(best_sx, best_sy, best_fx, best_fy, *terms)
        x = self.x
        valid = (x >= 1, q >= 1, x < self.w - 1, q < h - 1)
        for k in range(1, 5):
            cfx, cfy, _ = cands[k]
            sx, sy = samp[2 * k], samp[2 * k + 1]
            e = jnp.where(valid[k - 1],
                          self.err(sx, sy, cfx, cfy, *terms), jnp.inf)
            take = e < best_e
            best_fx = jnp.where(take, cfx, best_fx)
            best_fy = jnp.where(take, cfy, best_fy)
            best_e = jnp.where(take, e, best_e)
            best_sx = jnp.where(take, sx, best_sx)
            best_sy = jnp.where(take, sy, best_sy)
        return best_fx, best_fy, best_sx, best_sy

    def descend(self, best_fx_at, bfx0, bfy0, bs0, fx0, fy0, bx_r, by_r,
                w1x_r, w1y_r, i0x_r, i0y_r, bfx_r, bfy_r, m_r, *,
                fold: bool, step: float):
        """Pass B: the descent step at the accepted flow (bfx0, bfy0) and
        sample bs0; ``best_fx_at(rows)`` loads the accepted x-flow of
        other rows."""
        D, q0, x0 = self.D, self.q0, self.x0
        dy2 = self.clipd(bfy0, by_r[q0, x0])

        def body(i, acc):
            m = i - D
            qm = self.rows(m)
            dx2 = self.clipd(best_fx_at(qm), bx_r[qm, x0])
            xh_x, xh_y, xd_x, xd_y = self.x_pass(w1x_r, w1y_r, qm, dx2, True)
            t = dy2 - m.astype(jnp.float32)
            wh, wd = _hat(t), _dhat(t)
            return (acc[0] + wd * xh_x, acc[1] + wd * xh_y,    # Gy
                    acc[2] + wh * xd_x, acc[3] + wh * xd_y,    # Gx
                    acc[4] + wh * xh_x, acc[5] + wh * xh_y)    # S2

        gyx, gyy, gxx, gxy, s2x, s2y = jax.lax.fori_loop(
            0, 2 * D + 1, body, (self.zero,) * 6)
        if fold:
            s2x, s2y = bs0
        d0 = i0x_r[q0, x0] - s2x
        d1 = i0y_r[q0, x0] - s2y
        q = jnp.sqrt(d0 * d0 + d1 * d1)
        inv_q = jnp.where(q > 1e-12, 1.0 / q, 0.0)
        ddx = -(d0 * gxx + d1 * gxy) * inv_q
        ddy = -(d0 * gyx + d1 * gyy) * inv_q
        fdx = bfx_r[q0, x0] - bfx0
        fdy = bfy_r[q0, x0] - bfy0
        s = jnp.sqrt(fdx ** 2 + fdy ** 2)
        inv_s = jnp.where(s > 1e-12, 1.0 / s, 0.0)
        gxt = (ddx + self.smooth * (-fdx * inv_s)
               + self.hcoef * jnp.sign(bfx0) / self.w)
        gyt = (ddy + self.smooth * (-fdy * inv_s)
               + self.vcoef * jnp.sign(bfy0) / self.w)
        upd = m_r[q0, x0] > 0.5
        return (jnp.where(upd, bfx0 - step * gxt, fx0),
                jnp.where(upd, bfy0 - step * gyt, fy0))

    def store(self, ref, value):
        inside = (self.y < self.h) & (self.x < self.w)
        pltriton.store(ref.at[self.y, self.x], value, mask=inside)


def _propagate_kernel(fx_r, fy_r, bx_r, by_r, w1x_r, w1y_r, i0x_r, i0y_r,
                      bfx_r, bfy_r, obx_r, oby_r, osx_r, osy_r, *, h, w, D,
                      bh, bw, coefs):
    """Pass A alone: accepted flow and sample, stored for pass B."""
    t = _Tile(h, w, D, bh, bw, coefs)
    for ref, v in zip((obx_r, oby_r, osx_r, osy_r), t.propagate(
            t.q0, fx_r, fy_r, bx_r, by_r, w1x_r, w1y_r, i0x_r, i0y_r,
            bfx_r, bfy_r)):
        t.store(ref, v)


def _descent_kernel(fx_r, fy_r, afx_r, afy_r, asx_r, asy_r, bx_r, by_r,
                    w1x_r, w1y_r, i0x_r, i0y_r, bfx_r, bfy_r, m_r, ofx_r,
                    ofy_r, *, h, w, D, bh, bw, fold, step, coefs):
    """Pass B alone, reading pass A's stored accepted flow (afx, afy)
    and sample (asx, asy)."""
    t = _Tile(h, w, D, bh, bw, coefs)
    q0, x0 = t.q0, t.x0
    nfx, nfy = t.descend(
        lambda qm: afx_r[qm, x0], afx_r[q0, x0], afy_r[q0, x0],
        (asx_r[q0, x0], asy_r[q0, x0]), fx_r[q0, x0], fy_r[q0, x0],
        bx_r, by_r, w1x_r, w1y_r, i0x_r, i0y_r, bfx_r, bfy_r, m_r,
        fold=fold, step=step)
    t.store(ofx_r, nfx)
    t.store(ofy_r, nfy)


def _call(body, name, h, w, n_in, n_out, block, num_warps, interpret):
    plane = jax.ShapeDtypeStruct((h, w), jnp.float32)
    return pl.pallas_call(
        body,
        grid=(pl.cdiv(h, block[0]), pl.cdiv(w, block[1])),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * n_in,
        out_specs=[pl.BlockSpec(memory_space=pl.ANY)] * n_out,
        out_shape=[plane] * n_out,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name=name,
    )


@functools.lru_cache(maxsize=None)
def _relax_call(h: int, w: int, params: FlowParams, D: int,
                block: tuple[int, int], num_warps: int, interpret: bool):
    """One Jacobi iteration as a function of (fx, fy, *static planes)."""
    kw = dict(h=h, w=w, D=D, bh=block[0], bw=block[1],
              coefs=(params.smoothness_coef,
                     params.vertical_regularization_coef,
                     params.horizontal_regularization_coef))
    step = dict(fold=params.fold_descent_sample,
                step=params.gradient_step_size)
    tail = (block, num_warps, interpret)
    prop = _call(functools.partial(_propagate_kernel, **kw),
                 "relax_propagate", h, w, 10, 4, *tail)
    desc = _call(functools.partial(_descent_kernel, **kw, **step),
                 "relax_descend", h, w, 15, 2, *tail)

    def iteration(fx, fy, bx, by, w1x, w1y, i0x, i0y, bfx, bfy, m):
        best = prop(fx, fy, bx, by, w1x, w1y, i0x, i0y, bfx, bfy)
        return desc(fx, fy, *best, bx, by, w1x, w1y, i0x, i0y, bfx, bfy, m)

    return iteration


def relax_phase_kernel(
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
    *,
    block: tuple[int, int] = BLOCK,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
) -> jax.Array:
    """``iters`` Jacobi rounds, two kernel launches each; same arguments
    and result as ``ops.relax_fast.relax_phase_fast`` on one direction
    ((H, W, 2) flows, (H, W) planes)."""
    h, w = i0x.shape
    call = _relax_call(h, w, params, int(D), tuple(block), int(num_warps),
                       bool(interpret))
    planes = (f_base[..., 0], f_base[..., 1], w1g[..., 0], w1g[..., 1],
              i0x, i0y, blurred_flow[..., 0], blurred_flow[..., 1],
              update_mask.astype(jnp.float32))

    def one_iter(f, _):
        return tuple(call(f[0], f[1], *planes)), None

    (fx, fy), _ = jax.lax.scan(one_iter, (flow[..., 0], flow[..., 1]), None,
                               length=iters)
    return jnp.stack([fx, fy], axis=-1)


def relax_phase_batched(flow, f_base, w1g, i0x, i0y, blurred_flow,
                        update_mask, params: FlowParams, iters: int, D: int):
    """relax_phase_kernel over a leading batch (directions, tiles)."""
    return jax.vmap(
        lambda *a: relax_phase_kernel(*a, params, iters, D)
    )(flow, f_base, w1g, i0x, i0y, blurred_flow, update_mask)
