"""Core 2-D image primitives as pure, statically-shaped JAX array programs.

These are array-program re-designs of the OpenCV primitives the reference
pipeline leans on (resize, GaussianBlur, Sobel, medianBlur, blur, cvtColor,
threshold -- see SURVEY.md L0/L1).  Everything is separable / stencil-shaped
so XLA can fuse it; resizes are expressed as static gathers +
weighted sums (the per-level weights are compile-time constants).

Semantics match OpenCV where the reference depends on them:
  * resize uses half-pixel centers, ``src = (dst + 0.5) * scale - 0.5``,
    bicubic with a = -0.75, taps clamped to the image (replicate);
  * GaussianBlur uses the exp formula of cv::getGaussianKernel and
    BORDER_REFLECT_101;
  * Sobel with ksize=1 is the plain [-1, 0, 1] derivative, BORDER_REPLICATE
    (CPU/PixFlow.hpp:281-287);
  * medianBlur uses BORDER_REPLICATE;
  * blur (box) uses BORDER_REFLECT_101 and OpenCV's even-kernel anchor
    (window [i - k//2, i + k - 1 - k//2]);
  * RGBA->gray uses OpenCV's fixed-point weights so uint8 results are
    bit-exact (modules/imgproc color conversions: (R*4899 + G*9617 +
    B*1868 + 8192) >> 14).
"""

from __future__ import annotations

import functools
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

Method = Literal["linear", "cubic"]


# ---------------------------------------------------------------------------
# Resize (separable, static-weight gather + weighted sum)
# ---------------------------------------------------------------------------


def _cubic_weight(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """OpenCV bicubic kernel (a = -0.75)."""
    t = np.abs(t)
    w1 = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    w2 = a * (((t - 5.0) * t + 8.0) * t - 4.0)
    return np.where(t <= 1.0, w1, np.where(t < 2.0, w2, 0.0))


@functools.lru_cache(maxsize=None)
def _resize_axis_plan(in_size: int, out_size: int, method: Method):
    """Static (indices, weights) for resampling one axis.

    Returns idx (out, K) int32 clamped to [0, in_size-1] and w (out, K)
    float32, with half-pixel-center source mapping.
    """
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    x0 = np.floor(src)
    f = src - x0
    x0 = x0.astype(np.int64)
    if method == "linear":
        taps = np.stack([x0, x0 + 1], axis=1)
        w = np.stack([1.0 - f, f], axis=1)
    elif method == "cubic":
        taps = np.stack([x0 - 1, x0, x0 + 1, x0 + 2], axis=1)
        dist = taps - src[:, None]
        w = _cubic_weight(dist)
        # OpenCV normalises the 4 taps (they already sum to 1 analytically;
        # normalising guards fp drift).
        w = w / w.sum(axis=1, keepdims=True)
    else:  # pragma: no cover
        raise ValueError(method)
    idx = np.clip(taps, 0, in_size - 1).astype(np.int32)
    # numpy (not jnp) so the lru_cache never captures a tracer-backed array
    return idx, w.astype(np.float32)


def _resize_axis0(img: jax.Array, out_size: int, method: Method) -> jax.Array:
    idx, w = _resize_axis_plan(img.shape[0], out_size, method)
    k = idx.shape[1]
    gathered = jnp.take(img, idx.reshape(-1), axis=0)
    gathered = gathered.reshape((out_size, k) + img.shape[1:])
    w = w.reshape((out_size, k) + (1,) * (img.ndim - 1))
    return (gathered * w).sum(axis=1)


def _resize_matrix_dev(n_in: int, n_out: int, method: Method) -> jax.Array:
    """The static resample plan as a dense (n_out, n_in) matrix built on
    device from the compact per-tap plan (k iota-compare adds; border-
    clamped duplicate taps coalesce by accumulation).  Same weights as
    the gather path, applied as one matmul."""
    idx, w = _resize_axis_plan(n_in, n_out, method)
    k_io = jax.lax.broadcasted_iota(jnp.int32, (n_out, n_in), 1)
    a = jnp.zeros((n_out, n_in), jnp.float32)
    for m in range(idx.shape[1]):
        a = a + jnp.where(k_io == jnp.asarray(idx[:, m:m + 1]),
                          jnp.asarray(w[:, m:m + 1].astype(np.float32)), 0.0)
    return a


def resize(img: jax.Array, out_hw: tuple[int, int], method: Method) -> jax.Array:
    """Separable resize of an (H, W) or (H, W, C) float array.

    Matches cv::resize INTER_LINEAR / INTER_CUBIC sampling (no anti-alias
    filter, like OpenCV).  2-D planes (the hot path: every pyramid level
    and flow upsample runs on channel-split planes) resample as two
    matmuls with on-device banded matrices instead of a gather plus a
    transpose-wrapped column pass.  Tap weights are identical to the
    gather formulation; only the f32 accumulation order differs
    (HIGHEST precision: no TF32, no bf16).  Arrays with a channel dim
    keep the gather path (cold: once-per-pair RGBA preprocessing).
    """
    out_h, out_w = out_hw
    x = img.astype(jnp.float32)
    if img.ndim == 2:
        hi = jax.lax.Precision.HIGHEST
        if out_h != img.shape[0]:
            x = jnp.dot(_resize_matrix_dev(x.shape[0], out_h, method), x,
                        precision=hi)
        if out_w != img.shape[1]:
            b = _resize_matrix_dev(x.shape[1], out_w, method)
            x = jax.lax.dot_general(x, b, (((1,), (1,)), ((), ())),
                                    precision=hi)
        return x
    if out_h != img.shape[0]:
        x = _resize_axis0(x, out_h, method)
    if out_w != img.shape[1]:
        x = jnp.swapaxes(_resize_axis0(jnp.swapaxes(x, 0, 1), out_w, method), 0, 1)
    return x


@functools.lru_cache(maxsize=None)
def resize_axis_matrix(n_in: int, n_out: int, n_pad: int,
                       method: Method) -> np.ndarray:
    """The resample of ``_resize_axis_plan`` as a dense (n_pad, n_pad)
    matrix A with ``out = A @ x`` (rows = output positions).

    Reference form of the rung-scanned descent's resize (models/
    pixflow.py carries the compact 4-tap plans and materialises this
    matrix on device; tests/test_levelscan.py checks both against the
    static resize).  Rows j >= n_out replicate row
    n_out - 1 so the padded region of the output is edge-replicated;
    columns only reference k < n_in (taps are clamped), so garbage in
    the input's padding is never read.  Weights are bit-identical to the
    static plan."""
    assert n_in <= n_pad and n_out <= n_pad
    idx, w = _resize_axis_plan(n_in, n_out, method)
    a = np.zeros((n_pad, n_pad), np.float32)
    rows = np.repeat(np.arange(n_out), idx.shape[1])
    np.add.at(a, (rows, idx.reshape(-1)), w.reshape(-1))
    if n_out < n_pad:
        a[n_out:] = a[n_out - 1]
    return a


def resize_u8(img: jax.Array, out_hw: tuple[int, int], method: Method) -> jax.Array:
    """Resize a uint8 image with OpenCV-style round+saturate to uint8."""
    out = resize(img.astype(jnp.float32), out_hw, method)
    return jnp.clip(jnp.rint(out), 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Separable filters
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int, sigma: float):
    """cv::getGaussianKernel for sigma > 0 (exp formula, normalised)."""
    c = (ksize - 1) * 0.5
    i = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((i - c) ** 2) / (2.0 * sigma * sigma))
    k = k / k.sum()
    # numpy so the lru_cache never captures a tracer-backed array
    return k.astype(np.float32)


def _pad_spatial(img: jax.Array, ph: int, pw: int, mode: str) -> jax.Array:
    pad = [(ph, ph), (pw, pw)] + [(0, 0)] * (img.ndim - 2)
    return jnp.pad(img, pad, mode=mode)


def _conv_axis0(img: jax.Array, kernel: jax.Array, pad_mode: str,
                axis: int = 0) -> jax.Array:
    """1-D correlation along ``axis`` with symmetric padding, as
    shift+fma (no conv ops, no transposes: XLA fuses the taps into one
    elementwise pass)."""
    k = kernel.shape[0]
    r = k // 2
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, k - 1 - r)
    p = jnp.pad(img, pad, mode=pad_mode)
    h = img.shape[axis]
    out = jnp.zeros_like(img)
    for i in range(k):
        out = out + kernel[i] * jax.lax.slice_in_dim(p, i, i + h, axis=axis)
    return out


def gaussian_blur(img: jax.Array, ksize: int, sigma: float) -> jax.Array:
    """cv::GaussianBlur with BORDER_REFLECT_101 (np 'reflect')."""
    kern = gaussian_kernel_1d(ksize, sigma)
    x = _conv_axis0(img, kern, "reflect")
    return _conv_axis0(x, kern, "reflect", axis=1)


def sobel_x(img: jax.Array) -> jax.Array:
    """cv::Sobel dx ksize=1 ([-1, 0, 1]), BORDER_REPLICATE."""
    p = jnp.pad(img, [(0, 0), (1, 1)] + [(0, 0)] * (img.ndim - 2), mode="edge")
    return p[:, 2:] - p[:, :-2]


def sobel_y(img: jax.Array) -> jax.Array:
    """cv::Sobel dy ksize=1, BORDER_REPLICATE."""
    p = jnp.pad(img, [(1, 1), (0, 0)] + [(0, 0)] * (img.ndim - 2), mode="edge")
    return p[2:] - p[:-2]


def _median5_shifts(img: jax.Array) -> list[jax.Array]:
    p = _pad_spatial(img, 2, 2, "edge")
    h, w = img.shape[:2]
    return [
        jax.lax.slice(p, (dy, dx) + (0,) * (img.ndim - 2),
                      (dy + h, dx + w) + img.shape[2:])
        for dy in range(5)
        for dx in range(5)
    ]


@functools.lru_cache(maxsize=None)
def batcher_pairs(n: int) -> tuple[tuple[int, int], ...]:
    """Compare-exchange pairs of Batcher's bitonic sorting network for
    n = 2^k inputs (ascending)."""
    assert n & (n - 1) == 0, "power of two"
    pairs = []
    k = 1
    while k < n:
        j = k
        while j >= 1:
            for i in range(n):
                ixj = i ^ j
                if ixj > i:
                    if (i & (k << 1)) == 0:
                        pairs.append((i, ixj))
                    else:
                        pairs.append((ixj, i))
            j >>= 1
        k <<= 1
    return tuple(pairs)


def median5(img: jax.Array) -> jax.Array:
    """5x5 median filter, BORDER_REPLICATE (cv::medianBlur semantics),
    on (H, W) or (H, W, C).

    Rank 12 of the 25 window shifts through a fixed 32-way sorting
    network (padded with +inf): elementwise min/max that XLA fuses into
    one pass -- the same values as sorting the 25-stack, at a fraction
    of the cost (PERF.md)."""
    v = _median5_shifts(img)
    v = v + [jnp.full_like(v[0], jnp.inf)] * 7
    for a, b in batcher_pairs(32):
        v[a], v[b] = jnp.minimum(v[a], v[b]), jnp.maximum(v[a], v[b])
    return v[12]


def box_blur(img: jax.Array, ksize_w: int, ksize_h: int) -> jax.Array:
    """cv::blur with BORDER_REFLECT_101 and OpenCV's default anchor.

    For even kernels OpenCV's anchor (k/2) makes the window
    [i - k//2, i + k - 1 - k//2].
    """
    def along_axis0(x: jax.Array, k: int) -> jax.Array:
        if k <= 1:
            return x
        lo, hi = k // 2, k - 1 - k // 2
        pad = [(lo, hi)] + [(0, 0)] * (x.ndim - 1)
        p = jnp.pad(x, pad, mode="reflect")
        cs = jnp.cumsum(p, axis=0, dtype=jnp.float32)
        zero = jnp.zeros((1,) + p.shape[1:], jnp.float32)
        cs = jnp.concatenate([zero, cs], axis=0)
        h = x.shape[0]
        return (jax.lax.slice_in_dim(cs, k, k + h, axis=0)
                - jax.lax.slice_in_dim(cs, 0, h, axis=0)) / float(k)

    x = along_axis0(img.astype(jnp.float32), ksize_h)
    x = jnp.swapaxes(along_axis0(jnp.swapaxes(x, 0, 1), ksize_w), 0, 1)
    return x


# ---------------------------------------------------------------------------
# Colour / alpha utilities
# ---------------------------------------------------------------------------


def rgba_to_gray_u8(img: jax.Array) -> jax.Array:
    """OpenCV-bit-exact RGBA(uint8) -> gray(uint8).

    The reference converts its BGRA canvas with cvtColor(CV_BGRA2GRAY)
    (CPU/PixFlow.hpp:90-91); with semantic channel weights this is
    y = (9798*R + 19235*G + 3735*B + 16384) >> 15 in fixed point
    (verified bit-exact against the installed OpenCV).
    """
    r = img[..., 0].astype(jnp.int32)
    g = img[..., 1].astype(jnp.int32)
    b = img[..., 2].astype(jnp.int32)
    y = (9798 * r + 19235 * g + 3735 * b + 16384) >> 15
    return y.astype(jnp.uint8)


def threshold_binary(src: jax.Array, thresh: float, maxval: float) -> jax.Array:
    """cv::threshold THRESH_BINARY: maxval where src > thresh else 0."""
    return jnp.where(src > thresh, jnp.asarray(maxval, src.dtype),
                     jnp.asarray(0, src.dtype))


def saturating_add_u8(a: jax.Array, b: jax.Array) -> jax.Array:
    """uint8 saturating add (cv::Mat operator+ semantics)."""
    s = a.astype(jnp.uint16) + b.astype(jnp.uint16)
    return jnp.minimum(s, 255).astype(jnp.uint8)


def wrap_extend_x(img: jax.Array, length: int) -> jax.Array:
    """Periodic wrap-extension on the x axis by ``length`` columns each side.

    The equirectangular canvas wraps at 360 degrees; the reference builds
    this halo with warpPerspective shift + edge-strip copies
    (CPU/OpticalFlow.cpp:113-126, CPU/StitchTool.cpp:104-111).  Here it is
    a single concat -- and under shard_map the same halo becomes a cyclic
    ppermute across the mesh edge.
    """
    if length == 0:
        return img
    return jnp.concatenate([img[:, -length:], img, img[:, :length]], axis=1)


def crop_x(img: jax.Array, length: int) -> jax.Array:
    """Undo wrap_extend_x."""
    return img[:, length:img.shape[1] - length]
