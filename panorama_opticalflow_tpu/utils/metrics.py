"""Quality metrics: SSIM and endpoint error.

SSIM follows Wang et al. 2004 (gaussian 11x11 sigma 1.5, K1=0.01,
K2=0.03, L=255) -- the gate metric of BASELINE.md (SSIM >= 0.98 vs the
reference output)."""

from __future__ import annotations

import numpy as np


def _gauss_1d(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    c = (ksize - 1) / 2.0
    i = np.arange(ksize) - c
    k = np.exp(-(i ** 2) / (2 * sigma * sigma))
    return k / k.sum()


def _filt(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """'valid' 2-D filtering with the separable window outer(k, k)."""
    n = len(k)
    h, w = img.shape
    rows = sum(k[i] * img[i:h - n + 1 + i] for i in range(n))
    return sum(k[i] * rows[:, i:w - n + 1 + i] for i in range(n))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM over channels of two (H, W[, C]) arrays."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    win = _gauss_1d()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for ch in range(a.shape[2]):
        x, y = a[..., ch], b[..., ch]
        mx, my = _filt(x, win), _filt(y, win)
        mxx, myy, mxy = mx * mx, my * my, mx * my
        sx = _filt(x * x, win) - mxx
        sy = _filt(y * y, win) - myy
        sxy = _filt(x * y, win) - mxy
        s = ((2 * mxy + c1) * (2 * sxy + c2)) / ((mxx + myy + c1) * (sx + sy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def endpoint_error(flow_a: np.ndarray, flow_b: np.ndarray) -> float:
    """Mean Euclidean endpoint error between two (H, W, 2) flow fields."""
    d = np.asarray(flow_a, np.float64) - np.asarray(flow_b, np.float64)
    return float(np.sqrt((d ** 2).sum(-1)).mean())
