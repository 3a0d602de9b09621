"""Image I/O and synthetic-data generation.

The reference wraps cv::imread/imwrite with exceptions
(CPU/util.cpp:19-46); here PIL handles TIFF/PNG with alpha.  The
reference's Test_data blobs are stripped from its public mount, so
``synthesize_fisheye_set`` generates structurally-equivalent inputs
(N pre-registered RGBA canvases with overlapping footprints on one
equirectangular canvas) for tests and benchmarks.
"""

from __future__ import annotations

import os

import numpy as np


class PanoIOError(RuntimeError):
    """Image read/write failure (the reference's VrCamException)."""


def _pil_image():
    """PIL.Image, imported only where files are read or written."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading or writing image files needs Pillow "
            "(pip install pillow); the stitch itself does not") from e
    return Image


def read_image_rgba(path: str) -> np.ndarray:
    """Read an image file as (H, W, 4) uint8 RGBA; raises on failure
    (imreadExceptionOnFail, CPU/util.cpp:19-26).  3-channel inputs get an
    opaque alpha like the reference's CV_8UC3 -> BGRA promotion
    (CPU/main.cpp:58)."""
    Image = _pil_image()

    if not os.path.exists(path):
        raise PanoIOError(f"failed to load image: {path}")
    try:
        img = Image.open(path)
        img = img.convert("RGBA")
    except Exception as e:  # noqa: BLE001
        raise PanoIOError(f"failed to load image: {path}: {e}") from e
    return np.asarray(img, np.uint8)


def write_image(path: str, img: np.ndarray) -> None:
    """Write (H, W, 4) or (H, W, 3) uint8; raises on failure
    (imwriteExceptionOnFail, CPU/util.cpp:28-34)."""
    Image = _pil_image()

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        Image.fromarray(np.asarray(img)).save(path)
    except Exception as e:  # noqa: BLE001
        raise PanoIOError(f"failed to write image: {path}: {e}") from e


def synthesize_fisheye_set(
    h: int, w: int, n: int = 5, overlap_frac: float = 0.35, seed: int = 0,
    with_top: bool = True,
) -> tuple[list[np.ndarray], np.ndarray | None]:
    """Synthetic pre-registered input set on one (h, w) canvas.

    Produces ``n`` horizontal photos whose footprints are vertical bands
    (wrapping at 360 degrees) with ``overlap_frac`` overlap between
    neighbours, plus an optional top cap image, all views of one shared
    smooth random panorama with small per-photo photometric and geometric
    perturbations -- the structural contract of Test_data
    (README.md:28-33, Figure/Input_requirement.png).
    """
    rng = np.random.default_rng(seed)
    # shared scene: smooth random RGB panorama (periodic in x)
    freqs = 6
    yy = np.linspace(0, 2 * np.pi, h)[:, None]
    xx = np.linspace(0, 2 * np.pi, w, endpoint=False)[None, :]
    scene = np.zeros((h, w, 3))
    for _ in range(freqs):
        fy, fx = rng.integers(1, 6, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(20, 60, 3)
        for c in range(3):
            scene[..., c] += amp[c] * np.sin(fy * yy + fx * xx + phase[c])
    scene = (scene - scene.min()) / (np.ptp(scene) + 1e-9) * 255.0

    band = w / n
    halo = band * overlap_frac
    photos = []
    for i in range(n):
        x0 = i * band - halo / 2
        x1 = (i + 1) * band + halo / 2
        img = np.zeros((h, w, 4), np.uint8)
        cols = (np.arange(w) - x0) % w < (x1 - x0)
        # mild per-photo shift + gain to give the flow something to solve
        shift = int(rng.integers(-3, 4))
        gain = rng.uniform(0.92, 1.08)
        rolled = np.roll(scene, shift, axis=1) * gain
        img[..., :3] = np.clip(rolled, 0, 255).astype(np.uint8)
        img[:, cols, 3] = 255
        img[..., :3] *= (img[..., 3:] > 0)
        photos.append(img)

    top = None
    if with_top:
        top = np.zeros((h, w, 4), np.uint8)
        rows = np.arange(h) < int(h * 0.22)
        top[..., :3] = np.clip(scene * rng.uniform(0.95, 1.05), 0, 255)
        top[rows, :, 3] = 255
        top[..., :3] *= (top[..., 3:] > 0)
    return photos, top


def synthesize_four_input_set(h: int, w: int, seed: int = 0) -> list[np.ndarray]:
    """4 wide-angle photos: 1/3 compose canvas L, 2/4 compose canvas R
    (CPU_4Input/main.cpp:54-80); opposite cameras don't overlap."""
    photos, _ = synthesize_fisheye_set(h, w, n=4, overlap_frac=0.3,
                                       seed=seed, with_top=False)
    return photos
