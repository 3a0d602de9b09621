"""NumPy oracle implementing the reference per-pixel semantics directly.

Each function is a straight transliteration of the cited reference loops
(SURVEY.md section 2) at small sizes, used to validate the vectorised
formulations.  Deliberately slow and loop-based.
"""

import math

import numpy as np


def ray_min_distance(mask: np.ndarray, step: int, max_i: float,
                     diag_scale: float = math.sqrt(2.0)) -> np.ndarray:
    """Per-pixel 8-ray strided search (CPU/StitchTool.cpp:148-191).

    Boundary conditions copied exactly: +x/+y require x+i < W / y+i < H,
    -x/-y require x-i > 0 / y-i > 0 (column/row 0 excluded).
    Returns +inf where no hit.
    """
    h, w = mask.shape
    out = np.full((h, w), np.inf, np.float64)
    for y in range(h):
        for x in range(w):
            best = np.inf
            i = 0
            while i < max_i:
                if x + i < w and mask[y, x + i] and i < best:
                    best = i
                if x - i > 0 and mask[y, x - i] and i < best:
                    best = i
                if y + i < h and mask[y + i, x] and i < best:
                    best = i
                if y - i > 0 and mask[y - i, x] and i < best:
                    best = i
                d = i * diag_scale
                if x + i < w and y + i < h and mask[y + i, x + i] and d < best:
                    best = d
                if x - i > 0 and y - i > 0 and mask[y - i, x - i] and d < best:
                    best = d
                if x + i < w and y - i > 0 and mask[y - i, x + i] and d < best:
                    best = d
                if x - i > 0 and y + i < h and mask[y + i, x - i] and d < best:
                    best = d
                i += step
            out[y, x] = best
    return out


def countblend_field(canvas_map: np.ndarray, extend_div: int = 5,
                     step_div: int = 200):
    """Raw blend field + MergedDis before smoothing
    (CPU/StitchTool.cpp:98-128)."""
    h, w = canvas_map.shape
    length = w // extend_div
    ext = np.concatenate(
        [canvas_map[:, w - length:], canvas_map, canvas_map[:, :length]], axis=1)
    step = max(1, min(h, w) // step_div)

    d_l = ray_min_distance(ext == 100, step, w / 2.0)
    d_r = ray_min_distance(ext == 50, step, w / 2.0)
    none_val = 10.0 * w
    d_l = np.where(np.isinf(d_l), none_val, d_l)
    d_r = np.where(np.isinf(d_r), none_val, d_r)

    blend = np.empty((h, w), np.float64)
    merged_dis = np.zeros((h, w), np.float64)
    for y in range(h):
        for x in range(w):
            code = ext[y, x + length]
            if code == 100:
                blend[y, x] = 0.0
            elif code == 50:
                blend[y, x] = 1.0
            elif code == 150:
                dl, dr = d_l[y, x + length], d_r[y, x + length]
                blend[y, x] = dl / (dl + dr)
                merged_dis[y, x] = min(dl, dr)
            else:
                blend[y, x] = 0.5
    return blend, merged_dis


def gather_loop(canvas_map: np.ndarray, image_l: np.ndarray,
                image_r: np.ndarray, merged: np.ndarray,
                radius: int = 100) -> np.ndarray:
    """Final composite (CPU/StitchTool.cpp:52-96), with rays stopping at
    the canvas edge (the reference reads out of bounds there)."""
    h, w = canvas_map.shape
    code = canvas_map.astype(np.int32) + np.where(merged[..., 3] > 0, 75, 0)
    out = np.zeros((h, w, 4), np.uint8)
    offs = [(0, 1), (0, -1), (1, 0), (-1, 0), (-1, -1), (-1, 1), (1, -1), (1, 1)]
    for y in range(h):
        for x in range(w):
            c = code[y, x]
            if c == 100:
                out[y, x] = image_l[y, x]
            elif c == 50:
                out[y, x] = image_r[y, x]
            elif c in (225, 175, 125):
                out[y, x] = merged[y, x]
            elif c == 150:
                out[y, x] = (0, 0, 0, 255)
                done = False
                for i in range(1, radius):
                    for target, img in ((100, image_l), (50, image_r)):
                        for dy, dx in offs:
                            yy, xx = y + dy * i, x + dx * i
                            ok_x = xx > 0 if dx < 0 else xx < w
                            ok_y = yy > 0 if dy < 0 else yy < h
                            if ok_x and ok_y and code[yy, xx] == target:
                                out[y, x] = img[y, x]
                                done = True
                                break
                        if done:
                            break
                    if done:
                        break
    return out
