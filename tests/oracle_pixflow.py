"""Sequential per-pixel oracle of the reference pixflow solver and
novel-view combiner (CPU/PixFlow.hpp, CPU/OpticalFlow.cpp), used to
validate the vectorised array formulations.  Uses cv2 for the same
primitives the reference takes from OpenCV.  Slow by design; tiny images
only."""

import math

import cv2
import numpy as np


class P:
    """pixflow_low / pixflow_search_20 preset constants."""

    pyr_scale = 0.9
    smoothness = 0.001
    vreg = 0.01
    hreg = 0.01
    step_size = 0.5
    downscale = 0.5
    min_size = 24
    alpha_thr = 0.9
    grad_eps = 0.001

    def __init__(self, max_percentage=0):
        self.max_percentage = max_percentage

    @property
    def search_dist(self):
        return (self.min_size * self.max_percentage + 50) // 100


def bilinear_extend(img, x, y):
    h, w = img.shape
    x = min(w - 2.0, max(0.0, x))
    y = min(h - 2.0, max(0.0, y))
    x0, y0 = int(x), int(y)
    xr, yr = x - x0, y - y0
    f00, f10 = img[y0, x0], img[y0, x0 + 1]
    f01, f11 = img[y0 + 1, x0], img[y0 + 1, x0 + 1]
    return f00 + (f10 - f00) * xr + (f01 - f00) * yr \
        + (f00 + f11 - f10 - f01) * xr * yr


def error_function(p, i0x, i0y, i1x, i1y, x, y, blurred_flow, fx, fy, w):
    mx, my = x + fx, y + fy
    g1x = bilinear_extend(i1x, mx, my)
    g1y = bilinear_extend(i1y, mx, my)
    dx0, dy0 = i0x[y, x] - g1x, i0y[y, x] - g1y
    bfx, bfy = blurred_flow[y, x]
    sm = math.sqrt((bfx - fx) ** 2 + (bfy - fy) ** 2)
    return (math.sqrt(dx0 * dx0 + dy0 * dy0) + sm * p.smoothness
            + p.vreg * abs(fy) / w + p.hreg * abs(fx) / w)


def compute_patch_error(i0, a0, i0x, i0y, i1, a1, i1x, i1y, dist):
    sad = 0.0
    alpha = 0.0
    h, w = i0.shape
    for dy in range(-2, 3):
        d0y = i0y + dy
        if 0 <= d0y < h:
            d1y = min(max(i1y + dy, 0), h - 1)
            for dx in range(-2, 3):
                d0x = i0x + dx
                if 0 <= d0x < w:
                    d1x = min(max(i1x + dx, 0), w - 1)
                    sad += abs(i0[d0y, d0x] - i1[d1y, d1x])
                    alpha += a0[d0y, d0x] * a1[d1y, d1x]
    with np.errstate(divide="ignore", invalid="ignore"):
        sad = sad / alpha if alpha != 0 else (np.inf if sad > 0 else np.nan)
    length = math.hypot(i1x - i0x, i1y - i0y)
    return sad * (1 + length / dist)


def search_box(hint, dist):
    ratio = 8
    ortho = (dist + ratio // 2) // ratio
    if hint == "right":
        return (0, -ortho, dist + 1, 2 * ortho + 1)
    if hint == "left":
        return (-dist, -ortho, dist + 1, 2 * ortho + 1)
    if hint == "down":
        return (-ortho, 0, 2 * ortho + 1, dist + 1)
    if hint == "up":
        return (-ortho, -dist, 2 * ortho + 1, dist + 1)
    raise ValueError(hint)


def adjust_initial_flow(p, i0, i1, a0, a1, flow, hint):
    num = float((a0 * a1 * i0).sum())
    den = float((a0 * a1 * i1).sum())
    i1eq = i1 * (num / den)
    bx, by, bw, bh = search_box(hint, p.search_dist)
    h, w = i0.shape
    for y0 in range(h):
        for x0 in range(w):
            if a0[y0, x0] > p.alpha_thr:
                best = 0.8 * compute_patch_error(
                    i0, a0, x0, y0, i1eq, a1, x0, y0, p.search_dist)
                bx1, by1 = x0, y0
                for dy in range(by, by + bh):
                    for dx in range(bx, bx + bw):
                        x1, y1 = x0 + dx, y0 + dy
                        if 0 <= x1 < w and 0 <= y1 < h:
                            e = compute_patch_error(
                                i0, a0, x0, y0, i1eq, a1, x1, y1, p.search_dist)
                            if best > e:
                                best, bx1, by1 = e, x1, y1
                flow[y0, x0] = (bx1 - x0, by1 - y0)


def patch_match_level(p, i0, i1, a0, a1, flow, hint):
    def grad_pair(img):
        gx = cv2.Sobel(img, -1, 1, 0, ksize=1, borderType=cv2.BORDER_REPLICATE)
        gy = cv2.Sobel(img, -1, 0, 1, ksize=1, borderType=cv2.BORDER_REPLICATE)
        return (cv2.GaussianBlur(gx, (3, 3), 0.5),
                cv2.GaussianBlur(gy, (3, 3), 0.5))

    i0x, i0y = grad_pair(i0)
    i1x, i1y = grad_pair(i1)
    h, w = i0.shape

    if flow is None:
        flow = np.zeros((h, w, 2), np.float32)
        if p.max_percentage > 0 and hint != "unknown":
            adjust_initial_flow(p, i0, i1, a0, a1, flow, hint)

    blurred = cv2.GaussianBlur(flow, (15, 15), 8.0)

    def err(x, y, fx, fy):
        return error_function(p, i0x, i0y, i1x, i1y, x, y, blurred, fx, fy, w)

    def sweep(xs, ys, props):
        for y in ys:
            for x in xs:
                if a0[y, x] > p.alpha_thr and a1[y, x] > p.alpha_thr:
                    cur = err(x, y, *flow[y, x])
                    for dy, dx, cond in props:
                        if cond(x, y):
                            pf = flow[y + dy, x + dx]
                            e = err(x, y, pf[0], pf[1])
                            if e < cur:
                                flow[y, x] = pf
                                cur = e
                    fx, fy = flow[y, x]
                    gx = (err(x, y, fx + p.grad_eps, fy) - cur) / p.grad_eps
                    gy = (err(x, y, fx, fy + p.grad_eps) - cur) / p.grad_eps
                    flow[y, x] -= p.step_size * np.array([gx, gy], np.float32)

    sweep(range(w), range(h),
          [(0, -1, lambda x, y: x > 0), (-1, 0, lambda x, y: y > 0)])
    flow = cv2.medianBlur(flow, 5)
    sweep(range(w - 1, -1, -1), range(h - 1, -1, -1),
          [(0, 1, lambda x, y: x < w - 1), (1, 0, lambda x, y: y < h - 1)])
    flow = cv2.medianBlur(flow, 5)

    blurred = cv2.GaussianBlur(flow, (15, 15), 8.0)
    c = (1.0 - a0 * a1)[..., None]
    return (c * blurred + (1 - c) * flow).astype(np.float32)


def pyramid_sizes(h, w, p):
    sizes = [(h, w)]
    while True:
        nh = int(sizes[-1][0] * p.pyr_scale + 0.5)
        nw = int(sizes[-1][1] * p.pyr_scale + 0.5)
        if nh <= p.min_size or nw <= p.min_size:
            break
        sizes.append((nh, nw))
    return sizes


def compute_optical_flow(rgba0, rgba1, p, hint):
    """Full reference solver on RGBA uint8 inputs."""
    h, w = rgba0.shape[:2]
    dh, dw = int(h * p.downscale), int(w * p.downscale)
    r0 = cv2.resize(rgba0, (dw, dh), interpolation=cv2.INTER_CUBIC)
    r1 = cv2.resize(rgba1, (dw, dh), interpolation=cv2.INTER_CUBIC)

    def gray_alpha(img):
        g = cv2.cvtColor(img[..., [2, 1, 0, 3]], cv2.COLOR_BGRA2GRAY)
        return (g.astype(np.float32) / 255.0,
                img[..., 3].astype(np.float32) / 255.0)

    i0, a0 = gray_alpha(r0)
    i1, a1 = gray_alpha(r1)
    i0 = cv2.GaussianBlur(i0, (5, 5), 0.25)
    i1 = cv2.GaussianBlur(i1, (5, 5), 0.25)

    sizes = pyramid_sizes(dh, dw, p)

    def pyr(img):
        out = [img]
        for (sh, sw) in sizes[1:]:
            out.append(cv2.resize(out[-1], (sw, sh),
                                  interpolation=cv2.INTER_LINEAR))
        return out

    p_i0, p_i1, p_a0, p_a1 = pyr(i0), pyr(i1), pyr(a0), pyr(a1)

    flow = None
    for level in range(len(sizes) - 1, -1, -1):
        flow = patch_match_level(p, p_i0[level], p_i1[level],
                                 p_a0[level], p_a1[level], flow, hint)
        if level > 0:
            sh, sw = sizes[level - 1]
            flow = cv2.resize(flow, (sw, sh), interpolation=cv2.INTER_CUBIC)
            flow *= 1.0 / p.pyr_scale
    flow = cv2.resize(flow, (w, h), interpolation=cv2.INTER_LINEAR)
    flow *= 1.0 / p.downscale
    return cv2.GaussianBlur(flow, (3, 3), 1.0)


def combine_novel_views(image_l, image_r, flow_lr, flow_rl, blend):
    """Per-pixel combineNovelViews oracle (CPU/OpticalFlow.cpp:30-92)."""
    h, w = image_l.shape[:2]
    out = np.zeros((h, w, 4), np.uint8)

    def sample(img, flow, t, x, y):
        fx, fy = flow[y, x]
        sx = int(x + fx * t)
        if sx > w - 1:
            sx -= w
        if sx < 0:
            sx += w
        sy = int(y + fy * t)
        sy = min(max(sy, 0), h - 1)
        return img[sy, sx]

    for y in range(h):
        for x in range(w):
            b_r = float(blend[y, x])
            b_l = 1.0 - b_r
            cl = sample(image_l, flow_rl, b_r, x, y)
            cr = sample(image_r, flow_lr, b_l, x, y)
            if cl[3] == 0 or cr[3] == 0:
                continue
            flr = flow_lr[y, x]
            frl = flow_rl[y, x]
            mag_lr = math.hypot(flr[0], flr[1]) / w
            mag_rl = math.hypot(frl[0], frl[1]) / w
            cdiff = (abs(int(cl[0]) - int(cr[0])) + abs(int(cl[1]) - int(cr[1]))
                     + abs(int(cl[2]) - int(cr[2]))) / 255.0
            deghost = math.tanh(cdiff * 10.0)
            al, ar = cl[3] / 255.0, cr[3] / 255.0
            el = math.exp(10.0 * b_l * al * (1.0 + 100.0 * mag_rl))
            er = math.exp(10.0 * b_r * ar * (1.0 + 100.0 * mag_lr))
            s = el + er + 1e-5
            sl, sr = el / s, er / s
            wl = b_l + deghost * (sl - b_l)
            wr = b_r + deghost * (sr - b_r)
            rgb = [float(cl[c]) * wl + float(cr[c]) * wr for c in range(3)]
            out[y, x] = [min(255, max(0, round(v))) for v in rgb] + [255]
    return out
