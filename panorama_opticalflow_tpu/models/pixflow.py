"""Pixflow: pyramidal coarse-to-fine dense optical flow in JAX.

Re-design of the reference solver (CPU/PixFlow.hpp:28-457).  The
algorithmic skeleton is identical -- downscale, grey+alpha, pre-blur,
~40-level 0.9-factor pyramid, per-level propagation+descent, median
filtering, low-alpha diffusion, final upsample+blur -- but the per-level
computation replaces the two *sequential* raster sweeps
(CPU/PixFlow.hpp:315-337) with Jacobi-style parallel relaxation
iterations, the formulation the reference's own CUDA build uses and
validates (10 rounds of a 4-neighbour kernel, GPU/PixFlow_GPU.cu:274-290).
Every level is a statically-shaped pure function, so the whole pyramid
loop compiles into one XLA program with no host round trips (the
reference GPU build ping-pongs host<->device ~10 Mats per level,
GPU/PixFlow_GPU.cu:259-268).

The error function is the CPU form (CPU/PixFlow.hpp:427-456); the CUDA
variant's data term has a typo (GPU/PixFlow_GPU.cu:107) we deliberately
do not reproduce.
"""

from __future__ import annotations

import dataclasses

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from panorama_opticalflow_tpu.ops import image as im
from panorama_opticalflow_tpu.ops.warp import bilinear_extend
from panorama_opticalflow_tpu.utils.config import FlowParams

# DirectionHint (CPU/PixFlow.hpp:19)
HINTS = ("unknown", "right", "down", "left", "up")


def pyramid_sizes(h: int, w: int, params: FlowParams) -> list[tuple[int, int]]:
    """Level sizes, finest first (CPU/PixFlow.hpp:137-151): repeatedly
    scale by 0.9 (+0.5 rounding) until either side would drop to <= 24
    (<= pyr_stop_size for the _fast presets, see FlowParams)."""
    stop = params.pyr_stop_size or params.pyr_min_image_size
    sizes = [(h, w)]
    while len(sizes) < params.pyr_max_levels:
        ph, pw = sizes[-1]
        nh = int(ph * params.pyr_scale_factor + 0.5)
        nw = int(pw * params.pyr_scale_factor + 0.5)
        if nh <= stop or nw <= stop:
            break
        sizes.append((nh, nw))
    return sizes


def _build_pyramid(img: jax.Array, sizes: list[tuple[int, int]]) -> list[jax.Array]:
    """Progressive linear downscale (each level from the previous one)."""
    pyr = [img]
    for s in sizes[1:]:
        pyr.append(im.resize(pyr[-1], s, "linear"))
    return pyr


# ---------------------------------------------------------------------------
# Rung-scanned descent over the coarse pyramid tail
# ---------------------------------------------------------------------------
#
# The ~40-level 0.9-factor pyramid fully unrolled in one jit produces an
# XLA graph of ~5k ops *per level* (~200k ops at the 36 MP headline),
# which takes the compiler very long to chew on.  The coarse tail carries
# almost no runtime work (level areas decay by 0.81x) but the same
# per-level graph, so: group consecutive coarse levels into "rungs" that
# share the padded shape of the rung's finest member and lax.scan over
# them -- the level body is traced/compiled ONCE per rung.  The
# inter-level flow upsample becomes a per-level banded resize matrix,
# materialised on device from compact 4-tap plans carried as scan
# inputs: two matmuls, bit-identical weights to the static
# resize (reference form: ops/image.resize_axis_matrix).
#
# Padding semantics: images are edge-replicated into the pad (Sobel at
# the valid edge is then exact BORDER_REPLICATE), alphas are zero-padded
# (update masks off, diffusion fills), and the resize matrices both
# ignore input padding and edge-replicate output padding.  The only
# deviation from the unrolled path is blur/median borders at the
# bottom/right valid edges of scanned levels seeing replicated instead
# of reflected content -- gated by tests/test_levelscan.py's
# scan-vs-unrolled checks and the oracle EPE/golden suites.


def _plan_rungs(sizes: list[tuple[int, int]], params: FlowParams,
                lo: int = 0):
    """Split the non-coarsest levels into an unrolled fine prefix and
    scan rungs.  Returns (first_scanned, rungs); rungs is a list of
    lists of consecutive level indices in ascending (fine -> coarse)
    order, empty when scanning is off or not worthwhile.  ``lo`` bounds
    the finest scannable level (the tiled solver passes its first
    replicated level -- tiled levels cannot be scanned)."""
    n = len(sizes)
    if not params.scan_coarse_levels or n < 3:
        return n, []
    s = next((i for i in range(n) if sizes[i][0] * sizes[i][1]
              <= params.scan_max_pixels), n)
    s = max(s, lo, 1)  # the finest level keeps exact border semantics
    last = n - 2   # the coarsest level (init/search) is never scanned
    if last - s + 1 < params.scan_min_levels:
        return n, []
    rungs = [list(range(i, min(i + params.scan_rung_levels, last + 1)))
             for i in range(s, last + 1, params.scan_rung_levels)]
    fr = params.scan_fine_rung_levels
    if fr >= 2:
        # pair the fine unrolled span [f, s) too (compile-time lever for
        # very large canvases; see FlowParams.scan_fine_rung_levels)
        f = max(lo, 1)
        fine = [list(range(i, min(i + fr, s))) for i in range(f, s, fr)]
        if fine:
            return f, fine + rungs
    return s, rungs


def _resize_plan_padded(n_in: int, n_out: int, n_pad: int):
    """Static (idx, w) resample plan extended to n_pad rows (rows beyond
    n_out replicate row n_out - 1, i.e. edge-replicated output padding).
    Carried as tiny scan inputs instead of dense (n_pad, n_pad) matrix
    constants, which at headline scale add ~25 MB to the program."""
    idx, w = im._resize_axis_plan(n_in, n_out, "cubic")
    reps = np.concatenate([np.arange(n_out),
                           np.full(n_pad - n_out, n_out - 1)])
    return idx[reps].astype(np.int32), w[reps]


def _plan_to_matrix(idx: jax.Array, w: jax.Array, n_pad: int) -> jax.Array:
    """Materialise the banded resize matrix A[j, k] = sum_m w[j, m] *
    [idx[j, m] == k] on device (a handful of elementwise ops)."""
    k_iota = jax.lax.broadcasted_iota(jnp.int32, (n_pad, n_pad), 1)
    a = jnp.zeros((n_pad, n_pad), jnp.float32)
    for m in range(idx.shape[1]):
        a = a + jnp.where(k_iota == idx[:, m:m + 1], w[:, m:m + 1], 0.0)
    return a


def _mat_resize_flow(f: jax.Array, ah: jax.Array, aw: jax.Array) -> jax.Array:
    """Resample a (..., H, W, 2) flow with per-axis resize matrices on
    channel-split planes (out = ah @ plane @ aw^T), f32 HIGHEST precision."""
    lead = f.shape[:-3]
    hp, wp = f.shape[-3:-1]
    p = jnp.moveaxis(f, -1, 0).reshape(-1, hp, wp)
    hi = jax.lax.Precision.HIGHEST
    p = jnp.einsum("ij,pjk->pik", ah, p, precision=hi)
    p = jnp.einsum("pik,lk->pil", p, aw, precision=hi)
    return jnp.moveaxis(p.reshape((2,) + lead + (hp, wp)), 0, -1)


def _run_rungs(rungs, sizes, pyr_g, pyr_a, flow, body, params: FlowParams):
    """Run the scanned section of the coarse-to-fine descent.

    ``pyr_g``/``pyr_a`` are [pyramid(img0), pyramid(img1)] lists of
    per-level arrays; ``flow`` enters valid at sizes[rungs[-1][-1] + 1]
    and leaves valid at sizes[rungs[0][0]].  ``body(imgs, alphas, f)``
    runs one level at the rung shape (imgs/alphas are (2, hp, wp))."""
    for rung in reversed(rungs):
        hp, wp = sizes[rung[0]]
        order = rung[::-1]  # scan steps go coarse -> fine

        def pad_to(x, mode):
            return jnp.pad(x, ((0, hp - x.shape[0]), (0, wp - x.shape[1])),
                           mode=mode)

        imgs_xs = jnp.stack([jnp.stack([pad_to(pyr_g[k][i], "edge")
                                        for k in (0, 1)]) for i in order])
        alphas_xs = jnp.stack([jnp.stack([pad_to(pyr_a[k][i], "constant")
                                          for k in (0, 1)]) for i in order])
        plans = [(_resize_plan_padded(sizes[i + 1][0], sizes[i][0], hp),
                  _resize_plan_padded(sizes[i + 1][1], sizes[i][1], wp))
                 for i in order]
        hplan = tuple(jnp.asarray(np.stack([p[0][k] for p in plans]))
                      for k in (0, 1))
        wplan = tuple(jnp.asarray(np.stack([p[1][k] for p in plans]))
                      for k in (0, 1))

        fpad = jnp.zeros(flow.shape[:-3] + (hp, wp, 2), jnp.float32)
        fpad = jax.lax.dynamic_update_slice(
            fpad, flow, (0,) * flow.ndim)

        def step(f, xs):
            imgs_i, alphas_i, hidx, hw, widx, ww = xs
            ah_i = _plan_to_matrix(hidx, hw, hp)
            aw_i = _plan_to_matrix(widx, ww, wp)
            f = _mat_resize_flow(f, ah_i, aw_i) \
                * (1.0 / params.pyr_scale_factor)
            return body(imgs_i, alphas_i, f), None

        flow, _ = jax.lax.scan(step, fpad, (imgs_xs, alphas_xs,
                                            hplan[0], hplan[1],
                                            wplan[0], wplan[1]))
        # each rung exits at its finest member, whose size IS the rung
        # shape -- the carry leaves fully valid, no crop needed
    return flow


def error_function(
    cand: jax.Array,
    i0x: jax.Array,
    i0y: jax.Array,
    i1g: jax.Array,
    blurred_flow: jax.Array,
    params: FlowParams,
) -> jax.Array:
    """Vectorised errorFunction (CPU/PixFlow.hpp:427-456).

    ``cand`` is an (H, W, 2) candidate flow field; ``i1g`` is the packed
    (H, W, 2) gradient image (I1x, I1y) sampled with clamp-to-edge
    bilinear at x + cand.  Returns per-pixel error (H, W).
    """
    h, w = cand.shape[:2]
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    g1 = bilinear_extend(i1g, xs + cand[..., 0], ys + cand[..., 1])
    dx = i0x - g1[..., 0]
    dy = i0y - g1[..., 1]
    data = jnp.sqrt(dx * dx + dy * dy)
    fd = blurred_flow - cand
    smooth = jnp.sqrt(fd[..., 0] ** 2 + fd[..., 1] ** 2)
    reg = (params.vertical_regularization_coef * jnp.abs(cand[..., 1])
           + params.horizontal_regularization_coef * jnp.abs(cand[..., 0])) / w
    return data + params.smoothness_coef * smooth + reg


def _shift_with_valid(arr: jax.Array, dy: int, dx: int):
    """Shift so out[y, x] = arr[y - dy, x - dx]; returns (shifted, valid)."""
    h, w = arr.shape[:2]
    pad = [(max(dy, 0), max(-dy, 0)), (max(dx, 0), max(-dx, 0))]
    pad += [(0, 0)] * (arr.ndim - 2)
    p = jnp.pad(arr, pad)
    out = jax.lax.slice(
        p, (max(-dy, 0), max(-dx, 0)) + (0,) * (arr.ndim - 2),
        (max(-dy, 0) + h, max(-dx, 0) + w) + arr.shape[2:])
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    valid = (yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0) & (xx - dx < w)
    return out, valid


def relax_iteration(
    flow: jax.Array,
    i0x: jax.Array,
    i0y: jax.Array,
    i1g: jax.Array,
    blurred_flow: jax.Array,
    update_mask: jax.Array,
    params: FlowParams,
) -> jax.Array:
    """One Jacobi relaxation round: 4-neighbour propagation (accept
    strictly-better proposals, CPU/PixFlow.hpp:342-362) + one
    finite-difference gradient-descent step (CPU/PixFlow.hpp:364-386)."""
    err = partial(error_function, i0x=i0x, i0y=i0y, i1g=i1g,
                  blurred_flow=blurred_flow, params=params)
    inf = jnp.float32(jnp.inf)

    best_flow = flow
    best_err = err(flow)
    # proposal order mirrors the sweeps: left, up (sweep 1), right, down
    # (sweep 2); strictly-better acceptance makes order a tie-break only.
    for dy, dx in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        cand, valid = _shift_with_valid(flow, dy, dx)
        e = jnp.where(valid, err(cand), inf)
        take = e < best_err
        best_flow = jnp.where(take[..., None], cand, best_flow)
        best_err = jnp.where(take, e, best_err)

    eps = params.grad_epsilon
    ex = err(best_flow + jnp.array([eps, 0.0], jnp.float32))
    ey = err(best_flow + jnp.array([0.0, eps], jnp.float32))
    grad = jnp.stack([(ex - best_err) / eps, (ey - best_err) / eps], axis=-1)
    new = best_flow - params.gradient_step_size * grad
    return jnp.where(update_mask[..., None], new, flow)


def low_alpha_flow_diffusion(
    flow: jax.Array, alpha0: jax.Array, alpha1: jax.Array, params: FlowParams
) -> jax.Array:
    """flow <- lerp(flow, gauss15x15sigma8(flow), 1 - a0*a1)
    (CPU/PixFlow.hpp:388-405)."""
    blurred = im.gaussian_blur(flow, params.blurred_flow_kernel_width,
                               params.blurred_flow_sigma)
    c = (1.0 - alpha0 * alpha1)[..., None]
    return c * blurred + (1.0 - c) * flow


def _shift_clamped(arr: jax.Array, dy: int, dx: int) -> jax.Array:
    """out[y, x] = arr[clamp(y + dy), clamp(x + dx)] (replicate border)."""
    h, w = arr.shape[:2]
    r = max(abs(dy), abs(dx))
    if r == 0:
        return arr
    p = im._pad_spatial(arr, r, r, "edge")
    return jax.lax.slice(
        p, (r + dy, r + dx) + (0,) * (arr.ndim - 2),
        (r + dy + h, r + dx + w) + arr.shape[2:])


def _box5_zero(arr: jax.Array) -> jax.Array:
    """5x5 window sum, zero outside the image (used for patch SAD sums
    where out-of-bounds i0 patch rows/cols are skipped,
    CPU/PixFlow.hpp:163-180)."""
    p = im._pad_spatial(arr, 2, 2, "constant")
    h, w = arr.shape[:2]
    out = jnp.zeros_like(arr)
    for dy in range(5):
        for dx in range(5):
            out = out + jax.lax.slice(
                p, (dy, dx) + (0,) * (arr.ndim - 2),
                (dy + h, dx + w) + arr.shape[2:])
    return out


def search_box_offsets(hint: str, dist: int) -> list[tuple[int, int]]:
    """computeSearchBox offsets in the reference's scan order (dy outer,
    dx inner; CPU/PixFlow.hpp:207-224,249-263)."""
    ratio = 8
    ortho = (dist + ratio // 2) // ratio
    if hint == "right":
        xs, ys = range(0, dist + 1), range(-ortho, ortho + 1)
    elif hint == "left":
        xs, ys = range(-dist, 1), range(-ortho, ortho + 1)
    elif hint == "down":
        xs, ys = range(-ortho, ortho + 1), range(0, dist + 1)
    elif hint == "up":
        xs, ys = range(-ortho, ortho + 1), range(-dist, 1)
    else:
        raise ValueError(f"unexpected direction {hint}")
    return [(dy, dx) for dy in ys for dx in xs]


def adjust_initial_flow(
    i0: jax.Array,
    i1: jax.Array,
    alpha0: jax.Array,
    alpha1: jax.Array,
    hint: str,
    params: FlowParams,
) -> jax.Array:
    """Brute-force init at the coarsest level (CPU/PixFlow.hpp:226-270),
    vectorised: every search offset becomes one shifted 5x5 box-filtered
    SAD map; per-pixel argmin with a 0.8x bias toward zero flow."""
    ratio = jnp.sum(alpha0 * alpha1 * i0) / jnp.sum(alpha0 * alpha1 * i1)
    i1eq = i1 * ratio

    dist = params.search_distance
    offsets = search_box_offsets(hint, dist)
    h, w = i0.shape

    def patch_error(dy: int, dx: int) -> jax.Array:
        shifted_i1 = _shift_clamped(i1eq, dy, dx)
        shifted_a1 = _shift_clamped(alpha1, dy, dx)
        sad = _box5_zero(jnp.abs(i0 - shifted_i1))
        alpha = _box5_zero(alpha0 * shifted_a1)
        length = jnp.float32((dx * dx + dy * dy) ** 0.5)
        e = sad / alpha * (1.0 + length / dist)
        # candidate centre must be in bounds (CPU/PixFlow.hpp:253)
        yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        valid = ((yy + dy >= 0) & (yy + dy < h)
                 & (xx + dx >= 0) & (xx + dx < w))
        return jnp.where(valid, e, jnp.inf)

    err00 = patch_error(0, 0)
    # NaN err00 (zero alpha overlap) keeps zero flow in the reference's
    # strict comparisons -> encode as -inf so the bias entry always wins.
    bias = jnp.where(jnp.isnan(err00), -jnp.inf, 0.8 * err00)
    errs = [bias] + [jnp.nan_to_num(patch_error(dy, dx), nan=jnp.inf)
                     for dy, dx in offsets]
    stack = jnp.stack(errs, axis=0)
    # first occurrence wins ties == the reference's strictly-less update
    choice = jnp.argmin(stack, axis=0)
    cand = jnp.array([(0, 0)] + offsets, jnp.int32)  # (N, (dy, dx))
    sel = cand[choice]  # (H, W, 2) as (dy, dx)
    flow = jnp.stack([sel[..., 1], sel[..., 0]], axis=-1).astype(jnp.float32)
    update = alpha0 > params.update_alpha_threshold
    return jnp.where(update[..., None], flow, 0.0)


def _level_core(
    i0x: jax.Array,
    i0y: jax.Array,
    i1g: jax.Array,
    a0: jax.Array,
    a1: jax.Array,
    flow: jax.Array,
    params: FlowParams,
    coarsest: bool,
    knd=None,
) -> jax.Array:
    """Shared per-level relaxation core on (B, H, W[, C]) batched planes
    (CPU/PixFlow.hpp:306-339 after gradients/init): ``phases`` rounds of
    relaxation + median, then the low-alpha diffusion (C8b).

    ``knd`` is an optional namespace with a ``relax_phase_batched`` entry
    (the signature of ``ops.pallas.relax.relax_phase_batched``); the
    hybrid sharded solver passes ``ops.pallas.partition.
    PartitionedKernels`` so the kernel partitions over the leading (tile)
    batch dim under GSPMD (see parallel/hybrid.py).  ``None`` uses the
    plain kernel module.  Whether the kernel runs at all is
    ``relax.use_relax_kernel``'s choice.
    """
    from panorama_opticalflow_tpu.ops.pallas import relax
    from panorama_opticalflow_tpu.ops.relax_fast import (
        relax_phase_fast, warp_by_flow_tiled)

    k = knd if knd is not None else relax
    nb, h, w = i0x.shape

    update_mask = ((a0 > params.update_alpha_threshold)
                   & (a1 > params.update_alpha_threshold))
    phases = params.coarsest_relax_phases if coarsest else params.relax_phases
    iters = (params.coarsest_relax_iters_per_phase if coarsest
             else params.relax_iters_per_phase)

    use_fast = params.relax_impl == "fast" and not coarsest
    if use_fast:
        use_kernel = relax.use_relax_kernel(h, w)
        blurred_flow = _from_planes(jax.vmap(lambda f: im.gaussian_blur(
            f, params.blurred_flow_kernel_width,
            params.blurred_flow_sigma))(_as_planes(flow)), nb)

        def phase_body(f, _):
            # re-centre per phase: warp the gradient pair by the current
            # flow once, then relax bounded residuals against it
            f_base = f
            w1g_warp = jax.vmap(warp_by_flow_tiled)(i1g, f_base)
            args = (f, f_base, w1g_warp, i0x, i0y, blurred_flow, update_mask)
            if use_kernel:
                f = k.relax_phase_batched(*args, params, iters,
                                          params.fast_window)
            else:
                f = jax.vmap(
                    lambda *a: relax_phase_fast(*a, params, iters,
                                                D=params.fast_window)
                )(*args)
            return _from_planes(jax.vmap(im.median5)(_as_planes(f)), nb), None

        # phases as lax.scan: the phase body (the bulk of the level's
        # graph) is traced/compiled once per level instead of per phase
        flow, _ = jax.lax.scan(phase_body, flow, None, length=phases)
    else:
        blurred_flow = _from_planes(jax.vmap(lambda f: im.gaussian_blur(
            f, params.blurred_flow_kernel_width,
            params.blurred_flow_sigma))(_as_planes(flow)), nb)

        def run_phase(f, gx_, gy_, g1, bf, m):
            def one_iter(fc, _):
                return relax_iteration(fc, gx_, gy_, g1, bf, m, params), None
            fc, _ = jax.lax.scan(one_iter, f, None, length=iters)
            return im.median5(fc)

        def phase_body(f, _):
            return jax.vmap(run_phase)(f, i0x, i0y, i1g, blurred_flow,
                                       update_mask), None

        flow, _ = jax.lax.scan(phase_body, flow, None, length=phases)
    # low-alpha diffusion (C8b), blur on channel-split planes
    blurred = _from_planes(jax.vmap(lambda f: im.gaussian_blur(
        f, params.blurred_flow_kernel_width,
        params.blurred_flow_sigma))(_as_planes(flow)), nb)
    c = (1.0 - a0 * a1)[..., None]
    return c * blurred + (1.0 - c) * flow


def patch_match_level(
    i0: jax.Array,
    i1: jax.Array,
    alpha0: jax.Array,
    alpha1: jax.Array,
    flow: jax.Array | None,
    hint: str,
    params: FlowParams,
) -> jax.Array:
    """One pyramid level (CPU/PixFlow.hpp:272-340)."""
    gk, gs = params.gradient_blur_kernel_width, params.gradient_blur_sigma
    i0x = im.gaussian_blur(im.sobel_x(i0), gk, gs)
    i0y = im.gaussian_blur(im.sobel_y(i0), gk, gs)
    i1x = im.gaussian_blur(im.sobel_x(i1), gk, gs)
    i1y = im.gaussian_blur(im.sobel_y(i1), gk, gs)
    i1g = jnp.stack([i1x, i1y], axis=-1)

    coarsest = flow is None
    if coarsest and _sub_floor_sizes(*i0.shape, params):
        # raised pyramid floor: init on a reference-floor twin, refine
        # here on the fast path (see patch_match_level_batched)
        tiny = _sub_floor_sizes(*i0.shape, params)
        planes = jnp.stack([i0, i1, alpha0, alpha1])
        for s in tiny:
            planes = jax.vmap(lambda x, s=s: im.resize(x, s, "linear"))(
                planes)
        f_t = patch_match_level(planes[0], planes[1], planes[2], planes[3],
                                None, hint,
                                dataclasses.replace(params, pyr_stop_size=0))
        hh, ww = i0.shape
        th, tw = tiny[-1]
        up = im.resize(f_t, (hh, ww), "cubic")
        flow = up * jnp.array([ww / tw, hh / th], jnp.float32)
        coarsest = False
    elif coarsest:
        # 0*i0 ties the init to the input's device-varying type so the
        # relaxation scan carry is consistent under shard_map
        flow = jnp.zeros(i0.shape + (2,), jnp.float32) + 0.0 * i0[..., None]
        if params.max_percentage > 0 and hint != "unknown":
            flow = adjust_initial_flow(i0, i1, alpha0, alpha1, hint, params)

    out = _level_core(i0x[None], i0y[None], i1g[None], alpha0[None],
                      alpha1[None], flow[None], params, coarsest)
    return out[0]


def _sub_floor_sizes(h: int, w: int,
                     params: FlowParams) -> list[tuple[int, int]]:
    """Sizes strictly below a raised pyramid floor (FlowParams.
    pyr_stop_size), continuing the scale cascade from (h, w) down to
    the reference's pyr_min_image_size rule; [] when the floor is not
    raised or (h, w) already sits at the reference floor.  Used by the
    coarsest-level init-floor solve (patch_match_level[_batched])."""
    if not params.pyr_stop_size or \
            params.pyr_stop_size <= params.pyr_min_image_size:
        return []
    return pyramid_sizes(
        h, w, dataclasses.replace(params, pyr_stop_size=0))[1:]


def _preprocess(rgba: jax.Array, params: FlowParams,
                out_hw: tuple[int, int]) -> tuple[jax.Array, jax.Array]:
    """Downscale + grey/alpha floats + pre-blur (CPU/PixFlow.hpp:78-103)."""
    r = im.resize_u8(rgba, out_hw, "cubic")
    g = im.rgba_to_gray_u8(r).astype(jnp.float32) / 255.0
    a = r[..., 3].astype(jnp.float32) / 255.0
    g = im.gaussian_blur(g, params.pre_blur_kernel_width, params.pre_blur_sigma)
    return g, a


def compute_optical_flow(
    rgba0: jax.Array, rgba1: jax.Array, params: FlowParams, hint: str
) -> jax.Array:
    """Full solver (CPU/PixFlow.hpp:72-135): returns (H, W, 2) float32
    flow at the input resolution.  Inputs are (H, W, 4) uint8 RGBA."""
    h, w = rgba0.shape[:2]
    dh, dw = int(h * params.downscale_factor), int(w * params.downscale_factor)
    i0, a0 = _preprocess(rgba0, params, (dh, dw))
    i1, a1 = _preprocess(rgba1, params, (dh, dw))

    sizes = pyramid_sizes(dh, dw, params)
    p_i0 = _build_pyramid(i0, sizes)
    p_i1 = _build_pyramid(i1, sizes)
    p_a0 = _build_pyramid(a0, sizes)
    p_a1 = _build_pyramid(a1, sizes)

    n = len(sizes)
    first_scanned, rungs = _plan_rungs(sizes, params)

    # coarsest level: zero/search init + exact relaxation
    flow = patch_match_level(p_i0[n - 1], p_i1[n - 1], p_a0[n - 1],
                             p_a1[n - 1], None, hint, params)
    finest_done = n - 1
    if rungs:
        def body(imgs_i, alphas_i, f):
            return patch_match_level(imgs_i[0], imgs_i[1], alphas_i[0],
                                     alphas_i[1], f, hint, params)

        flow = _run_rungs(rungs, sizes, [p_i0, p_i1], [p_a0, p_a1],
                          flow, body, params)
        finest_done = first_scanned
    for level in range(finest_done - 1, -1, -1):
        flow = im.resize(flow, sizes[level], "cubic")
        flow = flow * (1.0 / params.pyr_scale_factor)
        flow = patch_match_level(p_i0[level], p_i1[level], p_a0[level],
                                 p_a1[level], flow, hint, params)

    flow = im.resize(flow, (h, w), "linear")
    flow = flow * (1.0 / params.downscale_factor)
    flow = im.gaussian_blur(flow, params.final_flow_blur_kernel_width,
                            params.final_flow_blur_sigma)
    return flow


# ---------------------------------------------------------------------------
# Direction-batched pair solver
# ---------------------------------------------------------------------------
#
# The novel-view generator always needs *both* flow directions of a pair
# (CPU/OpticalFlow.cpp:128-139).  Running them as two independent solver
# calls doubles the number of per-level kernel launches -- the dominant
# fixed cost at the ~30-40 small pyramid levels -- and rebuilds the same
# image pyramids twice.  Here both directions share one set of pyramids
# and every per-level op processes a leading batch axis of 2 (vmap on the
# XLA path and through the relax kernel's batching rule), so per-level
# launch count matches a single direction.  Semantics are identical to
# two compute_optical_flow calls.


def _as_planes(f: jax.Array) -> jax.Array:
    """(B, H, W, 2) flow -> (2B, H, W) channel-split planes.

    The heavy per-level flow ops (15x15 blurs, medians, resizes) run
    on 2-D planes instead of a trailing dim of 2."""
    b, h, w, _ = f.shape
    return jnp.moveaxis(f, 3, 1).reshape(b * 2, h, w)


def _from_planes(p: jax.Array, b: int) -> jax.Array:
    b2, h, w = p.shape
    return jnp.moveaxis(p.reshape(b, 2, h, w), 1, 3)


def patch_match_level_batched(
    imgs: jax.Array,
    alphas: jax.Array,
    flow: jax.Array | None,
    hints: tuple[str, str],
    params: FlowParams,
    knd=None,
) -> jax.Array:
    """Batched patch_match_level over the two directions of a pair.

    ``imgs``/``alphas`` are (2, H, W): index 0 is the pair's first image,
    index 1 the second.  Direction b solves flow from imgs[b] to
    imgs[1-b], so per-direction inputs are i0 = imgs, i1 = imgs[::-1].
    ``flow`` is (2, H, W, 2) or None at the coarsest level.  ``knd``:
    optional kernel namespace, see _level_core.
    """
    gk, gs = params.gradient_blur_kernel_width, params.gradient_blur_sigma
    # one gradient computation per unique image; each serves as i0 grads
    # in its own direction and (flipped) as i1 grads in the other
    gx = jax.vmap(lambda g: im.gaussian_blur(im.sobel_x(g), gk, gs))(imgs)
    gy = jax.vmap(lambda g: im.gaussian_blur(im.sobel_y(g), gk, gs))(imgs)
    i0x, i0y = gx, gy
    i1g = jnp.stack([gx[::-1], gy[::-1]], axis=-1)  # (2, H, W, 2)
    a0, a1 = alphas, alphas[::-1]

    coarsest = flow is None
    if coarsest and _sub_floor_sizes(*imgs.shape[1:], params):
        # raised pyramid floor (pyr_stop_size, _fast presets): run the
        # zero/search init + exact relaxation on a <=pyr_min_image_size
        # twin of this level (identical cost to the reference-rule
        # coarsest -- the exact path is iteration-latency-bound and
        # scales badly with area), then refine THIS
        # level as a normal fast-path level off the upsampled init.
        tiny = _sub_floor_sizes(*imgs.shape[1:], params)
        imgs_t, alphas_t = imgs, alphas
        for s in tiny:  # progressive, like the reference pyramid build
            imgs_t = jax.vmap(lambda x, s=s: im.resize(x, s, "linear"))(
                imgs_t)
            alphas_t = jax.vmap(lambda x, s=s: im.resize(x, s, "linear"))(
                alphas_t)
        f_t = patch_match_level_batched(
            imgs_t, alphas_t, None, hints,
            dataclasses.replace(params, pyr_stop_size=0), knd)
        hh, ww = imgs.shape[1:]
        th, tw = tiny[-1]
        up = jax.vmap(lambda f: im.resize(f, (hh, ww), "cubic"))(f_t)
        flow = up * jnp.array([ww / tw, hh / th], jnp.float32)
        coarsest = False
    elif coarsest:
        flows = []
        for b, hint in enumerate(hints):
            f = jnp.zeros(imgs.shape[1:] + (2,), jnp.float32) \
                + 0.0 * imgs[b][..., None]
            if params.max_percentage > 0 and hint != "unknown":
                f = adjust_initial_flow(imgs[b], imgs[1 - b], a0[b], a1[b],
                                        hint, params)
            flows.append(f)
        flow = jnp.stack(flows)

    return _level_core(i0x, i0y, i1g, a0, a1, flow, params, coarsest, knd)


def patch_match_level_tiles(
    imgs: jax.Array,
    alphas: jax.Array,
    flow: jax.Array,
    params: FlowParams,
    knd=None,
) -> jax.Array:
    """Per-tile independent twin of patch_match_level_batched for the
    hybrid sharded solver (parallel/hybrid.py): ``imgs``/``alphas`` are
    (T, 2, H, W) halo-extended row tiles, ``flow`` (T, 2, H, W, 2) --
    never the coarsest level, so ``flow`` is required and no direction
    hints are needed.  The two directions of a tile find their partner
    by the within-tile swap (T stays aligned).  All per-level ops run
    with a folded leading batch of 2T, which GSPMD partitions over the
    row mesh (the batch IS the tile decomposition)."""
    t = imgs.shape[0]
    b = t * 2

    def fold(x):
        return x.reshape((b,) + x.shape[2:])

    def swap(x):  # partner within each tile, preserved by the fold
        return x.reshape((t, 2) + x.shape[1:])[:, ::-1].reshape(x.shape)

    gk, gs = params.gradient_blur_kernel_width, params.gradient_blur_sigma
    imf = fold(imgs)
    gx = jax.vmap(lambda g: im.gaussian_blur(im.sobel_x(g), gk, gs))(imf)
    gy = jax.vmap(lambda g: im.gaussian_blur(im.sobel_y(g), gk, gs))(imf)
    i1g = jnp.stack([swap(gx), swap(gy)], axis=-1)
    a0 = fold(alphas)
    a1 = swap(a0)
    out = _level_core(gx, gy, i1g, a0, a1, fold(flow), params, False, knd)
    return out.reshape((t, 2) + out.shape[1:])


def compute_optical_flow_pair(
    rgba0: jax.Array, rgba1: jax.Array, params: FlowParams,
    hint01: str = "left", hint10: str = "right",
) -> tuple[jax.Array, jax.Array]:
    """Both flow directions of a pair in one batched pyramid descent.

    Returns (flow 0->1 with hint01, flow 1->0 with hint10); numerically
    identical to two compute_optical_flow calls, at roughly half the
    per-level launch count and one shared set of image pyramids.
    """
    h, w = rgba0.shape[:2]
    dh, dw = int(h * params.downscale_factor), int(w * params.downscale_factor)
    g0, a0 = _preprocess(rgba0, params, (dh, dw))
    g1, a1 = _preprocess(rgba1, params, (dh, dw))

    sizes = pyramid_sizes(dh, dw, params)
    p_g = [_build_pyramid(g, sizes) for g in (g0, g1)]
    p_a = [_build_pyramid(a, sizes) for a in (a0, a1)]

    hints = (hint01, hint10)

    def vresize(f, s, m):
        # resize on channel-split planes
        return _from_planes(jax.vmap(lambda x: im.resize(x, s, m))(
            _as_planes(f)), f.shape[0])

    def run_level(level, flow):
        imgs = jnp.stack([p_g[0][level], p_g[1][level]])
        alphas = jnp.stack([p_a[0][level], p_a[1][level]])
        return patch_match_level_batched(imgs, alphas, flow, hints, params)

    n = len(sizes)
    first_scanned, rungs = _plan_rungs(sizes, params)

    flow = run_level(n - 1, None)  # coarsest: zero/search init, exact
    finest_done = n - 1
    if rungs:
        def body(imgs_i, alphas_i, f):
            return patch_match_level_batched(imgs_i, alphas_i, f, hints,
                                             params)

        flow = _run_rungs(rungs, sizes, p_g, p_a, flow, body, params)
        finest_done = first_scanned
    for level in range(finest_done - 1, -1, -1):
        flow = vresize(flow, sizes[level], "cubic")
        flow = flow * (1.0 / params.pyr_scale_factor)
        flow = run_level(level, flow)

    flow = vresize(flow, (h, w), "linear")
    flow = flow * (1.0 / params.downscale_factor)
    flow = _from_planes(jax.vmap(lambda f: im.gaussian_blur(
        f, params.final_flow_blur_kernel_width,
        params.final_flow_blur_sigma))(_as_planes(flow)), 2)
    return flow[0], flow[1]
