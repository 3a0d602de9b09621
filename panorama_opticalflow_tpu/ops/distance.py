"""Directional first-hit distance fields as associative scans.

The reference computes seam-blend weights and hole fills with per-pixel
8-ray searches (CPU/StitchTool.cpp:148-191 ``countblend`` and
CPU/StitchTool.cpp:75-94 ``Gather``): from each pixel, walk rays in the 4
axis and 4 diagonal directions with some stride and record the distance to
the first pixel of a target class.  On GPU the reference parallelises the
per-pixel walk (GPU/StitchTool_GPU.cu:10-66) but each thread still does an
O(width) strided scan.

Array formulation: the first-hit distance along a direction is a
*suffix min-scan* over that direction's lines.  For each of the 8
directions we reindex the mask so the direction becomes a contiguous array
axis (flips for the negative directions, shears for the diagonals, a
stride reshape for the ray step), run one ``lax.associative_scan`` (log N
vectorised passes), and map back.  The result is bit-equivalent
to the reference's ray semantics -- including its exact boundary
conditions (``x - i > 0`` excludes row/column 0 for negative directions)
-- with no data-dependent control flow.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

_INF = jnp.float32(jnp.inf)


def _first_hit_steps(mask: jax.Array, axis: int, reverse: bool) -> jax.Array:
    """Steps (>=0) along ``axis`` to the first True at-or-after each
    position (in scan direction); +inf where none."""
    n = mask.shape[axis]
    idx = jax.lax.broadcasted_iota(jnp.float32, mask.shape, axis)
    pos = jnp.where(mask, idx, _INF)
    if reverse:
        # looking toward decreasing index: first True at-or-before
        best = jax.lax.associative_scan(jnp.maximum,
                                        jnp.where(mask, idx, -_INF), axis=axis)
        return idx - best
    best = jax.lax.associative_scan(jnp.minimum, pos, reverse=True, axis=axis)
    return best - idx


def _strided_first_hit_x(mask: jax.Array, step: int, reverse: bool) -> jax.Array:
    """First-hit pixel distance along +x (or -x) visiting only multiples of
    ``step``: positions x, x+step, x+2*step, ..."""
    h, w = mask.shape
    if step == 1:
        return _first_hit_steps(mask, axis=1, reverse=reverse)
    wq = -(-w // step)
    pad = wq * step - w
    m = jnp.pad(mask, ((0, 0), (0, pad)))
    m = m.reshape(h, wq, step)
    d = _first_hit_steps(m, axis=1, reverse=reverse) * step
    return d.reshape(h, wq * step)[:, :w]


def _shear_by_row(a: jax.Array, wc: int) -> jax.Array:
    """out[y, x + y] = a[y, x]; output (H, wc), unsourced entries zero.

    A row-dependent shift of exactly +y columns is one pad + reshape +
    slice: flattening rows of width wc+1 row-major puts a[y, x] at flat
    index y*(wc+1) + x = y*wc + (x + y), i.e. row y column x+y of a
    width-wc view.  One relayout copy -- no roll chains, no gathers
    (the previous binary-decomposed roll formulation was log2(H) fused
    roll+select passes, whose unrolled graph took the compiler very
    long at 9000-wide canvases and dominated the blend-field runtime).
    Requires wc >= w + h - 2 so no content crosses a row boundary."""
    h, w = a.shape
    p = jnp.pad(a, ((0, 0), (0, wc + 1 - w)))
    return p.reshape(-1)[: h * wc].reshape(h, wc)


def _unshear_by_row(a: jax.Array, w: int) -> jax.Array:
    """Inverse of _shear_by_row: out[y, x] = a[y, x + y], output (H, w)."""
    h, wc = a.shape
    flat = jnp.pad(a.reshape(-1), (0, h))
    return flat.reshape(h, wc + 1)[:, :w]


def _roll_x(a: jax.Array, shift) -> jax.Array:
    """jnp.roll along axis 1, skipped when the shift is statically 0."""
    if isinstance(shift, int) and shift == 0:
        return a
    return jnp.roll(a, shift, axis=1)


def _shear(mask: jax.Array, sign: int,
           row_offset: int | jax.Array = 0,
           total_h: int | None = None) -> jax.Array:
    """Reindex so diagonals become columns.

    sign=+1: out[y, x - (y+off) + (TH-1)] = mask[y, x]  (conserves x - y;
    the (+1,+1)/(-1,-1) diagonals are columns of the output).
    sign=-1: out[y, x + (y+off)] = mask[y, x]           (conserves x + y;
    the (+1,-1)/(-1,+1) diagonals are columns).
    Out-of-range entries are False/0.  For row-sharded callers pass the
    global ``row_offset`` of local row 0 and the global ``total_h``; the
    offset becomes one uniform (optionally dynamic) roll on top of the
    reshape shear.  No content ever wraps: wc = w + TH - 1 bounds every
    shifted column (x <= w-1, y+off <= TH-1).
    """
    h, w = mask.shape
    th = total_h if total_h is not None else h
    wc = w + th - 1
    if sign > 0:
        # shift row y right by (TH-1) - (y+off): flip rows so the shift
        # grows with the row index, shear, add the constant part, unflip
        sheared = _shear_by_row(mask[::-1], wc)
        return _roll_x(sheared, th - h - row_offset)[::-1]
    return _roll_x(_shear_by_row(mask, wc), row_offset)


def _unshear(arr: jax.Array, sign: int, w: int,
             row_offset: int | jax.Array = 0,
             total_h: int | None = None) -> jax.Array:
    h = arr.shape[0]
    th = total_h if total_h is not None else h
    if sign > 0:
        out = _roll_x(arr[::-1], -(th - h - row_offset))
        return _unshear_by_row(out, w)[::-1]
    return _unshear_by_row(_roll_x(arr, -row_offset), w)


def _strided_first_hit_axis0(mask: jax.Array, step: int, reverse: bool) -> jax.Array:
    if step == 1:
        return _first_hit_steps(mask, axis=0, reverse=reverse)
    h = mask.shape[0]
    hq = -(-h // step)
    pad = hq * step - h
    m = jnp.pad(mask, ((0, pad),) + ((0, 0),) * (mask.ndim - 1))
    m = m.reshape((hq, step) + mask.shape[1:])
    d = _first_hit_steps(m, axis=0, reverse=reverse) * step
    return d.reshape((hq * step,) + mask.shape[1:])[:h]


def _shift_inf(a: jax.Array, dy: int, dx: int) -> jax.Array:
    """out[y, x] = a[y + dy, x + dx]; +inf outside the array."""
    h, w = a.shape
    p = jnp.pad(a, ((max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))),
                constant_values=jnp.inf)
    return jax.lax.slice(p, (max(dy, 0), max(dx, 0)),
                         (max(dy, 0) + h, max(dx, 0) + w))


def bounded_first_hit(mask: jax.Array, radius: int, dy: int, dx: int
                      ) -> jax.Array:
    """Steps to the first True of ``mask`` along unit direction
    (dy, dx), visiting i = 0, 1, 2, ... with i < radius; +inf where no
    hit.  Rays stop at the array edge.

    Pointer-doubling min-plus: after the k-th pass d holds the exact
    first-hit distance within [0, 2^k) steps -- ceil(log2(radius))
    shift+add+min passes, a tiny graph (the scan+shear formulation at
    unit stride builds full-canvas-length scan chains that are slow to
    compile, and does O(W) work for an O(radius) search).
    """
    d = jnp.where(mask, jnp.float32(0), _INF)
    k = 1
    while k < radius:
        d = jnp.minimum(d, _shift_inf(d, dy * k, dx * k) + k)
        k <<= 1
    return jnp.where(d < radius, d, _INF)


def eight_ray_unit_min_distance(mask: jax.Array, radius: int) -> jax.Array:
    """Min raw-step distance to a True pixel along the reference's 8
    rays at unit stride, bounded by ``radius`` (Gather's hole search,
    CPU/StitchTool.cpp:75-94: straight and diagonal rays both count raw
    steps).  Boundary semantics match eight_ray_min_distance(mask, 1,
    radius, diag_scale=1.0): candidates at column 0 are invisible to -x
    rays and at row 0 to -y rays.  The pipeline uses the fused
    two_class_hole_search; this single-class form is its semantic
    reference (pinned to the scan formulation in tests).
    """
    mask = jnp.asarray(mask)
    no_col0 = mask.at[:, 0].set(False)
    no_row0 = mask.at[0, :].set(False)
    no_both = no_col0.at[0, :].set(False)

    out = bounded_first_hit(mask, radius, 0, 1)
    for m, dy, dx in ((no_col0, 0, -1), (mask, 1, 0), (no_row0, -1, 0),
                      (mask, 1, 1), (no_both, -1, -1),
                      (no_col0, 1, -1), (no_row0, -1, 1)):
        out = jnp.minimum(out, bounded_first_hit(m, radius, dy, dx))
    return out


_I16_INF = jnp.int16(32000)  # sentinel; adds stay < int16 max


def _shift_i16(a: jax.Array, dy: int, dx: int) -> jax.Array:
    h, w = a.shape
    p = jnp.pad(a, ((max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))),
                constant_values=_I16_INF)
    return jax.lax.slice(p, (max(dy, 0), max(dx, 0)),
                         (max(dy, 0) + h, max(dx, 0) + w))


def two_class_hole_search(
    mask_l: jax.Array, mask_r: jax.Array, radius: int,
    row0_excluded: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Gather's hole search for both target classes in ONE doubling
    field: encode v = 2*d + (class == R) in int16, so min() orders by
    distance with L winning ties -- exactly the ``d_l <= d_r``
    first-found-L rule (CPU/StitchTool.cpp:77-94) -- at half the passes
    and a quarter of the f32 two-field traffic.

    Returns (found, take_l) boolean maps.  Boundary semantics match
    eight_ray_unit_min_distance: candidates at column 0 are invisible
    to -x rays and at row 0 to -y rays.  ``row0_excluded``: row-sharded
    callers pass the rows-are-global-row-0 map instead of local row 0
    (local col 0 IS global col 0 for row tiles, so that default holds).
    """
    l16 = jnp.asarray(mask_l)
    r16 = jnp.asarray(mask_r)
    v0 = jnp.where(l16, jnp.int16(0),
                   jnp.where(r16, jnp.int16(1), _I16_INF))
    either = l16 | r16
    if row0_excluded is None:
        row0 = jax.lax.broadcasted_iota(jnp.int32, v0.shape, 0) == 0
    else:
        row0 = row0_excluded
    col0 = jax.lax.broadcasted_iota(jnp.int32, v0.shape, 1) == 0
    v_nc0 = jnp.where(col0 & either, _I16_INF, v0)
    v_nr0 = jnp.where(row0 & either, _I16_INF, v0)
    v_nb = jnp.where((row0 | col0) & either, _I16_INF, v0)

    def ray(v, dy, dx):
        d = v
        k = 1
        while k < radius:
            d = jnp.minimum(d, _shift_i16(d, dy * k, dx * k)
                            + jnp.int16(2 * k))
            k <<= 1
        return d

    out = ray(v0, 0, 1)
    for v, dy, dx in ((v_nc0, 0, -1), (v0, 1, 0), (v_nr0, -1, 0),
                      (v0, 1, 1), (v_nb, -1, -1),
                      (v_nc0, 1, -1), (v_nr0, -1, 1)):
        out = jnp.minimum(out, ray(v, dy, dx))
    found = out < jnp.int16(2 * radius)  # v = 2d + c < 2r  <=>  d < r
    take_l = (out & jnp.int16(1)) == 0
    return found, take_l


def eight_ray_min_distance(
    mask: jax.Array, step: int, max_i: float, diag_scale: float | None = None,
    exclude_borders: bool = True,
) -> jax.Array:
    """Min distance from each pixel to a True pixel of ``mask`` along the
    reference's 8 rays with stride ``step``, visiting i in
    [0, step, 2*step, ...) with i < max_i.  Straight rays measure i,
    diagonal rays i*diag_scale -- sqrt(2) for the blend field
    (CPU/StitchTool.cpp:158-183) and 1 for Gather's hole search, which
    counts raw ray steps (CPU/StitchTool.cpp:77-88).  Boundary semantics
    match the reference: candidates at column 0 are invisible to -x rays
    and at row 0 to -y rays (the ``> 0`` bound).  Returns +inf where no
    ray hits.
    """
    mask = jnp.asarray(mask)
    h, w = mask.shape
    if exclude_borders:
        no_col0 = mask.at[:, 0].set(False)
        no_row0 = mask.at[0, :].set(False)
        no_both = no_col0.at[0, :].set(False)
    else:
        # tiled callers pre-apply the global row-0/col-0 exclusions
        no_col0 = no_row0 = no_both = mask

    dists = []

    def keep(d):
        return jnp.where(d < max_i, d, _INF)

    # straight rays
    dists.append(keep(_strided_first_hit_x(mask, step, reverse=False)))
    dists.append(keep(_strided_first_hit_x(no_col0, step, reverse=True)))
    dists.append(keep(_strided_first_hit_axis0(mask, step, reverse=False)))
    dists.append(keep(_strided_first_hit_axis0(no_row0, step, reverse=True)))

    sq2 = math.sqrt(2.0) if diag_scale is None else diag_scale
    # diagonals conserving x - y: down-right (+1,+1), up-left (-1,-1)
    sh = _shear(mask, +1)
    dists.append(_unshear(keep(_strided_first_hit_axis0(sh, step, False)), +1, w) * sq2)
    sh = _shear(no_both, +1)
    dists.append(_unshear(keep(_strided_first_hit_axis0(sh, step, True)), +1, w) * sq2)
    # diagonals conserving x + y: down-left (+1,-1), up-right (-1,+1)
    sh = _shear(no_col0, -1)
    dists.append(_unshear(keep(_strided_first_hit_axis0(sh, step, False)), -1, w) * sq2)
    sh = _shear(no_row0, -1)
    dists.append(_unshear(keep(_strided_first_hit_axis0(sh, step, True)), -1, w) * sq2)

    out = dists[0]
    for d in dists[1:]:
        out = jnp.minimum(out, d)
    return out
