"""Tiled (row-sharded, halo-exchange) pipeline vs the untiled program on
an 8-virtual-device CPU mesh (SURVEY.md section 4 test strategy)."""

import dataclasses
import math
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from panorama_opticalflow_tpu.models import pipeline, pixflow, stitcher
from panorama_opticalflow_tpu.ops.distance import eight_ray_min_distance
from panorama_opticalflow_tpu.parallel import tiled
from panorama_opticalflow_tpu.parallel.mesh import make_mesh
from panorama_opticalflow_tpu.utils import io as pio
from panorama_opticalflow_tpu.utils.config import (StitchConfig,
                                                   flow_params_by_name)
from panorama_opticalflow_tpu.utils.metrics import endpoint_error, ssim

N = 8
AXIS = "y"


def _shard_call(mesh, fn, *arrs, out_spec=P(AXIS)):
    f = shard_map(fn, mesh=mesh, in_specs=tuple(P(AXIS) for _ in arrs),
                  out_specs=out_spec)
    return jax.jit(f)(*arrs)


def test_exchange_rows_roundtrip(rng):
    mesh = make_mesh(N)
    x = rng.random((64, 12)).astype(np.float32)

    out = _shard_call(mesh, lambda t: tiled._exchange_rows(t, 3, AXIS),
                      x, out_spec=P(AXIS))
    out = np.asarray(out).reshape(N, 8 + 6, 12)
    for d in range(N):
        core = x[d * 8:(d + 1) * 8]
        np.testing.assert_array_equal(out[d][3:-3], core)
        if d > 0:
            np.testing.assert_array_equal(out[d][:3], x[d * 8 - 3:d * 8])
        else:  # reflect fill at global top
            np.testing.assert_array_equal(out[d][:3], x[1:4][::-1])
        if d < N - 1:
            np.testing.assert_array_equal(out[d][-3:], x[(d + 1) * 8:(d + 1) * 8 + 3])


@pytest.mark.parametrize("h_from,h_to,method", [(64, 32, "cubic"),
                                                (64, 72, "linear"),
                                                (56, 64, "cubic")])
def test_tiled_resize_rows_matches_untiled(rng, h_from, h_to, method):
    mesh = make_mesh(N)
    from panorama_opticalflow_tpu.ops import image as im

    x = rng.random((h_from, 20)).astype(np.float32)
    plan = tiled.make_row_resize_plan(h_from, h_to, N, method)
    hp_from = plan.h_a * N
    xp = np.pad(x, ((0, hp_from - h_from), (0, 0)))
    out = _shard_call(mesh,
                      lambda t: tiled._tiled_resize_rows(t, plan, AXIS), xp)
    out = np.asarray(out)[:h_to]
    ref = np.asarray(im._resize_axis0(jnp.asarray(x), h_to, method))
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("step", [1, 3])
def test_tiled_eight_ray_matches_untiled(rng, step):
    mesh = make_mesh(N)
    h, w = 48, 30
    mask = rng.random((h, w)) < 0.05
    ref = np.asarray(eight_ray_min_distance(mask, step, 14.0))
    out = _shard_call(
        mesh,
        lambda m: tiled._tiled_eight_ray(m, step, 14.0, math.sqrt(2.0),
                                         AXIS, h),
        mask)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-5)


def test_tiled_eight_ray_multi_summary_scan_exact(rng):
    """The r4 summary-exchange strided scans (no full-canvas gather)
    must stay bit-exact vs the untiled op: two masks, a stride that
    divides neither the local rows nor the canvas height, and pad
    rows."""
    mesh = make_mesh(N)
    h, w, step = 179, 230, 7
    hp = -(-h // N) * N
    m1 = np.zeros((hp, w), bool)
    m2 = np.zeros((hp, w), bool)
    m1[:h] = rng.random((h, w)) < 0.01
    m2[:h] = rng.random((h, w)) < 0.008
    max_i = w / 2.0

    def body(a, b):
        outs = tiled._tiled_eight_ray_multi([a, b], step, max_i,
                                            math.sqrt(2.0), AXIS, h)
        return outs[0], outs[1]

    o1, o2 = _shard_call(mesh, body, m1, m2, out_spec=(P(AXIS), P(AXIS)))
    for got, mask in ((o1, m1), (o2, m2)):
        ref = np.asarray(eight_ray_min_distance(jnp.asarray(mask), step,
                                                max_i, math.sqrt(2.0)))[:h]
        g = np.asarray(got)[:h]
        both_inf = np.isinf(g) & np.isinf(ref)
        assert np.where(both_inf, 0.0, np.abs(g - ref)).max() == 0.0


def test_tiled_flow_matches_untiled(rng):
    import dataclasses

    mesh = make_mesh(N)
    # tall enough that the finest levels are genuinely tiled
    # (512 rows -> downscaled 256 -> local tiles of 32 > halo)
    h, w = 512, 96
    photos, _ = pio.synthesize_fisheye_set(h, w, n=2, seed=5, with_top=False)
    l, r = photos
    # fewer relax iterations so the receptive radius fits the test halo
    params = dataclasses.replace(flow_params_by_name("pixflow_low"),
                                 relax_iters_per_phase=3)
    ref = np.asarray(pixflow.compute_optical_flow(
        jnp.asarray(l), jnp.asarray(r), params, "left"))

    tc = tiled.TileConfig(min_tiled_rows=8, level_halo=28)
    out = _shard_call(
        mesh,
        lambda a, b: tiled.tiled_compute_optical_flow(
            a, b, params, "left", AXIS, N, h, tc),
        l, r)
    out = np.asarray(out)
    assert out.shape == ref.shape
    # interior must agree tightly; global edge rows see boundary-fill
    # deviations (documented)
    epe_inner = endpoint_error(out[8:-8], ref[8:-8])
    assert epe_inner < 0.05, epe_inner


def test_tiled_stitch_pair_matches_untiled(rng):
    mesh = make_mesh(N)
    h, w = 128, 160
    photos = pio.synthesize_four_input_set(h, w, seed=11)
    il, ir = (np.asarray(a) for a in pipeline.compose_four(
        jnp.stack([jnp.asarray(p) for p in photos])))

    cfg = StitchConfig()
    ref = np.asarray(pipeline.stitch_pair(jnp.asarray(il), jnp.asarray(ir),
                                          cfg))
    tc = tiled.TileConfig(min_tiled_rows=8, level_halo=32)
    out = np.asarray(tiled.tiled_stitch_pair(jnp.asarray(il),
                                             jnp.asarray(ir), cfg, mesh,
                                             AXIS, tc))
    assert out.shape == ref.shape
    inner = np.s_[8:-8]
    s = ssim(out[inner], ref[inner])
    assert s >= 0.995, s
    # overwhelming majority of interior pixels bit-identical
    frac_same = (out[inner] == ref[inner]).mean()
    assert frac_same > 0.97, frac_same


def test_tiled_stitch_pair_windowed_matches_untiled_windowed():
    """The sharded path with a planned overlap column window (the
    work-saving crop of stitch_pair_auto, ported to the tiled body) must
    match the single-chip windowed program."""
    from panorama_opticalflow_tpu.models import crop

    mesh = make_mesh(N)
    h, w = 128, 640
    photos, top = pio.synthesize_fisheye_set(h, w, n=5, seed=3,
                                             with_top=True)
    cfg = StitchConfig()
    jp = [jnp.asarray(p) for p in photos]
    wins = crop.plan_chain_windows(jp, jnp.asarray(top), cfg)
    assert wins[1][1] < w          # a real window
    assert wins[1][2]              # gather-safe branch exercised

    r0 = pipeline.stitch_pair_auto(jp[0], jnp.asarray(top), cfg,
                                   window=wins[0])
    ref = np.asarray(pipeline.stitch_pair_auto(jp[1], r0, cfg,
                                               window=wins[1]))
    tc = tiled.TileConfig(min_tiled_rows=8, level_halo=32)
    out = np.asarray(tiled.tiled_stitch_pair(jp[1], r0, cfg, mesh, AXIS,
                                             tc, window=wins[1]))
    assert out.shape == ref.shape
    inner = np.s_[8:-8]
    s = ssim(out[inner], ref[inner])
    assert s >= 0.995, s
    frac_same = (out[inner] == ref[inner]).mean()
    assert frac_same > 0.97, frac_same


def test_tiled_stitch_pair_medium_canvas_matches_untiled():
    """>= 1 MP tiled == untiled parity (VERDICT r2 gate: the small-canvas
    gates left medium shapes uncovered).  Uses the _fast preset to keep
    the runtime CI-sized."""
    from panorama_opticalflow_tpu.models import crop

    mesh = make_mesh(N)
    h, w = 896, 1152   # 1.03 MP
    photos, top = pio.synthesize_fisheye_set(h, w, n=5, seed=7,
                                             with_top=True)
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    jl, jr = jnp.asarray(photos[0]), jnp.asarray(top)
    win = crop.pair_window(np.asarray(
        stitcher.match_images(jl, jr)), cfg)
    assert win[1] < w
    ref = np.asarray(pipeline.stitch_pair_auto(jl, jr, cfg, window=win))
    tc = tiled.TileConfig.for_params(cfg.flow_params, min_tiled_rows=16)
    out = np.asarray(tiled.tiled_stitch_pair(jl, jr, cfg, mesh, AXIS, tc,
                                             window=win))
    assert out.shape == ref.shape
    inner = np.s_[16:-16]
    s = ssim(out[inner], ref[inner])
    assert s >= 0.995, s


def test_tiled_stitch_jit_program_is_cached():
    """tiled_stitch_pair must reuse one jitted program across calls
    (regression: an inline jax.jit(shard_map(partial(...))) per call
    retraced the full sharded program on every call)."""
    mesh = make_mesh(N)
    h, w = 64, 160
    photos = pio.synthesize_four_input_set(h, w, seed=2)
    il, ir = pipeline.compose_four(jnp.stack([jnp.asarray(p)
                                              for p in photos]))
    cfg = StitchConfig()
    tc = tiled.TileConfig(min_tiled_rows=8, level_halo=32)
    tiled._tiled_stitch_jit.cache_clear()
    np.asarray(tiled.tiled_stitch_pair(il, ir, cfg, mesh, AXIS, tc))
    np.asarray(tiled.tiled_stitch_pair(il, ir, cfg, mesh, AXIS, tc))
    info = tiled._tiled_stitch_jit.cache_info()
    assert info.misses == 1 and info.hits >= 1, info
    fn = tiled._tiled_stitch_jit(mesh, AXIS, N, h, cfg, tc, None, False)
    assert fn._cache_size() == 1, fn._cache_size()
