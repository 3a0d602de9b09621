"""End-to-end pipeline tests: novel-view combiner exactness vs oracle,
full 4-input and 6-input stitches on synthetic data, and SSIM agreement
with the all-oracle reference pipeline."""

import numpy as np
import jax.numpy as jnp

from panorama_opticalflow_tpu.models import novel_view, pipeline, stitcher
from panorama_opticalflow_tpu.utils import io as pio
from panorama_opticalflow_tpu.utils.config import StitchConfig
from panorama_opticalflow_tpu.utils.metrics import ssim

import oracle
import oracle_pixflow as opf


def test_combine_novel_views_matches_oracle(rng):
    h, w = 24, 36
    il = rng.integers(0, 256, (h, w, 4), np.uint8)
    ir = rng.integers(0, 256, (h, w, 4), np.uint8)
    # some transparent pixels on both sides
    il[..., 3] = np.where(rng.random((h, w)) < 0.2, 0, 255)
    ir[..., 3] = np.where(rng.random((h, w)) < 0.2, 0, 255)
    flr = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    frl = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    blend = rng.random((h, w)).astype(np.float32)

    ours = np.asarray(novel_view.combine_novel_views(
        jnp.asarray(il), jnp.asarray(ir), jnp.asarray(flr), jnp.asarray(frl),
        jnp.asarray(blend)))
    ref = opf.combine_novel_views(il, ir, flr, frl, blend)
    # rgb may differ by 1 from rounding-order differences; alpha exact
    np.testing.assert_array_equal(ours[..., 3], ref[..., 3])
    diff = np.abs(ours[..., :3].astype(int) - ref[..., :3].astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01


def test_stitch_four_end_to_end(rng):
    photos = pio.synthesize_four_input_set(64, 160, seed=3)
    cfg = StitchConfig()
    out = np.asarray(pipeline.stitch_four([jnp.asarray(p) for p in photos], cfg))
    assert out.shape == (64, 160, 4)
    # panorama should be opaque nearly everywhere (footprints cover canvas)
    assert (out[..., 3] > 0).mean() > 0.99
    # and should not be black where opaque
    assert out[..., :3][out[..., 3] > 0].mean() > 30


def test_stitch_six_end_to_end(rng):
    photos, top = pio.synthesize_fisheye_set(48, 120, n=5, seed=4)
    cfg = StitchConfig()
    parts = []
    out = pipeline.stitch_six([jnp.asarray(p) for p in photos],
                              jnp.asarray(top), cfg,
                              on_part=lambda i, r: parts.append(i))
    out = np.asarray(out)
    assert parts == [1, 2, 3, 4, 5]
    assert out.shape == (48, 120, 4)
    assert (out[..., 3] > 0).mean() > 0.99


def test_stitch_pair_matches_full_oracle_pipeline(rng):
    """SSIM gate: our jit pipeline vs the all-sequential oracle pipeline
    on one synthetic pair (BASELINE.md: SSIM >= 0.98)."""
    photos = pio.synthesize_four_input_set(56, 144, seed=7)
    cfg = StitchConfig()
    l_np = np.asarray(pipeline.precrop_columns(jnp.asarray(photos[0])))
    r_np = np.asarray(pipeline.precrop_columns(jnp.asarray(photos[1])))
    from panorama_opticalflow_tpu.ops.image import saturating_add_u8
    l3 = np.asarray(pipeline.precrop_columns(jnp.asarray(photos[2])))
    r4 = np.asarray(pipeline.precrop_columns(jnp.asarray(photos[3])))
    image_l = np.asarray(saturating_add_u8(jnp.asarray(l_np), jnp.asarray(l3)))
    image_r = np.asarray(saturating_add_u8(jnp.asarray(r_np), jnp.asarray(r4)))

    ours = np.asarray(pipeline.stitch_pair(jnp.asarray(image_l),
                                           jnp.asarray(image_r), cfg))

    # oracle pipeline
    m = np.asarray(stitcher.match_images(jnp.asarray(image_l),
                                         jnp.asarray(image_r)))
    mask = (m > 140).astype(np.uint8)[..., None]
    ol, orr = image_l * mask, image_r * mask
    blend, _ = oracle.countblend_field(m)
    blend = blend.astype(np.float32)  # smoothing kernels < 2 at this size
    length = image_l.shape[1] // 20
    ext = lambda a: np.concatenate([a[:, -length:], a, a[:, :length]], axis=1)
    flr = opf.compute_optical_flow(ext(ol), ext(orr), opf.P(0), "left")
    frl = opf.compute_optical_flow(ext(orr), ext(ol), opf.P(0), "right")
    flr = flr[:, length:-length]
    frl = frl[:, length:-length]
    merged = opf.combine_novel_views(ol, orr, flr, frl, blend)
    ref = oracle.gather_loop(m, image_l, image_r, merged)

    s = ssim(ours, ref)
    assert s >= 0.98, s


def test_tiled_sampler_exact_on_constant_flow(rng):
    """sample_nearest_wrap_tiled must be BIT-EXACT vs the gather sampler
    for constant flows (residuals vanish after the per-tile mean),
    including samples that wrap across the x seam."""
    from panorama_opticalflow_tpu.ops.warp import (sample_nearest_wrap,
                                                   sample_nearest_wrap_tiled)

    # both tile-multiple and partial-edge-tile shapes: the second shape
    # (400x900: 400 % 64 != 0, 900 % 128 != 0) regression-guards the
    # per-tile mean-offset skew from zero-padded partial tiles
    for h, w in ((192, 384), (400, 900)):
        img = rng.integers(0, 256, (h, w, 4), np.uint8)
        for fx, fy in ((7.3, -2.6), (-5.9, 4.1), (200.0, 0.0), (-200.0, 3.0)):
            flow = np.broadcast_to(np.array([fx, fy], np.float32), (h, w, 2))
            exact = np.asarray(sample_nearest_wrap(
                jnp.asarray(img), jnp.asarray(flow), 1.0))
            tiled = np.asarray(sample_nearest_wrap_tiled(
                jnp.asarray(img), jnp.asarray(flow), 1.0, max_off=256))
            np.testing.assert_array_equal(
                tiled, exact, err_msg=f"{h}x{w} {fx},{fy}")


def test_tiled_sampler_close_to_exact_on_smooth_flow(rng):
    """On smooth (median/blur-class) flows with a per-pixel blend factor
    -- what combine_novel_views actually samples with -- the tiled
    sampler must agree with the exact gather except at rare
    residual-clamp pixels."""
    import cv2

    from panorama_opticalflow_tpu.ops.warp import (sample_nearest_wrap,
                                                   sample_nearest_wrap_tiled)

    h, w = 256, 512
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    flow = cv2.GaussianBlur(
        rng.normal(0, 12, (h, w, 2)).astype(np.float32), (0, 0), 24)
    t = np.tile(np.linspace(0, 1, w, dtype=np.float32), (h, 1))
    exact = np.asarray(sample_nearest_wrap(
        jnp.asarray(img), jnp.asarray(flow), jnp.asarray(t)))
    tiled = np.asarray(sample_nearest_wrap_tiled(
        jnp.asarray(img), jnp.asarray(flow), jnp.asarray(t)))
    mismatch = (tiled != exact).any(axis=-1).mean()
    assert mismatch < 0.02, mismatch


def test_combine_large_canvas_uses_tiled_sampler_consistently(rng):
    """combine_novel_views at production sizes (tiled sampler) must stay
    close to the small-canvas exact path on identical inputs."""
    import cv2

    from panorama_opticalflow_tpu.models.novel_view import (
        TILED_SAMPLER_MIN_H, TILED_SAMPLER_MIN_W)

    h, w = TILED_SAMPLER_MIN_H, TILED_SAMPLER_MIN_W
    il = rng.integers(0, 256, (h, w, 4), np.uint8)
    ir = rng.integers(0, 256, (h, w, 4), np.uint8)
    il[..., 3] = 255
    ir[..., 3] = 255
    flr = cv2.GaussianBlur(
        rng.normal(0, 6, (h, w, 2)).astype(np.float32), (0, 0), 16)
    frl = cv2.GaussianBlur(
        rng.normal(0, 6, (h, w, 2)).astype(np.float32), (0, 0), 16)
    blend = np.tile(np.linspace(0, 1, w, dtype=np.float32), (h, 1))

    ours = np.asarray(novel_view.combine_novel_views(
        jnp.asarray(il), jnp.asarray(ir), jnp.asarray(flr),
        jnp.asarray(frl), jnp.asarray(blend)))
    ref = opf.combine_novel_views(il, ir, flr, frl, blend)
    np.testing.assert_array_equal(ours.shape, ref.shape)
    mismatch = (np.abs(ours[..., :3].astype(int)
                       - ref[..., :3].astype(int)) > 1).any(axis=-1).mean()
    assert mismatch < 0.02, mismatch


def test_chain_traces_each_program_once():
    """A numpy-input 6-photo chain must trace each windowed program
    exactly once (regression: mismatched committed/uncommitted input
    placements gave _geometry_jit and _finish_windowed_jit a second
    trace -- and a second executable -- per chain)."""
    from panorama_opticalflow_tpu.utils import io as pio

    h, w = 96, 320
    photos, top = pio.synthesize_fisheye_set(h, w, n=5, seed=3,
                                             with_top=True)
    cfg = StitchConfig()
    before = {f: getattr(pipeline, f)._cache_size()
              for f in ("_geometry_jit", "_blend_window_jit",
                        "_flows_window_jit", "_finish_windowed_jit")}
    out = pipeline.stitch_six([np.asarray(p) for p in photos],
                              np.asarray(top), cfg)
    np.asarray(out)
    for f, n0 in before.items():
        n1 = getattr(pipeline, f)._cache_size()
        assert n1 - n0 <= 1, (f, n0, n1)


def test_fused_chain_matches_per_pair_path():
    """stitch_six's one-dispatch scanned chain (all pairs share a window
    bucket) must be bit-identical to the per-pair program path."""
    from panorama_opticalflow_tpu.models import crop

    h, w = 128, 640
    photos, top = pio.synthesize_fisheye_set(h, w, n=5, seed=3,
                                             with_top=True)
    cfg = StitchConfig(flow_alg="pixflow_low_fast")
    jp = [jnp.asarray(p) for p in photos]
    wins = crop.plan_chain_windows(jp, jnp.asarray(top), cfg)
    assert len({wd for _, wd, _ in wins}) == 1 and wins[0][1] < w

    parts = []
    ref = np.asarray(pipeline.stitch_six(
        jp, jnp.asarray(top), cfg, on_part=lambda i, r: parts.append(i)))
    out = np.asarray(pipeline.stitch_six(jp, jnp.asarray(top), cfg))
    assert parts == [1, 2, 3, 4, 5]
    np.testing.assert_array_equal(out, ref)
