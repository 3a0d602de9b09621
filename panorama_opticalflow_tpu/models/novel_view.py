"""Asymmetric bidirectional novel-view synthesis with softmax deghosting.

Re-design of NovelViewGeneratorAsymmetricFlow + NovelViewUtil
(CPU/OpticalFlow.cpp:9-145).  The generator wrap-extends both overlap
images by cols/20 (the 360-degree periodic halo), computes bidirectional
flow with direction hints, crops the halo off the flows, then synthesises
the merged middle: each image is sampled through the *opposite* direction
flow scaled by the *other* side's blend weight, and the two samples are
combined with a ghost-aware softmax.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from panorama_opticalflow_tpu.ops import image as im
from panorama_opticalflow_tpu.ops.warp import (sample_nearest_wrap,
                                               sample_nearest_wrap_tiled)
from panorama_opticalflow_tpu.models.pixflow import compute_optical_flow_pair
from panorama_opticalflow_tpu.utils.config import StitchConfig

# Deghost constants (CPU/OpticalFlow.cpp:57-59)
K_COLOR_DIFF_COEF = 10.0
K_SOFTMAX_SHARPNESS = 10.0
K_FLOW_MAG_COEF = 100.0

# Canvases at least this large take the gather-free tiled sampler
# (whether the exact gather is faster on the GPU is not measured yet);
# smaller canvases -- including the per-pixel oracle test shapes --
# keep the exact gather.
# The tiled sampler's residual-clamp deviations are gated by
# tests/test_pipeline.py::test_combine_tiled_sampler_close_to_exact and
# the default reference-binary golden (900x400 exercises this path).
TILED_SAMPLER_MIN_H = 256
TILED_SAMPLER_MIN_W = 512


class NovelViewFlows(NamedTuple):
    flow_l_to_r: jax.Array  # (H, W, 2) float32
    flow_r_to_l: jax.Array


def prepare_flows(
    image_l: jax.Array, image_r: jax.Array, cfg: StitchConfig
) -> NovelViewFlows:
    """Bidirectional flow on the wrap-extended overlap images
    (CPU/OpticalFlow.cpp:102-145)."""
    w = image_l.shape[1]
    length = w // cfg.flow_extend_div
    ext_l = im.wrap_extend_x(image_l, length)
    ext_r = im.wrap_extend_x(image_r, length)
    params = cfg.flow_params
    flow_lr, flow_rl = compute_optical_flow_pair(ext_l, ext_r, params,
                                                 "left", "right")
    return NovelViewFlows(im.crop_x(flow_lr, length), im.crop_x(flow_rl, length))


def combine_novel_views(
    image_l: jax.Array,
    image_r: jax.Array,
    flow_l_to_r: jax.Array,
    flow_r_to_l: jax.Array,
    blend: jax.Array,
) -> jax.Array:
    """combineNovelViews (CPU/OpticalFlow.cpp:30-92).

    blendR = blend, blendL = 1 - blendR; colorL samples imageL through
    flowRtoL scaled by blendR, colorR samples imageR through flowLtoR
    scaled by blendL (the asymmetric bidirectional warp,
    CPU/OpticalFlow.cpp:45-46).  Transparent where either sample has zero
    alpha; otherwise a ghost-gated softmax mix.
    """
    h, w = image_l.shape[:2]
    blend_r = blend
    blend_l = 1.0 - blend_r

    # Numeric bounds of the tiled sampler at this call site: per-tile
    # source offsets are representable up to max_off+margin = 104 px and
    # intra-tile deviation from the tile mean up to +-8 px.  The flows
    # sampled here are 2x-upscaled from the half-res solve, then
    # median-filtered, diffused and blurred (models/pixflow.py), and
    # scaled by t = blend in [0, 1] -- so offsets stay far inside the
    # clamp except at rare disocclusion edges in extreme-parallax
    # scenes, where the sampler degrades to the nearest representable
    # offset (gated by the smooth-flow mismatch test and the
    # reference-binary golden).  Raise max_off/margin here if a rig with
    # larger parallax ever needs it.
    sampler = (sample_nearest_wrap_tiled
               if h >= TILED_SAMPLER_MIN_H and w >= TILED_SAMPLER_MIN_W
               else sample_nearest_wrap)
    color_l = sampler(image_l, flow_r_to_l, blend_r).astype(jnp.float32)
    color_r = sampler(image_r, flow_l_to_r, blend_l).astype(jnp.float32)

    mag_lr = jnp.sqrt(flow_l_to_r[..., 0] ** 2 + flow_l_to_r[..., 1] ** 2) / w
    mag_rl = jnp.sqrt(flow_r_to_l[..., 0] ** 2 + flow_r_to_l[..., 1] ** 2) / w

    color_diff = (jnp.abs(color_l[..., 0] - color_r[..., 0])
                  + jnp.abs(color_l[..., 1] - color_r[..., 1])
                  + jnp.abs(color_l[..., 2] - color_r[..., 2])) / 255.0
    deghost = jnp.tanh(color_diff * K_COLOR_DIFF_COEF)

    alpha_l = color_l[..., 3] / 255.0
    alpha_r = color_r[..., 3] / 255.0

    # numerically-stable softmax; the reference's raw double exps
    # (CPU/OpticalFlow.cpp:73-80) overflow for large flow magnitudes.
    a_l = K_SOFTMAX_SHARPNESS * blend_l * alpha_l * (1.0 + K_FLOW_MAG_COEF * mag_rl)
    a_r = K_SOFTMAX_SHARPNESS * blend_r * alpha_r * (1.0 + K_FLOW_MAG_COEF * mag_lr)
    m = jnp.maximum(a_l, a_r)
    exp_l = jnp.exp(a_l - m)
    exp_r = jnp.exp(a_r - m)
    sum_exp = exp_l + exp_r + 1e-5 * jnp.exp(-m)
    softmax_l = exp_l / sum_exp
    softmax_r = exp_r / sum_exp

    def lerp(a, b, t):
        return a + t * (b - a)

    w_l = lerp(blend_l, softmax_l, deghost)[..., None]
    w_r = lerp(blend_r, softmax_r, deghost)[..., None]
    rgb = color_l[..., :3] * w_l + color_r[..., :3] * w_r
    rgb_u8 = jnp.clip(jnp.rint(rgb), 0, 255).astype(jnp.uint8)

    out = jnp.concatenate(
        [rgb_u8, jnp.full(rgb_u8.shape[:2] + (1,), 255, jnp.uint8)], axis=-1)
    transparent = (color_l[..., 3] == 0) | (color_r[..., 3] == 0)
    return jnp.where(transparent[..., None], jnp.zeros((4,), jnp.uint8), out)
