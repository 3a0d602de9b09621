"""Unit tests for core image ops against the OpenCV oracle.

The reference pipeline is built on these OpenCV primitives; matching them
closely is what makes the end-to-end SSIM gate achievable."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from panorama_opticalflow_tpu.ops import image as im


def _rand_img(rng, h, w, c=None, dtype=np.float32):
    shape = (h, w) if c is None else (h, w, c)
    if dtype == np.uint8:
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


@pytest.mark.parametrize("method,cv_flag", [("linear", cv2.INTER_LINEAR),
                                            ("cubic", cv2.INTER_CUBIC)])
@pytest.mark.parametrize("inshape,outshape", [((40, 56), (20, 28)),
                                              ((31, 47), (28, 42)),
                                              ((24, 24), (27, 27))])
def test_resize_float_matches_opencv(rng, method, cv_flag, inshape, outshape):
    img = _rand_img(rng, *inshape)
    ours = np.asarray(im.resize(img, outshape, method))
    ref = cv2.resize(img, (outshape[1], outshape[0]), interpolation=cv_flag)
    # OpenCV float path uses fixed-point-free float weights: near-exact.
    np.testing.assert_allclose(ours, ref, atol=2e-3)


def test_resize_u8_close_to_opencv(rng):
    img = _rand_img(rng, 40, 60, 4, np.uint8)
    ours = np.asarray(im.resize_u8(img, (20, 30), "cubic")).astype(np.int32)
    ref = cv2.resize(img, (30, 20), interpolation=cv2.INTER_CUBIC).astype(np.int32)
    # OpenCV's uint8 path uses fixed-point weights; allow off-by-one.
    assert np.abs(ours - ref).max() <= 1


@pytest.mark.parametrize("ksize,sigma", [(5, 0.25), (3, 0.5), (3, 1.0), (15, 8.0)])
def test_gaussian_blur_matches_opencv(rng, ksize, sigma):
    img = _rand_img(rng, 37, 45)
    ours = np.asarray(im.gaussian_blur(img, ksize, sigma))
    ref = cv2.GaussianBlur(img, (ksize, ksize), sigma)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_gaussian_blur_2ch(rng):
    flow = _rand_img(rng, 20, 30, 2)
    ours = np.asarray(im.gaussian_blur(flow, 15, 8.0))
    ref = cv2.GaussianBlur(flow, (15, 15), 8.0)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_sobel_matches_opencv(rng):
    img = _rand_img(rng, 33, 41)
    ours_x = np.asarray(im.sobel_x(img))
    ours_y = np.asarray(im.sobel_y(img))
    ref_x = cv2.Sobel(img, -1, 1, 0, ksize=1, borderType=cv2.BORDER_REPLICATE)
    ref_y = cv2.Sobel(img, -1, 0, 1, ksize=1, borderType=cv2.BORDER_REPLICATE)
    np.testing.assert_allclose(ours_x, ref_x, atol=1e-6)
    np.testing.assert_allclose(ours_y, ref_y, atol=1e-6)


def test_median5_matches_opencv(rng):
    flow = _rand_img(rng, 26, 34, 2)
    ours = np.asarray(im.median5(flow))
    ref = cv2.medianBlur(flow, 5)
    np.testing.assert_allclose(ours, ref, atol=0)


@pytest.mark.parametrize("shape", [(26, 34), (3, 40, 52), (7, 5), (1, 9)])
def test_median5_network_equals_sort(rng, shape):
    """The sorting-network median gives exactly rank 12 of the sorted
    25 window shifts: 2-D and 3-D (channel) inputs, odd and
    smaller-than-window shapes."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    if x.ndim == 3:
        x = jnp.moveaxis(x, 0, 2)
    stack = jnp.stack(im._median5_shifts(x), axis=0)
    np.testing.assert_array_equal(np.asarray(im.median5(x)),
                                  np.asarray(jnp.sort(stack, axis=0)[12]))


def test_box_blur_matches_opencv(rng):
    img = _rand_img(rng, 48, 52)
    for k in (3, 10):
        ours = np.asarray(im.box_blur(img, k, k))
        ref = cv2.blur(img, (k, k))
        np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_rgba_to_gray_bit_exact(rng):
    img = _rand_img(rng, 25, 31, 4, np.uint8)
    ours = np.asarray(im.rgba_to_gray_u8(img))
    # cv2 oracle works on BGRA; build the BGRA view of our RGBA array.
    bgra = img[..., [2, 1, 0, 3]].copy()
    ref = cv2.cvtColor(bgra, cv2.COLOR_BGRA2GRAY)
    np.testing.assert_array_equal(ours, ref)


def test_threshold_and_saturating_add(rng):
    img = _rand_img(rng, 10, 12, None, np.uint8)
    ours = np.asarray(im.threshold_binary(img, 140, 1))
    _, ref = cv2.threshold(img, 140, 1, cv2.THRESH_BINARY)
    np.testing.assert_array_equal(ours, ref)

    a = _rand_img(rng, 8, 8, 4, np.uint8)
    b = _rand_img(rng, 8, 8, 4, np.uint8)
    ours = np.asarray(im.saturating_add_u8(a, b))
    ref = cv2.add(a, b)
    np.testing.assert_array_equal(ours, ref)


def test_wrap_extend_crop_roundtrip(rng):
    img = _rand_img(rng, 6, 20, 4, np.uint8)
    ext = np.asarray(im.wrap_extend_x(img, 5))
    assert ext.shape == (6, 30, 4)
    np.testing.assert_array_equal(ext[:, :5], img[:, -5:])
    np.testing.assert_array_equal(ext[:, -5:], img[:, :5])
    np.testing.assert_array_equal(np.asarray(im.crop_x(ext, 5)), img)
