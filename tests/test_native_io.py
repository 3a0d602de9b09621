"""Native C++ I/O runtime tests (skipped when the library can't build)."""

import numpy as np
import pytest

from panorama_opticalflow_tpu.utils import native_io as nio



@pytest.fixture(autouse=True)
def _native():
    """Build/load the library when a test runs, never at import."""
    if not nio.have_native():
        pytest.skip("libpanoio.so unavailable (native/build.sh failed)")


def test_png_roundtrip(rng):
    img = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    data = nio.png_encode(img)
    assert data[:4] == b"\x89PNG"
    back = nio.png_decode(data)
    np.testing.assert_array_equal(back, img)


def test_png_interop_with_pil(rng, tmp_path):
    from PIL import Image

    img = rng.integers(0, 256, (20, 30, 4), dtype=np.uint8)
    # native encode -> PIL decode
    data = nio.png_encode(img)
    p = tmp_path / "a.png"
    p.write_bytes(data)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    # PIL encode -> native decode
    q = tmp_path / "b.png"
    Image.fromarray(img).save(q)
    np.testing.assert_array_equal(nio.png_decode(q.read_bytes()), img)


def test_fast_read_write(rng, tmp_path):
    img = rng.integers(0, 256, (16, 24, 4), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    nio.write_image_fast(path, img)
    np.testing.assert_array_equal(nio.read_image_rgba_fast(path), img)


def test_prefetch_loader(rng, tmp_path):
    paths = []
    imgs = []
    for i in range(4):
        img = rng.integers(0, 256, (8, 12, 4), dtype=np.uint8)
        p = str(tmp_path / f"{i}.png")
        nio.write_image_fast(p, img)
        paths.append(p)
        imgs.append(img)
    seen = list(nio.PrefetchLoader(paths))
    assert [p for p, _ in seen] == paths
    for (_, got), want in zip(seen, imgs):
        np.testing.assert_array_equal(got, want)


def test_decode_garbage_raises():
    with pytest.raises(Exception):
        nio.png_decode(b"not a png at all")


def test_native_tiff_roundtrip(tmp_path):
    from panorama_opticalflow_tpu.utils import native_io

    if not native_io.have_native():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 53, 4), np.uint8)
    p = str(tmp_path / "x.tif")
    native_io.tiff_encode(p, img)
    back = native_io.tiff_decode(p)
    np.testing.assert_array_equal(back, img)
    # PIL agrees with the native decoder on our own files
    from panorama_opticalflow_tpu.utils.io import read_image_rgba
    np.testing.assert_array_equal(read_image_rgba(p), img)


def test_native_tiff_reads_pil_written_file(tmp_path):
    """Interop: the native decoder must read PIL/OpenCV-style TIFFs (the
    reference's inputs are cv::imwrite TIFFs)."""
    from PIL import Image

    from panorama_opticalflow_tpu.utils import native_io

    if not native_io.have_native():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (21, 33, 4), np.uint8)
    p = str(tmp_path / "pil.tif")
    Image.fromarray(img).save(p)
    np.testing.assert_array_equal(native_io.tiff_decode(p), img)
    np.testing.assert_array_equal(native_io.read_image_rgba_fast(p), img)


def test_native_tiff_rgb_and_gray(tmp_path):
    """3-sample RGB and 1-sample gray TIFFs decode with opaque alpha."""
    from PIL import Image

    from panorama_opticalflow_tpu.utils import native_io

    if not native_io.have_native():
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (19, 27, 3), np.uint8)
    p = str(tmp_path / "rgb.tif")
    Image.fromarray(rgb).save(p)
    out = native_io.tiff_decode(p)
    np.testing.assert_array_equal(out[..., :3], rgb)
    assert (out[..., 3] == 255).all()

    grey = rng.integers(0, 256, (13, 17), np.uint8)
    pg = str(tmp_path / "g.tif")
    Image.fromarray(grey).save(pg)
    outg = native_io.tiff_decode(pg)
    np.testing.assert_array_equal(outg[..., 0], grey)
    np.testing.assert_array_equal(outg[..., 1], grey)
    assert (outg[..., 3] == 255).all()
