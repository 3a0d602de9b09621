"""ctypes bindings for the native C++ I/O runtime (native/panoio.cpp),
plus a double-buffered threaded loader.

The native path releases the GIL for whole-image PNG encode/decode, so
the prefetch thread overlaps host I/O with device compute -- the runtime
role the reference fills with its C++ util layer (CPU/util.cpp:19-46).
Falls back to PIL transparently when the shared library is missing.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                        "libpanoio.so")
    path = os.path.abspath(path)
    if not os.path.exists(path):
        build = os.path.join(os.path.dirname(path), "build.sh")
        if os.path.exists(build):
            import subprocess

            try:
                subprocess.run(["sh", build], check=True,
                               capture_output=True, timeout=120)
            except Exception:  # noqa: BLE001
                return None
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.panoio_png_decode.restype = ctypes.c_int
    lib.panoio_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.panoio_png_encode.restype = ctypes.c_long
    lib.panoio_png_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_size_t]
    lib.panoio_tiff_decode.restype = ctypes.c_int
    lib.panoio_tiff_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.panoio_tiff_encode.restype = ctypes.c_int
    lib.panoio_tiff_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    _LIB = lib
    return lib


def have_native() -> bool:
    return _load() is not None


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA via the native codec."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native panoio not available")
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.panoio_png_decode(data, len(data), None,
                               ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"png decode failed: {rc}")
    out = np.empty((h.value, w.value, 4), np.uint8)
    rc = lib.panoio_png_decode(data, len(data),
                               out.ctypes.data_as(ctypes.c_void_p),
                               ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"png decode failed: {rc}")
    return out


def png_encode(img: np.ndarray, compress_level: int = 1) -> bytes:
    """(H, W, 4) uint8 RGBA -> PNG bytes via the native codec."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native panoio not available")
    img = np.ascontiguousarray(img)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 4
    cap = img.nbytes + (1 << 16)
    buf = ctypes.create_string_buffer(cap)
    n = lib.panoio_png_encode(img.ctypes.data_as(ctypes.c_void_p),
                              img.shape[0], img.shape[1], compress_level,
                              buf, cap)
    if n < 0:
        cap = -n
        buf = ctypes.create_string_buffer(cap)
        n = lib.panoio_png_encode(img.ctypes.data_as(ctypes.c_void_p),
                                  img.shape[0], img.shape[1], compress_level,
                                  buf, cap)
    if n < 0:
        raise ValueError(f"png encode failed: {n}")
    return buf.raw[:n]


def tiff_decode(path: str) -> np.ndarray:
    """TIFF file -> (H, W, 4) uint8 RGBA via the native libtiff codec."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native panoio not available")
    h = ctypes.c_int()
    w = ctypes.c_int()
    p = path.encode()
    rc = lib.panoio_tiff_decode(p, None, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"tiff decode failed: {rc}")
    out = np.empty((h.value, w.value, 4), np.uint8)
    rc = lib.panoio_tiff_decode(p, out.ctypes.data_as(ctypes.c_void_p),
                                ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"tiff decode failed: {rc}")
    return out


def tiff_encode(path: str, img: np.ndarray) -> None:
    """(H, W, 4) uint8 RGBA -> striped LZW TIFF via the native codec."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native panoio not available")
    img = np.ascontiguousarray(img)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 4
    rc = lib.panoio_tiff_encode(path.encode(),
                                img.ctypes.data_as(ctypes.c_void_p),
                                img.shape[0], img.shape[1])
    if rc != 0:
        raise ValueError(f"tiff encode failed: {rc}")


def _is_tiff(path: str) -> bool:
    return path.lower().endswith((".tif", ".tiff"))


def read_image_rgba_fast(path: str) -> np.ndarray:
    """Native-codec read for PNG and TIFF; PIL for everything else."""
    if have_native():
        if path.lower().endswith(".png"):
            with open(path, "rb") as f:
                return png_decode(f.read())
        if _is_tiff(path) and os.path.exists(path):
            try:
                return tiff_decode(path)
            except ValueError:
                pass  # exotic TIFF flavour: fall back to PIL
    from panorama_opticalflow_tpu.utils.io import read_image_rgba

    return read_image_rgba(path)


def write_image_fast(path: str, img: np.ndarray,
                     compress_level: int = 1) -> None:
    if have_native() and img.ndim == 3 and img.shape[2] == 4:
        if path.lower().endswith(".png"):
            data = png_encode(np.asarray(img, np.uint8), compress_level)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)
            return
        if _is_tiff(path):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tiff_encode(path, np.asarray(img, np.uint8))
            return
    from panorama_opticalflow_tpu.utils.io import write_image

    write_image(path, img)


class PrefetchLoader:
    """Background-thread image loader: decode the next inputs on the
    host while the device stitches the current ones."""

    def __init__(self, paths: list[str], depth: int = 2):
        self._paths = paths
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for p in self._paths:
            try:
                self._q.put((p, read_image_rgba_fast(p)))
            except Exception as e:  # noqa: BLE001
                self._q.put((p, e))
        self._q.put((None, None))

    def __iter__(self):
        while True:
            p, img = self._q.get()
            if p is None:
                return
            if isinstance(img, Exception):
                raise img
            yield p, img
