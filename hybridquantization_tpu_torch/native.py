"""ctypes bindings for the native C++ loader (native/loader.cpp), a copy.

A verbatim copy of `hybridquantization_tpu/native.py` below this
paragraph, over the same `native/libhqloader.so` (`make -C native`), so
that this package imports no jax; its fall-back to `io.py` when the
library is not built is this package's `io.py`. Host image decoding, not a
device path. `tests/test_torch_batch.py` holds it to the original.

The native tier of the framework's runtime: parallel batch image decode
(PNG via zlib + PPM) and layout conversion, feeding the device without a
Python-side decode bottleneck. Falls back to the pure-Python io module when
the shared library hasn't been built (`make -C native`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "native", "libhqloader.so"),
    os.path.join(os.path.dirname(__file__), "libhqloader.so"),
]

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for p in _LIB_PATHS:
        if os.path.exists(p):
            lib = ctypes.CDLL(os.path.abspath(p))
            lib.hq_image_size.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.hq_image_size.restype = ctypes.c_int
            lib.hq_load_image.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.hq_load_image.restype = ctypes.c_int
            lib.hq_load_batch.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.hq_load_batch.restype = ctypes.c_int
            for name in ("hq_hwc_to_planar", "hq_planar_to_hwc"):
                fn = getattr(lib, name)
                fn.argtypes = [
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_longlong,
                ]
                fn.restype = None
            lib.hq_float_to_u8.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_longlong,
            ]
            lib.hq_float_to_u8.restype = None
            _lib = lib
            return lib
    return None


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader not built (make -C native)")
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.hq_image_size(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        raise IOError(f"cannot decode {path}")
    return w.value, h.value


def load_image(path: str) -> np.ndarray:
    """float32 (H, W, 3) in [0, 1]."""
    lib = _load()
    if lib is None:
        from . import io as hio

        return hio.load_image(path)
    w, h = image_size(path)
    out = np.empty((h, w, 3), np.float32)
    if lib.hq_load_image(path.encode(), _fptr(out), w, h):
        raise IOError(f"cannot decode {path}")
    return out


def load_batch(paths: list[str], num_threads: int = 0) -> np.ndarray:
    """Parallel decode of same-size images -> (N, H, W, 3) float32.

    Raises if any image fails to decode or sizes mismatch.
    """
    lib = _load()
    if lib is None:
        from . import io as hio

        return np.stack([hio.load_image(p) for p in paths])
    w, h = image_size(paths[0])
    out = np.empty((len(paths), h, w, 3), np.float32)
    blob = b"".join(p.encode() + b"\0" for p in paths) + b"\0"
    failures = lib.hq_load_batch(
        blob, len(paths), _fptr(out), w, h, num_threads
    )
    if failures:
        raise IOError(f"{failures} of {len(paths)} images failed to decode")
    return out


def hwc_to_planar(img: np.ndarray) -> np.ndarray:
    lib = _load()
    h, w, _ = img.shape
    img = np.ascontiguousarray(img, np.float32)
    if lib is None:
        from . import io as hio

        return hio.hwc_to_planar(img)
    out = np.empty((3, h * w), np.float32)
    lib.hq_hwc_to_planar(_fptr(img), _fptr(out), h * w)
    return out


def planar_to_hwc(planar: np.ndarray, width: int) -> np.ndarray:
    lib = _load()
    planar = np.ascontiguousarray(planar, np.float32)
    n = planar.shape[1]
    if lib is None:
        from . import io as hio

        return hio.planar_to_hwc(planar, width)
    out = np.empty((n, 3), np.float32)
    lib.hq_planar_to_hwc(_fptr(planar), _fptr(out), n)
    return out.reshape(n // width, width, 3)


def float_to_u8(img: np.ndarray) -> np.ndarray:
    """Round-half-up [0,1] float -> u8 (HybridQuantization.java:122 parity)."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    if lib is None:
        return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    out = np.empty(img.shape, np.uint8)
    lib.hq_float_to_u8(
        _fptr(img), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), img.size
    )
    return out
