"""Native host ops: ctypes bindings over ``hostops.cc`` (counterpart of
``int8inferenceengine_tpu.native``).

The library is compiled at first use with the machine's ``g++`` and the JAX
package's Makefile flags (``HOST_FLAGS``) into
``int8inferenceengine_tpu_torch/_build/libhostops-<source hash>.so`` and
loaded with ``ctypes``.  Nothing is built at import.  A build or load that
fails raises ``RuntimeError`` with the compiler's output: the entry points
never fall back to numpy.

Each entry point has a numpy twin of the same name with ``_plain`` at the
end (``quantize_u8_plain``, ...): the plain version the tests hold the
library against.  ``hostops.cc`` says why these ops are native: they sit on
the host side of the copy to the card, feeding it quantized u8 batches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "hostops.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the JAX package's native/Makefile CXXFLAGS (less -Wall) and its link flag
HOST_FLAGS = ["-O3", "-march=native", "-fopenmp", "-fPIC", "-std=c++17",
              "-shared"]

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()
    return BUILD_DIR / f"libhostops-{digest[:16]}.so"


def _build(so: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native host ops: g++ not found; the library "
                           "is built with the machine's g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native host ops: g++ failed "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, so)          # atomic: concurrent builds race safely


def load() -> ctypes.CDLL:
    """The built library with its argtypes set (built at first use)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            raise RuntimeError(f"native host ops: cannot load {so}: {e}") \
                from e
        i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        sigs = {
            "i8ie_quantize_u8": [f32p, i64, f32, i32, u8p],
            "i8ie_dequantize_u8": [u8p, i64, f32, i32, f32p],
            "i8ie_normalize_nchw": [u8p, i64, i64, i64, i64, f32p, f32p,
                                    f32p],
            "i8ie_resize_bilinear": [u8p, i64, i64, i64, i64, i64, i64, u8p],
            "i8ie_preprocess_quantize": [u8p, i64, i64, i64, i64, f32p, f32p,
                                         f32, i32, u8p],
            "i8ie_s2d_quantized": [u8p, i64, i64, i64, i64, i64, i64, i64,
                                   i32, u8p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _images(img_nhwc_u8) -> np.ndarray:
    img = np.ascontiguousarray(img_nhwc_u8, dtype=np.uint8)
    if img.ndim != 4:
        raise ValueError(f"expected u8 NHWC images, got shape {img.shape}")
    return img


def _channels(v, c: int, what: str) -> np.ndarray:
    v = np.ascontiguousarray(v, dtype=np.float32).reshape(-1)
    if v.shape != (c,):
        raise ValueError(f"{what} has {v.size} values for {c} channels")
    return v


# -- the entry points and their numpy twins -----------------------------------

def quantize_u8(x: np.ndarray, scale: float, zero_point: int) -> np.ndarray:
    """f32 -> u8 asymmetric affine quantization on the host:
    ``trunc(clip(x / scale + zp, 0, 255))``, a true division."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.uint8)
    load().i8ie_quantize_u8(_f32p(x), x.size, scale, zero_point, _u8p(out))
    return out


def quantize_u8_plain(x, scale: float, zero_point: int) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    t = np.clip(x / np.float32(scale) + np.float32(zero_point), 0, 255)
    return t.astype(np.uint8)


def dequantize_u8(q: np.ndarray, scale: float, zero_point: int
                  ) -> np.ndarray:
    """u8 -> f32: ``(q - zp) * scale``."""
    q = np.ascontiguousarray(q, dtype=np.uint8)
    out = np.empty(q.shape, dtype=np.float32)
    load().i8ie_dequantize_u8(_u8p(q), q.size, scale, zero_point, _f32p(out))
    return out


def dequantize_u8_plain(q, scale: float, zero_point: int) -> np.ndarray:
    return ((np.asarray(q, np.uint8).astype(np.float32)
             - np.float32(zero_point)) * np.float32(scale))


def normalize_nchw(img_nhwc_u8: np.ndarray, mean, std) -> np.ndarray:
    """u8 NHWC images -> normalized f32 NCHW (ToTensor + Normalize)."""
    img = _images(img_nhwc_u8)
    n, h, w, c = img.shape
    mean, std = _channels(mean, c, "mean"), _channels(std, c, "std")
    out = np.empty((n, c, h, w), dtype=np.float32)
    load().i8ie_normalize_nchw(_u8p(img), n, h, w, c, _f32p(mean),
                               _f32p(std), _f32p(out))
    return out


def normalize_nchw_plain(img_nhwc_u8, mean, std) -> np.ndarray:
    img = _images(img_nhwc_u8)
    x = img.astype(np.float32) / np.float32(255.0)
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def resize_bilinear(img_nhwc_u8: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize u8 NHWC -> u8 NHWC (half-pixel centers)."""
    img = _images(img_nhwc_u8)
    n, h, w, c = img.shape
    if oh <= 0 or ow <= 0:
        raise ValueError(f"resize to {oh} x {ow}")
    out = np.empty((n, oh, ow, c), dtype=np.uint8)
    load().i8ie_resize_bilinear(_u8p(img), n, h, w, c, oh, ow, _u8p(out))
    return out


def resize_bilinear_plain(img_nhwc_u8, oh: int, ow: int) -> np.ndarray:
    img = _images(img_nhwc_u8)
    _, h, w, _ = img.shape
    ys = np.clip((np.arange(oh) + 0.5) * h / oh - 0.5, 0, h - 1)
    xs = np.clip((np.arange(ow) + 0.5) * w / ow - 0.5, 0, w - 1)
    y0 = ys.astype(np.int64)
    y1 = np.minimum(h - 1, y0 + 1)
    x0 = xs.astype(np.int64)
    x1 = np.minimum(w - 1, x0 + 1)
    wy = (ys - y0).astype(np.float32)[None, :, None, None]
    wx = (xs - x0).astype(np.float32)[None, None, :, None]
    f = img.astype(np.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    return (top * (1 - wy) + bot * wy + 0.5).astype(np.uint8)


def preprocess_quantize(img_nhwc_u8: np.ndarray, mean, std, scale: float,
                        zero_point: int) -> np.ndarray:
    """Fused ingest: u8 NHWC -> normalize -> quantize -> u8 NCHW at
    (scale, zero_point), one pass; a converted model takes the result as
    its quantized input (``data.wrap_quantized``)."""
    img = _images(img_nhwc_u8)
    n, h, w, c = img.shape
    mean, std = _channels(mean, c, "mean"), _channels(std, c, "std")
    out = np.empty((n, c, h, w), dtype=np.uint8)
    load().i8ie_preprocess_quantize(_u8p(img), n, h, w, c, _f32p(mean),
                                    _f32p(std), scale, zero_point, _u8p(out))
    return out


def preprocess_quantize_plain(img_nhwc_u8, mean, std, scale: float,
                              zero_point: int) -> np.ndarray:
    return quantize_u8_plain(normalize_nchw_plain(img_nhwc_u8, mean, std),
                             scale, zero_point)


def _s2d_args(shape, kernel: int, stride: int, padding: int):
    n, c, h, w = shape
    k, s, p = int(kernel), int(stride), int(padding)
    if k < 1 or s < 1 or p < 0 or h + 2 * p < k or w + 2 * p < k:
        raise ValueError(f"s2d: window {k} stride {s} padding {p} over "
                         f"{tuple(shape)}")
    return k, s, p


def s2d_shape(shape, kernel: int, stride: int, padding: int) -> tuple:
    """The [n, hp/s, wp/s, s*s*c] shape ``s2d_quantized`` makes of a u8
    NCHW ``shape``: ``oh + ceil(k/s) - 1`` blocks a spatial dim."""
    k, s, p = _s2d_args(shape, kernel, stride, padding)
    n, c, h, w = shape
    kp = -(-k // s)
    return (n, (h + 2 * p - k) // s + kp, (w + 2 * p - k) // s + kp,
            s * s * c)


def s2d_quantized(q_nchw: np.ndarray, kernel: int, stride: int, padding: int,
                  zero_point: int) -> np.ndarray:
    """First-conv ingest pre-layout: u8 NCHW -> zp-pad + space-to-depth,
    one native pass, giving the [n, hp/s, wp/s, s*s*c] u8 blocks that
    ``ops/conv.s2d_input`` makes of the padded NHWC input."""
    q = np.ascontiguousarray(q_nchw, dtype=np.uint8)
    if q.ndim != 4:
        raise ValueError(f"expected u8 NCHW codes, got shape {q.shape}")
    k, s, p = _s2d_args(q.shape, kernel, stride, padding)
    n, c, h, w = q.shape
    out = np.empty(s2d_shape(q.shape, k, s, p), dtype=np.uint8)
    load().i8ie_s2d_quantized(_u8p(q), n, c, h, w, k, s, p, int(zero_point),
                              _u8p(out))
    return out


def s2d_quantized_plain(q_nchw, kernel: int, stride: int, padding: int,
                        zero_point: int) -> np.ndarray:
    from ..ops.conv import s2d_input
    q = np.asarray(q_nchw, dtype=np.uint8)
    k, s, p = _s2d_args(q.shape, kernel, stride, padding)
    x = np.ascontiguousarray(q.transpose(0, 2, 3, 1))
    if p:
        x = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)),
                   constant_values=np.uint8(zero_point))
    return s2d_input(x, k, k, s, np.uint8(zero_point))
