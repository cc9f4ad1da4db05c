"""Host helpers of the evaluation and training data paths (the port's
counterpart of `uni_encoder_tpu/native/__init__.py`).

Three are C++, in one library built from `csrc/*.cpp`:

- `png_unfilter` (`csrc/png.cpp`): the PNG Average and Paeth filters make
  each byte depend on the reconstructed byte to its left and the row
  above, which numpy cannot vectorise (a Python loop over the 6 M bytes of
  a 1024x2048 RGB image);
- `resample_pass` (`csrc/resample.cpp`): one pass of PIL's fixed-point
  resampling, whose tap-by-tap numpy form builds an int64 copy of the image
  for every tap;
- `resize_bilinear_u8` (`csrc/resize.cpp`): the segmentation train
  mapper's bilinear resize with torch's coordinate rule, the same
  arithmetic as the JAX package's `uniio.cpp`, so the same bytes.

The library is compiled with `g++ -O3 -pthread` (no `-ffast-math`, no
`-march`: either could change the float bytes) into `build/native/` at the
repository root the first time it is needed (or when a source is newer
than it) and loaded with ctypes. A failed build raises; there is no slower
path behind it (the JAX package falls back to PIL's BILINEAR, which gives
other bytes). `png_unfilter_plain` and `resample_pass_plain` are the same
functions in numpy and Python loops, which the tests hold the C++ ones
against.

`decode_panoptic_ids` and `accumulate_confusion` are vectorised numpy.
Nothing here builds or loads anything when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build", "native"
)
SOURCES = tuple(os.path.join(CSRC, f) for f in ("png.cpp", "resample.cpp", "resize.cpp"))
_LIB_PATH = os.path.join(BUILD_DIR, "libimage_io.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", *SOURCES, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the host helpers {SOURCES} cannot be built") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCES} failed (g++ exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, _LIB_PATH)  # atomic: another process's build is never seen half-written


def get_lib() -> ctypes.CDLL:
    """The loaded host helpers, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < max(map(os.path.getmtime, SOURCES)):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
            i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
            lib.png_unfilter.argtypes = [u8p, i64, i64, i64, u8p]
            lib.png_unfilter.restype = i64
            lib.resample_pass_u8.argtypes = [u8p, i64, i64, i64, i64p, i64p, i32p, i64, i64, u8p]
            lib.resample_pass_u8.restype = None
            lib.resize_bilinear_u8.argtypes = [u8p, i64, i64, i64, u8p, i64, i64]
            lib.resize_bilinear_u8.restype = None
            _lib = lib
        return _lib


def _check_stream(data: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    if not 1 <= bpp <= 8 or height < 0 or stride < 0:
        raise ValueError(f"bad PNG row layout: height {height}, stride {stride}, bpp {bpp}")
    if data.size < height * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, {height} rows of {stride + 1} need "
                         f"{height * (stride + 1)}")
    return data


def png_unfilter(data: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstruct `height` filtered scanlines of `stride` bytes (each after
    its filter-type byte) from the inflated stream `data`; `bpp` is bytes
    per complete pixel, at least 1. Returns (height, stride) uint8."""
    data = _check_stream(data, height, stride, bpp)
    out = np.empty((height, stride), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bad = get_lib().png_unfilter(data.ctypes.data_as(u8p), height, stride, bpp, out.ctypes.data_as(u8p))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {data[(bad - 1) * (stride + 1)]}, not 0..4")
    return out


def png_unfilter_plain(data: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """`png_unfilter` written plainly from the PNG specification (9.2-9.4),
    byte by byte; for the tests."""
    data = _check_stream(data, height, stride, bpp)
    out = np.zeros((height, stride), np.int64)
    for y in range(height):
        filt = int(data[y * (stride + 1)])
        src = data[y * (stride + 1) + 1:(y + 1) * (stride + 1)].astype(np.int64)
        if filt not in (0, 1, 2, 3, 4):
            raise ValueError(f"PNG row {y} has filter type {filt}, not 0..4")
        for i in range(stride):
            a = int(out[y, i - bpp]) if i >= bpp else 0
            b = int(out[y - 1, i]) if y > 0 else 0
            c = int(out[y - 1, i - bpp]) if y > 0 and i >= bpp else 0
            if filt == 0:
                pred = 0
            elif filt == 1:
                pred = a
            elif filt == 2:
                pred = b
            elif filt == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, i] = (src[i] + pred) % 256
    return out.astype(np.uint8)


def _check_resample(src: np.ndarray, first: np.ndarray, count: np.ndarray, weights: np.ndarray):
    src = np.ascontiguousarray(src, np.uint8)
    first = np.ascontiguousarray(first, np.int64)
    count = np.ascontiguousarray(count, np.int64)
    weights = np.ascontiguousarray(weights, np.int32)
    if src.ndim != 3 or weights.ndim != 2 or not first.shape == count.shape == weights.shape[:1]:
        raise ValueError(f"bad resample pass: src {src.shape}, first {first.shape}, count {count.shape}, "
                         f"weights {weights.shape}")
    if (count < 0).any() or (count > weights.shape[1]).any() or (first < 0).any() \
            or (first + count > src.shape[1]).any():
        raise ValueError("resample taps outside the source")
    return src, first, count, weights


def resample_pass(src: np.ndarray, first: np.ndarray, count: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One of PIL's 8-bit resampling passes along axis 1 of an (outer,
    in_size, inner) uint8 array: output j weighs source rows first[j] ..
    first[j] + count[j] - 1 by the 22-bit fixed-point `weights[j]`.
    Returns (outer, len(first), inner) uint8."""
    src, first, count, weights = _check_resample(src, first, count, weights)
    outer, in_size, inner = src.shape
    out = np.empty((outer, first.shape[0], inner), np.uint8)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))  # noqa: E731
    get_lib().resample_pass_u8(ptr(src, ctypes.c_uint8), outer, in_size, inner, ptr(first, ctypes.c_int64),
                               ptr(count, ctypes.c_int64), ptr(weights, ctypes.c_int32), weights.shape[1],
                               first.shape[0], ptr(out, ctypes.c_uint8))
    return out


def resample_pass_plain(src: np.ndarray, first: np.ndarray, count: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """`resample_pass` in numpy, tap by tap; for the tests."""
    src, first, count, weights = _check_resample(src, first, count, weights)
    acc = np.full((src.shape[0], first.shape[0], src.shape[2]), 1 << 21, np.int64)
    for k in range(weights.shape[1]):
        w = np.where(k < count, weights[:, k], 0).astype(np.int64)
        idx = np.minimum(first + k, src.shape[1] - 1)
        acc += src[:, idx].astype(np.int64) * w[None, :, None]
    return np.clip(acc >> 22, 0, 255).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W, C) image to (oh, ow, C) with
    torch's coordinate rule, half-pixel centres (`csrc/resize.cpp`): the JAX
    package's `native.resize_bilinear_u8` with align_corners false, byte for
    byte."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or oh < 1 or ow < 1:
        raise ValueError(f"expected a uint8 (H, W, C) image and a positive size, got {img.shape} -> ({oh}, {ow})")
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    get_lib().resize_bilinear_u8(img.ctypes.data_as(u8p), h, w, c, out.ctypes.data_as(u8p), oh, ow)
    return out


def decode_panoptic_ids(rgb: np.ndarray) -> np.ndarray:
    """panopticapi's id = R + 256 G + 65536 B of an (H, W, 3) uint8 PNG, as
    (H, W) int32."""
    r = np.asarray(rgb, np.uint8).astype(np.int32)
    return r[..., 0] + 256 * r[..., 1] + 65536 * r[..., 2]


def accumulate_confusion(gt: np.ndarray, pred: np.ndarray, num_classes: int, ignore_label: int,
                         mat: np.ndarray) -> None:
    """Add the (gt, pred) pixel counts of uint8 label maps into the
    (num_classes, num_classes) int64 `mat`: pixels whose gt is the ignore
    label or not a class are skipped, and predictions above the last class
    count as the last class (as `uniio.cpp`'s accumulate_confusion)."""
    g = np.asarray(gt, np.uint8).reshape(-1).astype(np.int64)
    p = np.asarray(pred, np.uint8).reshape(-1).astype(np.int64)
    valid = (g != ignore_label) & (g < num_classes)
    idx = g[valid] * num_classes + np.minimum(p[valid], num_classes - 1)
    mat += np.bincount(idx, minlength=num_classes ** 2).reshape(num_classes, num_classes)
