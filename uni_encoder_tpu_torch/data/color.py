"""OpenCV's 8-bit RGB <-> HSV conversions in numpy (`cv2.COLOR_RGB2HSV` and
`cv2.COLOR_HSV2RGB` on uint8 images), for the train mappers' colour
augmentation, which the JAX package runs through cv2.

8-bit HSV keeps H in [0, 180) (degrees / 2), S and V in [0, 255].

- RGB -> HSV is integer arithmetic: V = max, S = diff * (255 << 12) / V and
  H = (sector offset) * (180 << 12) / (6 * diff), each through a table of
  the rounded quotients and shifted back by 12 bits with rounding
  (OpenCV's RGB2HSV_b);
- HSV -> RGB goes through float32, as OpenCV's HSV2RGB_b does: S and V
  are scaled by 1 / 255, h * (6 / 180) splits into a sector and a
  fraction f, and the four candidates are V, V(1 - S), V(1 - S f) and
  V(1 - S(1 - f)), where 1 - S f is one fused multiply-add (one
  rounding); each channel is its candidate times 255.

OpenCV converts a row in chunks of 32 pixels (its AVX2 build), which take
the sector as h - 6 trunc(h / 6) and truncate the channels, and the last
`width % 32` pixels of the row with scalar code, which takes the sector
by fmod and floor and rounds the channels half to even. This module does
the same along the second-last axis, so any width gives OpenCV's bytes.

The tests hold both against cv2 on every input, in rows of 1024 (every
pixel in a chunk), 16 (every pixel in the tail) and 1000 pixels (both).
"""

from __future__ import annotations

import numpy as np

_HSV_SHIFT = 12
_ROUND = 1 << (_HSV_SHIFT - 1)
_HRANGE = 180


def _tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int32)  # the products below stay under 2^31
    hdiv = np.zeros(256, np.int32)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)  # cvRound: half to even
    hdiv[1:] = np.rint((_HRANGE << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _tables()
# (b, g, r) <- tab[...] per sector, OpenCV's sector_data
_SECTOR_B = np.array([1, 1, 3, 0, 0, 2])
_SECTOR_G = np.array([3, 0, 0, 2, 1, 1])
_SECTOR_R = np.array([0, 2, 1, 1, 3, 0])


def _fnma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """1 - a * b with one rounding, as a fused multiply-add gives it in
    float32: the product of two float32 values is exact in float64."""
    return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)


def _check(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim < 2 or img.shape[-1] != 3:
        raise ValueError(f"expected a uint8 (..., width, 3) array, got {img.dtype} {img.shape}")
    return img


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)` of a uint8 (..., 3) array."""
    rgb = _check(rgb).astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + _ROUND) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + _ROUND) >> _HSV_SHIFT  # arithmetic shift, as C's on a negative int
    h = np.where(h < 0, h + _HRANGE, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _hsv_to_rgb(hsv: np.ndarray, chunked: bool) -> np.ndarray:
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / _HRANGE)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    if chunked:
        pre = np.trunc(h)
        f = h - pre
        sector = pre - np.trunc(pre * np.float32(1.0 / 6.0)) * np.float32(6.0)
    else:  # h >= 0, so the sector lies in [0, 6)
        h = np.fmod(h, np.float32(6.0))
        sector = np.floor(h)
        f = h - sector
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * _fnma(s, f), v * _fnma(s, one - f)])
    sector = sector.astype(np.int64)
    pick = lambda table: np.take_along_axis(tab, table[sector][None], 0)[0]  # noqa: E731
    rgb = np.stack([pick(_SECTOR_R), pick(_SECTOR_G), pick(_SECTOR_B)], axis=-1) * np.float32(255.0)
    return np.clip(np.trunc(rgb) if chunked else np.rint(rgb), 0, 255).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)` of a uint8 (..., width, 3) array."""
    hsv = _check(hsv)
    body = hsv.shape[-2] // 32 * 32
    if body == hsv.shape[-2]:
        return _hsv_to_rgb(hsv, chunked=True)
    return np.concatenate([_hsv_to_rgb(hsv[..., :body, :], chunked=True),
                           _hsv_to_rgb(hsv[..., body:, :], chunked=False)], axis=-2)
