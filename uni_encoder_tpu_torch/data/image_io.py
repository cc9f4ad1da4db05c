"""PNG decoding and encoding, and PIL's resizes, on numpy (the evaluation
path's replacement for PIL, which the port does not need for PNG files).

`read_png` gives what `np.asarray(PIL.Image.open(path))` gives for the
PNG files the evaluation reads: 8- and 16-bit greyscale ((H, W) uint8 /
uint16), 8-bit RGB, grey + alpha and RGBA ((H, W, C) uint8) and palette
images at 1, 2, 4 or 8 bits (the (H, W) uint8 indices). Interlaced (Adam7)
files and other depths raise. The scanlines are inflated with `zlib` and
reconstructed by the C++ `native.png_unfilter`. `write_png` writes
filter-type-0 files of the same kinds.

`read_image` is `data/mappers.py::read_image`: RGB uint8, with PIL's
`convert("RGB")` of each kind (palette entries looked up in PLTE, alpha
dropped). JPEG files still go through PIL, imported when one is read or
written (`write_jpeg`; `write_image` picks PNG or JPEG by the extension).

The resizes reproduce PIL's on uint8 (H, W) or (H, W, C) arrays:
`resize_nearest` (`Image.NEAREST`), `resize_bilinear` (`Image.BILINEAR`)
and `resize_lanczos` (`Image.LANCZOS`). PIL resamples horizontally, then
vertically; each pass weighs the taps of a filter whose support is the
filter's (1 bilinear, 3 Lanczos) times max(scale, 1), so a downscale
antialiases; the normalised weights become 22-bit fixed-point integers,
and each pass rounds and clips to uint8. The weights are computed with the
same float64 operations in the same order (with `math.sin`, as PIL's C
calls `sin`), so the results are PIL's. Each pass runs in the C++
`native.resample_pass`.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from ..native import png_unfilter, resample_pass

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths read
_DEPTHS = {0: (8, 16), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


# ------------------------------------------------------------------ decoding
def decode_png(data: bytes) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(samples, palette) of a PNG file's bytes: samples as `read_png`
    returns them, and the PLTE entries as (N, 3) uint8 (None without one)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced (Adam7) PNG files are not supported")
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"PNG colour type {ctype} at bit depth {depth} is not supported")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG file without PLTE")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = png_unfilter(raw, height, stride, max(1, bits // 8))
    if depth == 16:
        arr = rows.view(">u2").astype(np.uint16).reshape(height, width, channels)
    elif depth < 8:
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        arr = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, stride * per_byte)
        arr = arr[:, :width, None]
    else:
        arr = rows.reshape(height, width, channels)
    return (arr[:, :, 0] if channels == 1 else arr), palette


def read_png(path: str) -> np.ndarray:
    """The samples of a PNG file, as `np.asarray(PIL.Image.open(path))`."""
    with open(path, "rb") as f:
        return decode_png(f.read())[0]


def write_png(path: str, arr: np.ndarray) -> None:
    """Write (H, W) uint8 / uint16 greyscale, or (H, W, 2|3|4) uint8 grey +
    alpha / RGB / RGBA, as a PNG with filter type 0 on every row, deflated
    at zlib level 1 (fast: the files are fixtures and test data)."""
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.dtype in (np.uint8, np.uint16):
        ctype, depth = 0, 8 * arr.itemsize
        arr = arr[:, :, None]
    elif arr.ndim == 3 and arr.dtype == np.uint8 and arr.shape[2] in (2, 3, 4):
        ctype, depth = {2: 4, 3: 2, 4: 6}[arr.shape[2]], 8
    else:
        raise ValueError(f"cannot write a {arr.dtype} array of shape {arr.shape} as PNG")
    height, width = arr.shape[:2]
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr).view(np.uint8).reshape(height, -1)
    stream = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(stream.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))


def write_jpeg(path: str, arr: np.ndarray, quality: int = 75) -> None:
    """Write an (H, W, 3) uint8 RGB image as a JPEG through PIL (imported
    here; 75 is PIL's default quality)."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(arr, np.uint8)).save(path, quality=quality)


def write_image(path: str, arr: np.ndarray) -> None:
    """`write_jpeg` for a .jpg / .jpeg path, else `write_png`."""
    (write_jpeg if path.lower().endswith((".jpg", ".jpeg")) else write_png)(path, arr)


def _to_rgb(arr: np.ndarray, palette: Optional[np.ndarray]) -> np.ndarray:
    """PIL's `convert("RGB")` of each kind `decode_png` gives."""
    if arr.dtype == np.uint16:  # PIL's I;16 -> RGB saturates at 255
        arr = np.minimum(arr, 255).astype(np.uint8)
    if palette is not None:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[arr]
    if arr.ndim == 2:
        return np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] == 2:  # grey + alpha
        return np.repeat(arr[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(arr[:, :, :3])


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of an image file, from its header: a PNG file's IHDR,
    or PIL's reading of a JPEG file's markers."""
    if path.lower().endswith((".jpg", ".jpeg")):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"reading {path} needs PIL (Pillow) for JPEG decoding") from e
        with Image.open(path) as im:
            return im.height, im.width
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def read_image(path: str, resize_wh: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """RGB uint8 (H, W, 3); optionally resized to (w, h) by `resize_lanczos`
    (`data/mappers.py::read_image`)."""
    if path.lower().endswith((".jpg", ".jpeg")):
        img = _read_jpeg_rgb(path)
    else:
        with open(path, "rb") as f:
            img = _to_rgb(*decode_png(f.read()))
    if resize_wh is not None:
        img = resize_lanczos(img, (resize_wh[1], resize_wh[0]))
    return img


def _read_jpeg_rgb(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs PIL (Pillow) for JPEG decoding; the port decodes only PNG "
                          "files itself") from e
    with open(path, "rb") as f:
        return np.array(Image.open(f).convert("RGB"))  # a writable copy


# ------------------------------------------------------------------- resizes
_PRECISION_BITS = 22  # PIL's Resample.c: 32 - 8 - 2


def _bilinear_filter(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos_filter(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


_FILTERS = {"bilinear": (_bilinear_filter, 1.0), "lanczos": (_lanczos_filter, 3.0)}


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PIL's precompute_coeffs + normalize_coeffs_8bpc: for each output, the
    first input index of its taps, their count, and their fixed-point
    weights (out_size, ksize), zero past the count."""
    filt, filter_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    count = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:  # in order, as PIL sums them
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        first[xx], count[xx] = xmin, xmax
        weights[xx, :xmax] = k
    scaled = weights * (1 << _PRECISION_BITS)
    fixed = np.trunc(np.where(weights < 0, scaled - 0.5, scaled + 0.5)).astype(np.int32)
    for a in (first, count, fixed):
        a.setflags(write=False)
    return first, count, fixed


def _resample(img: np.ndarray, hw: Tuple[int, int], kind: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected uint8 (H, W) or (H, W, C), got {img.dtype} {img.shape}")
    out_h, out_w = int(hw[0]), int(hw[1])
    if (out_h, out_w) == img.shape[:2]:
        return img.copy()
    shape = img.shape
    h, w = shape[:2]
    c = int(np.prod(shape[2:]))
    x = img.reshape(h, w, c)
    if out_w != w:  # horizontal pass: outer = rows, inner = channels
        x = resample_pass(x, *_coefficients(w, out_w, kind))
    if out_h != h:  # vertical pass: one plane of rows of out_w * c bytes
        x = resample_pass(x.reshape(1, h, out_w * c), *_coefficients(h, out_h, kind))
    return x.reshape((out_h, out_w) + shape[2:])


def resize_bilinear(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """PIL `resize((w, h), Image.BILINEAR)` of a uint8 image."""
    return _resample(img, hw, "bilinear")


def resize_lanczos(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """PIL `resize((w, h), Image.LANCZOS)` of a uint8 image."""
    return _resample(img, hw, "lanczos")


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's ImagingScaleAffine: source coordinate (x + 0.5) * scale,
    accumulated by repeated addition as PIL does, truncated."""
    step = in_size / out_size
    coords = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return np.minimum(coords.astype(np.int64), in_size - 1)


def resize_nearest(arr: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """PIL `resize((w, h), Image.NEAREST)` of an (H, W[, C]) array of any
    integer type (PIL's "L" for uint8, "I" for int32 maps)."""
    arr = np.asarray(arr)
    out_h, out_w = int(hw[0]), int(hw[1])
    if (out_h, out_w) == arr.shape[:2]:
        return arr.copy()
    rows = _nearest_index(arr.shape[0], out_h)
    cols = _nearest_index(arr.shape[1], out_w)
    return arr[rows[:, None], cols[None, :]]
