"""The port's PNG decoding and resizes (`uni_encoder_tpu_torch/data/image_io.py`,
`uni_encoder_tpu_torch/native/`) against PIL, which the JAX package reads
images with.

- `read_png` equals `np.asarray(Image.open(path))` exactly: on files PIL
  writes (L, I;16, RGB, RGBA, LA, P at 1, 2, 4 and 8 bits), and on files
  hand-encoded through each PNG filter type 0-4;
- the C++ `png_unfilter` and `resample_pass` equal their plain numpy
  versions exactly;
- `resize_nearest`, `resize_bilinear` and `resize_lanczos` equal PIL's
  NEAREST, BILINEAR and LANCZOS exactly at up- and down-scales (every value
  equal, where a tolerance of one uint8 level on 1% of values would be
  allowed for a non-fixed-point resize);
- JPEG files need PIL and say so when it is missing.
"""

import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_port_eval_common as ecommon
from uni_encoder_tpu_torch import native
from uni_encoder_tpu_torch.data import image_io


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pil_file(path, kind, rng):
    h, w = 23, 37
    if kind == "L":
        Image.fromarray(rng.randint(0, 256, (h, w), np.uint8), mode="L").save(path)
    elif kind == "I;16":
        Image.fromarray(rng.randint(0, 65536, (h, w)).astype(np.uint16)).save(path)
    elif kind in ("RGB", "RGBA", "LA"):
        Image.fromarray(rng.randint(0, 256, (h, w, len(kind)), np.uint8), mode=kind).save(path)
    else:  # "P<colours>": PIL writes 1, 2, 4 or 8-bit indices by palette size
        n = int(kind[1:])
        img = Image.fromarray(rng.randint(0, n, (h, w)).astype(np.uint8), mode="P")
        img.putpalette(rng.randint(0, 256, 3 * n).tolist())
        img.save(path)


@pytest.mark.parametrize("kind", ["L", "I;16", "RGB", "RGBA", "LA", "P2", "P4", "P16", "P256"])
def test_read_png_matches_pil_on_pil_files(tmp_path, kind):
    path = str(tmp_path / "x.png")
    _pil_file(path, kind, np.random.RandomState(0))
    ref = Image.open(path)
    got = image_io.read_png(path)
    assert got.dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(image_io.read_image(path), np.asarray(ref.convert("RGB")))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("kind", ["L", "I;16", "RGB", "RGBA", "P"])
def test_read_png_matches_pil_on_each_filter_type(tmp_path, kind, filters):
    rng = np.random.RandomState(1)
    h, w = 19, 31
    # smooth content plus noise, so each filter predicts something
    base = (np.add.outer(np.arange(h) * 7, np.arange(w) * 3) % 256).astype(np.int64)
    palette = None
    if kind == "L":
        arr = ((base + rng.randint(0, 9, (h, w))) % 256).astype(np.uint8)
    elif kind == "I;16":
        arr = (base * 251 + rng.randint(0, 300, (h, w))).astype(np.uint16)
    elif kind == "P":
        arr = ((base + rng.randint(0, 4, (h, w))) % 200).astype(np.uint8)
        palette = rng.randint(0, 256, (200, 3))
    else:
        arr = ((base[:, :, None] + rng.randint(0, 9, (h, w, len(kind)))) % 256).astype(np.uint8)
    path = str(tmp_path / "f.png")
    ecommon.encode_png(path, arr, filters, palette)
    ref = Image.open(path)
    np.testing.assert_array_equal(image_io.read_png(path), np.asarray(ref))
    np.testing.assert_array_equal(image_io.read_png(path), arr)
    np.testing.assert_array_equal(image_io.read_image(path), np.asarray(ref.convert("RGB")))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_matches_plain(bpp):
    """Random filter bytes per row on random data (every branch, at the
    first row and column too)."""
    rng = np.random.RandomState(bpp)
    height, stride = 9, 5 * bpp + 3
    stream = rng.randint(0, 256, (height, stride + 1)).astype(np.uint8)
    stream[:, 0] = rng.randint(0, 5, height)
    got = native.png_unfilter(stream, height, stride, bpp)
    np.testing.assert_array_equal(got, native.png_unfilter_plain(stream, height, stride, bpp))


def test_png_unfilter_rejects_a_bad_filter_byte():
    stream = np.zeros((3, 5), np.uint8)
    stream[1, 0] = 7
    with pytest.raises(ValueError, match="row 1 has filter type 7"):
        native.png_unfilter(stream, 3, 4, 1)
    with pytest.raises(ValueError, match="row 1 has filter type 7"):
        native.png_unfilter_plain(stream, 3, 4, 1)


@pytest.mark.parametrize("kind", ["bilinear", "lanczos"])
@pytest.mark.parametrize("sizes", [(160, 29), (37, 500), (41, 41), (9, 1)])
def test_resample_pass_matches_plain(kind, sizes):
    in_size, out_size = sizes
    src = np.random.RandomState(in_size).randint(0, 256, (3, in_size, 5)).astype(np.uint8)
    coeffs = image_io._coefficients(in_size, out_size, kind)
    np.testing.assert_array_equal(native.resample_pass(src, *coeffs), native.resample_pass_plain(src, *coeffs))


RESIZES = [(17, 29), (100, 200), (80, 53), (37, 200), (192, 512), (240, 7)]


@pytest.mark.parametrize("hw", RESIZES)
@pytest.mark.parametrize("kind", ["bilinear", "lanczos"])
def test_resize_matches_pil(kind, hw):
    """Down- and up-scales, one axis at a time and both; RGB and greyscale.
    Observed: every value equal to PIL's."""
    rng = np.random.RandomState(3)
    fn = {"bilinear": image_io.resize_bilinear, "lanczos": image_io.resize_lanczos}[kind]
    pil = {"bilinear": Image.BILINEAR, "lanczos": Image.LANCZOS}[kind]
    for img in (rng.randint(0, 256, (120, 160, 3), np.uint8), rng.randint(0, 256, (120, 160), np.uint8)):
        ref = np.asarray(Image.fromarray(img).resize((hw[1], hw[0]), pil))
        np.testing.assert_array_equal(fn(img, hw), ref)


@pytest.mark.parametrize("hw", RESIZES)
def test_resize_nearest_matches_pil(hw):
    rng = np.random.RandomState(4)
    for arr in (rng.randint(0, 256, (120, 160), np.uint8), rng.randint(0, 100000, (120, 160)).astype(np.int32)):
        ref = np.asarray(Image.fromarray(arr).resize((hw[1], hw[0]), Image.NEAREST))
        np.testing.assert_array_equal(image_io.resize_nearest(arr, hw), ref)


def test_read_image_resizes_as_the_jax_mapper(tmp_path):
    from uni_encoder_tpu.data.mappers import read_image as jread_image

    path = str(tmp_path / "frame.png")
    image_io.write_png(path, np.random.RandomState(5).randint(0, 256, (75, 124, 3), np.uint8))
    np.testing.assert_array_equal(image_io.read_image(path, (64, 48)), jread_image(path, (64, 48)))
    np.testing.assert_array_equal(image_io.read_image(path), jread_image(path))


@pytest.mark.parametrize("arr", [np.arange(6 * 7, dtype=np.uint8).reshape(6, 7),
                                 (np.arange(6 * 7, dtype=np.uint16) * 1500).reshape(6, 7),
                                 np.arange(6 * 7 * 2, dtype=np.uint8).reshape(6, 7, 2),
                                 np.arange(6 * 7 * 3, dtype=np.uint8).reshape(6, 7, 3),
                                 np.arange(6 * 7 * 4, dtype=np.uint8).reshape(6, 7, 4)],
                         ids=["L", "I;16", "LA", "RGB", "RGBA"])
def test_write_png_round_trips_through_pil(tmp_path, arr):
    path = str(tmp_path / "w.png")
    image_io.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(image_io.read_png(path), arr)


def test_interlaced_png_raises(tmp_path):
    """A file whose IHDR asks for Adam7 interlacing (byte 12 of its body)."""
    path = str(tmp_path / "i.png")
    ecommon.encode_png(path, np.zeros((8, 8), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[8 + 8 + 12] = 1
    data[8 + 8 + 13:8 + 8 + 17] = struct.pack(">I", zlib.crc32(bytes(data[12:8 + 8 + 13])))
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        image_io.read_png(path)


def test_jpeg_without_pil_names_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "photo.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    assert image_io.read_image(path).shape == (8, 8, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="photo.jpg"):
        image_io.read_image(path)
