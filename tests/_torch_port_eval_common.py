"""Shared pieces of the port's evaluation-path tests
(tests/test_torch_port_{image_io,checkpoint,eval}.py): a PNG encoder that
applies each of the five PNG filters, and the small synthetic Cityscapes /
KITTI tree registered in both packages' catalogs."""

import os
import struct
import zlib

import numpy as np

import _torch_port_common as common

KITTI_NAME = "kitti_synthetic_png"  # the synthetic KITTI split, PNG frames
VAL_HW = (64, 128)  # Cityscapes val images: the scaled model's input, no resize
SEQ_HW = (64, 128)  # sequence frames, Lanczos-resized to 192x512 by the mapper


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """The filtered stream of (H, stride) uint8 `rows`: row y through PNG
    filter filters[y % len(filters)], each after its filter-type byte."""
    rows = rows.astype(np.int64)
    out = []
    for y, row in enumerate(rows):
        f = filters[y % len(filters)]
        up = rows[y - 1] if y else np.zeros_like(row)
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        pred = [np.zeros_like(row), left, up, (left + up) // 2, _paeth(left, up, up_left)][f]
        out.append(np.concatenate([[f], (row - pred) % 256]))
    return np.concatenate(out).astype(np.uint8)


def encode_png(path: str, arr: np.ndarray, filters=(0,), palette=None) -> None:
    """Write (H, W) uint8 / uint16 greyscale, (H, W, 2|3|4) uint8, or (H, W)
    uint8 palette indices with `palette` (N, 3), through the given filters."""
    if palette is not None:
        ctype, depth, ch = 3, 8, 1
    elif arr.ndim == 2:
        ctype, depth, ch = 0, 8 * arr.itemsize, 1
    else:
        ctype, depth, ch = {2: 4, 3: 2, 4: 6}[arr.shape[2]], 8, arr.shape[2]
    h, w = arr.shape[:2]
    data = arr.astype(">u2") if depth == 16 else arr
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, -1)
    stream = filter_rows(rows, max(1, ch * depth // 8), filters)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)))
        if palette is not None:
            f.write(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
        f.write(chunk(b"IDAT", zlib.compress(stream.tobytes())))
        f.write(chunk(b"IEND", b""))


def write_and_register_tree(root: str) -> None:
    """The synthetic tree at the test sizes (GT depth at Cityscapes' full
    1024x2048, which the depth protocol's fixed crop needs), registered in
    the port's and the JAX package's catalogs; KITTI as KITTI_NAME."""
    from uni_encoder_tpu.data import catalog as jcatalog
    from uni_encoder_tpu.data.datasets import cityscapes_panoptic, cityscapes_sequence
    from uni_encoder_tpu.data.datasets import kitti as jkitti
    from uni_encoder_tpu_torch.data import datasets, synthetic

    synthetic.write_cityscapes_val(root, 2, VAL_HW)
    synthetic.write_cityscapes_sequence(root, 2, SEQ_HW)
    files = synthetic.write_kitti(root, 2)
    datasets.register_all(root)
    synthetic.register_kitti(root, KITTI_NAME, files)
    cityscapes_panoptic.register_all(root)
    cityscapes_sequence.register_all(root)
    data = os.path.join(root, "kitti_data")
    jcatalog.DatasetCatalog.remove(KITTI_NAME)
    jcatalog.DatasetCatalog.register(KITTI_NAME, lambda: jkitti.load_split(data, files, img_ext=".png"))
    jcatalog.MetadataCatalog.get(KITTI_NAME).set(left_image_root=data, evaluator_type="kitti_depth")


# the scaled profile with Cityscapes' 19 classes (the evaluators' thing ids
# are 11..18)
SCALED_CONFIG = f"""
model:
  backbone:
    name: swin
    swin:
      embed_dim: {common.EMBED}
      depths: {list(common.DEPTHS)}
      num_heads: {list(common.HEADS)}
  sem_seg_head:
    num_classes: 19
    convs_dim: {common.CONV_DIM}
    mask_dim: {common.CONV_DIM}
    transformer_enc_layers: {common.ENC_LAYERS}
  one_former:
    num_object_queries: {common.NQ}
    dec_layers: {common.DEC_LAYERS}
    class_dec_layers: 2
    dim_feedforward: {common.DFF}
    hidden_dim: {common.CONV_DIM}
    nheads: {common.NHEADS}
  test:
    detections_per_image: {common.NQ * 19}
input:
  seg_min_size_test: {VAL_HW[0]}
  seg_max_size_test: {VAL_HW[1]}
datasets:
  depth_test: [cityscapes_crop_test, {KITTI_NAME}]
  seg_test_panoptic: [cityscapes_fine_panoptic_val]
  seg_test_semantic: [cityscapes_fine_panoptic_val]
  seg_test_instance: [cityscapes_fine_panoptic_val]
"""
