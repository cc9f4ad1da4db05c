"""Dataset-preparation helpers (the port's own copy of
`uni_encoder_tpu/data/prep.py`): the panoptic id/colour codec, COCO RLE
encoding, segment-id generation, and the ADE20K metadata tables.

* the panoptic PNG colour convention ``id = R + 256*G + 256^2*B``
  (panopticapi's ``rgb2id`` / ``id2rgb``);
* COCO compressed RLE (pycocotools' 5-bit LEB128 variant with deltas
  against the count two back), the exact inverse of
  ``evaluation/coco._decode_compressed_rle``;
* a deterministic ``IdGenerator`` (globally unique colours; the first
  segment of a category takes the category's base colour);
* the ADE20K-150 category table (names, palette, instance -> semantic id
  map), read from the JSON asset `data/assets/ade20k_meta.json`, a byte
  copy of the JAX package's (public dataset metadata, like the BPE
  vocabulary).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "ade20k_meta.json")


# --------------------------------------------------------------------------
# panoptic colour codec


def rgb2id(color):
    """(H, W, 3) uint8 -> (H, W) int64 segment-id map, or a length-3 colour
    -> python int (panopticapi convention: id = R + 256*G + 256^2*B)."""
    color = np.asarray(color, dtype=np.uint32)
    if color.ndim == 3:
        return (color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]).astype(np.int64)
    return int(color[0] + 256 * color[1] + 256 * 256 * color[2])


def id2rgb(seg_id) -> np.ndarray:
    """Inverse of rgb2id; accepts a scalar or an (H, W) id map."""
    seg_id = np.asarray(seg_id, dtype=np.int64)
    out = np.zeros(seg_id.shape + (3,), dtype=np.uint8)
    for c in range(3):
        out[..., c] = seg_id % 256
        seg_id = seg_id // 256
    return out


# --------------------------------------------------------------------------
# COCO compressed RLE (pycocotools-compatible)


def mask_to_rle_counts(mask: np.ndarray) -> List[int]:
    """Column-major (Fortran) run lengths, starting with the zero run."""
    flat = np.asarray(mask, dtype=bool).flatten(order="F")
    idx = np.flatnonzero(flat[1:] != flat[:-1]) + 1  # boundaries between runs
    runs = np.diff(np.concatenate([[0], idx, [flat.size]])).tolist()
    if flat.size and flat[0]:
        runs = [0] + runs
    return [int(r) for r in runs]


def _encode_counts(counts: Sequence[int]) -> str:
    """COCO string encoding: 5-bit groups, 0x20 continuation, ASCII offset 48;
    counts beyond the 2nd are delta-coded against counts[i-2]."""
    out = bytearray()
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # arithmetic shift: sign-extends negatives like C
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def encode_rle(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> COCO compressed RLE dict (pycocotools
    ``mask.encode`` equivalent; Fortran order, string counts)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": _encode_counts(mask_to_rle_counts(mask))}


def rle_area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, str):
        from ..evaluation.coco import _decode_compressed_rle

        counts = _decode_compressed_rle(counts)
    return int(sum(counts[1::2]))


def mask_bbox_xywh(mask: np.ndarray) -> List[int]:
    """Tight [x, y, w, h] box of a binary mask (inclusive extents)."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return [0, 0, 0, 0]
    x0, y0 = int(xs.min()), int(ys.min())
    return [x0, y0, int(xs.max()) - x0 + 1, int(ys.max()) - y0 + 1]


# --------------------------------------------------------------------------
# segment id / colour generation


class IdGenerator:
    """Unique panoptic segment ids with category-anchored colours.

    For each category the first segment takes the category's base colour;
    later segments take the base colour plus a small unique jitter. The
    segment id is ``rgb2id(color)``. Deterministic (seeded PRNG).
    """

    def __init__(self, categories: Dict[int, dict], seed: int = 0):
        self.categories = categories
        self.taken: set = set()
        self.rng = np.random.RandomState(seed)

    def get_color(self, cat_id: int) -> Tuple[int, int, int]:
        base = np.asarray(self.categories[cat_id]["color"], dtype=np.int64)
        color = tuple(int(v) for v in base)
        while rgb2id(np.asarray(color, np.uint32)) in self.taken or color == (0, 0, 0):
            jit = self.rng.randint(-32, 33, size=3)
            color = tuple(int(v) for v in np.clip(base + jit, 0, 255))
        self.taken.add(rgb2id(np.asarray(color, np.uint32)))
        return color

    def get_id_and_color(self, cat_id: int) -> Tuple[int, Tuple[int, int, int]]:
        color = self.get_color(cat_id)
        return int(rgb2id(np.asarray(color, np.uint32))), color


# --------------------------------------------------------------------------
# ADE20K metadata (public dataset tables; see module docstring)


def _load_asset() -> dict:
    with open(_ASSET) as f:
        return json.load(f)


def ade20k_instance_to_semantic() -> Dict[int, int]:
    """1-based instance-annotation category id -> 1-based semantic (150) id."""
    return {int(k): int(v) for k, v in _load_asset()["instance_to_semantic"].items()}


def ade20k_150_categories() -> List[dict]:
    """The 150 ADE20K categories with 0-based contiguous ids, isthing flags
    derived from the instance -> semantic map, and the standard palette."""
    meta = _load_asset()
    thing_sem0 = {v - 1 for v in ade20k_instance_to_semantic().values()}
    return [
        {"name": name, "id": i, "isthing": int(i in thing_sem0), "color": list(meta["palette"][i])}
        for i, name in enumerate(meta["names"])
    ]
