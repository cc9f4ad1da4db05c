"""COCO-format instance AP evaluator (the port's own copy of
`uni_encoder_tpu/evaluation/coco.py`).

Capability spec: reference model/evaluation/coco_evaluator.py +
instance_evaluation.py (InstanceSegEvaluator — the ADE-friendly fork
relaxing contiguous-id asserts). Matching/AP math comes from
metrics.APAccumulator (COCO protocol: IoU 0.50:0.05:0.95, 101-point
interpolation, crowd-ignore); GT masks decode from the dataset json's
polygon / RLE segmentations. Polygons are filled by cv2, imported when one
is drawn (as in the JAX package); RLE masks need nothing outside numpy.

`state` / `merge_state` are the accumulator's entries and GT count, for a
caller that gathers them from other processes (nothing in the port does
yet).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .evaluator import DatasetEvaluator
from .metrics import APAccumulator


def _poly_to_mask(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    import cv2

    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2).round().astype(np.int32)
        cv2.fillPoly(mask, [pts], 1)
    return mask.astype(bool)


def _rle_to_mask(rle: Dict, h: int, w: int) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, str):
        # compressed RLE (pycocotools-style LEB128 variant)
        counts = _decode_compressed_rle(counts)
    mask = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            mask[pos : pos + c] = True
        pos += c
        val = not val
    return mask.reshape(w, h).T if rle.get("order", "F") == "F" else mask.reshape(h, w)


def _decode_compressed_rle(s: str) -> List[int]:
    counts, i = [], 0
    b = s.encode("ascii") if isinstance(s, str) else s
    while i < len(b):
        x, k, more = 0, 0, True
        while more:
            c = b[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


class COCOInstanceEvaluator(DatasetEvaluator):
    def __init__(self, dataset_name: str, num_classes: int = None):
        from ..data.catalog import MetadataCatalog

        self.dataset_name = dataset_name
        meta = MetadataCatalog.get(dataset_name)
        self.num_classes = num_classes or len(meta.get("thing_classes", []) or [])

    def reset(self):
        self.acc = APAccumulator(self.num_classes)

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            h, w = inp["height"], inp["width"]
            gt_masks, gt_classes, gt_crowd = [], [], []
            for ann in inp.get("annotations", []):
                seg = ann.get("segmentation")
                if seg is None:
                    continue
                if isinstance(seg, list):
                    m = _poly_to_mask(seg, h, w)
                else:
                    m = _rle_to_mask(dict(seg, order="F"), h, w)
                gt_masks.append(m)
                gt_classes.append(ann["category_id"])
                gt_crowd.append(bool(ann.get("iscrowd", 0)))
            inst = out["instances"]
            self.acc.update(
                [np.asarray(m, bool) for m in inst["masks"]],
                np.asarray(inst["labels"]),
                np.asarray(inst["scores"]),
                gt_masks,
                np.asarray(gt_classes, np.int64),
                np.asarray(gt_crowd, bool),
            )

    def state(self):
        return (dict(self.acc.entries), self.acc.n_gt)

    def merge_state(self, states):
        from collections import defaultdict

        merged = defaultdict(list)
        n_gt = 0
        for entries, n in states:
            for c, es in entries.items():
                merged[c].extend(es)
            n_gt = n_gt + n
        self.acc.entries = merged
        self.acc.n_gt = n_gt

    def evaluate(self):
        return {"segm": self.acc.summarize()}
