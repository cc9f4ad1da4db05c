"""Cityscapes evaluators: semantic mIoU, instance AP, panoptic PQ, depth
(the port's own copy of `uni_encoder_tpu/evaluation/cityscapes.py`).

Capability spec: reference model/evaluation/cityscapes_evaluation.py +
train_net.py's use of d2's CityscapesSemSegEvaluator / COCOPanopticEvaluator
(:83-149). Where the reference shells out to cityscapesscripts/panopticapi,
these evaluators accumulate in-process using evaluation/metrics.py (the
third-party scorers are unavailable here; algorithms follow the public
protocol definitions). Depth follows the exact reference crops / median
scaling / clamps (cityscapes_evaluation.py:231-362).

PNG files are read by `data.image_io.read_png` and label maps resized by
its `resize_nearest` (PIL's NEAREST), where the JAX package uses PIL; the
disparity's cv2.resize (INTER_LINEAR) is `resize_disparity`, cv2's
arithmetic in numpy.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import List

import numpy as np

from ..data.cityscapes_labels import (
    IGNORE_LABEL,
    NUM_CLASSES,
    STUFF_TRAIN_IDS,
    THING_TRAIN_IDS,
)
from ..data.image_io import read_png, resize_nearest
from ..geometry import disp_to_depth
from ..native import decode_panoptic_ids
from .evaluator import DatasetEvaluator
from .metrics import APAccumulator, ConfusionMatrix, PQStat

logger = logging.getLogger(__name__)


def _linear_taps(in_size: int, out_size: int, reset_borders: bool):
    """cv2 INTER_LINEAR's taps along one axis (imgproc/resize.cpp): the
    source coordinate (d + 0.5) * scale - 0.5 in float64, its floor, and its
    fraction rounded to float32. Horizontally a coordinate outside the
    source takes the edge pixel with weight 1; vertically the row indices
    are clamped instead."""
    scale = 1.0 / (out_size / in_size)
    f = (np.arange(out_size) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    if reset_borders:
        f[(s < 0) | (s >= in_size - 1)] = 0
        s = np.clip(s, 0, in_size - 1)
    s0, s1 = np.clip(s, 0, in_size - 1), np.clip(s + 1, 0, in_size - 1)
    return s0, s1, np.float32(1) - f, f


def resize_disparity(disp: np.ndarray, hw) -> np.ndarray:
    """cv2.resize(disp, (w, h)) with INTER_LINEAR, which the JAX package
    calls, for an (h, w) float32 map: a horizontal pass, then a vertical
    one, in float32, with cv2's float64 source coordinates (torch's bilinear
    resize computes them in float32 and differs from cv2 by up to 4e-4
    relative at KITTI's non-integer 192x640 -> 375x1242 scale)."""
    src = np.asarray(disp, np.float32)
    h, w = int(hw[0]), int(hw[1])
    x0, x1, a0, a1 = _linear_taps(src.shape[1], w, reset_borders=True)
    rows = src[:, x0] * a0 + src[:, x1] * a1
    y0, y1, b0, b1 = _linear_taps(src.shape[0], h, reset_borders=False)
    return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]


def _dataset_classes(dataset_name: str):
    """Per-dataset class layout from the catalog, with cityscapes defaults:
    (num classes, ignore label, thing contiguous ids, stuff contiguous ids)."""
    from ..data.catalog import MetadataCatalog

    meta = MetadataCatalog.get(dataset_name)
    num = meta.get("num_sem_classes") or len(meta.get("stuff_classes") or []) or NUM_CLASSES
    ignore = meta.get("ignore_label", IGNORE_LABEL)
    thing = sorted((meta.get("thing_dataset_id_to_contiguous_id") or {}).values())
    stuff = sorted((meta.get("stuff_dataset_id_to_contiguous_id") or {}).values())
    if not thing and not stuff:
        thing, stuff = list(THING_TRAIN_IDS), list(STUFF_TRAIN_IDS)
    return num, ignore, thing, [s for s in stuff if s not in set(thing)]


class CityscapesSemSegEvaluator(DatasetEvaluator):
    """mIoU over the contiguous semantic classes against the label PNGs
    (cityscapes *_labelTrainIds.png / prepped ADE20K annotations)."""

    def __init__(self, dataset_name: str):
        self.dataset_name = dataset_name
        self.num_classes, self.ignore_label, _, _ = _dataset_classes(dataset_name)

    def reset(self):
        self.cm = ConfusionMatrix(self.num_classes, self.ignore_label)

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            pred = np.asarray(out["sem_seg"])  # (K, H, W) probabilities or (H, W) labels
            if pred.ndim == 3:
                pred = pred.argmax(0)
            gt = read_png(inp["sem_seg_file_name"])
            if gt.shape != pred.shape:
                pred = resize_nearest(pred.astype(np.uint8), gt.shape)
            self.cm.update(gt, pred)

    def state(self):
        return self.cm.mat

    def merge_state(self, states):
        self.cm.mat = np.sum(states, axis=0)

    def evaluate(self):
        miou, iou = self.cm.miou()
        return {"sem_seg": {"mIoU": 100 * miou, "IoU": (100 * iou).tolist()}}


class CityscapesPanopticEvaluator(DatasetEvaluator):
    """PQ against the cityscapes panoptic PNG/JSON GT (COCOPanopticEvaluator
    equivalent). GT segment ids are read from the panoptic PNG (RGB-encoded
    id = R + 256*G + 256^2*B, panopticapi convention)."""

    def __init__(self, dataset_name: str):
        self.dataset_name = dataset_name
        self.num_classes, _, self.thing_ids, self.stuff_ids = _dataset_classes(dataset_name)

    def reset(self):
        self.stat = PQStat(self.num_classes)

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            pan_seg, segments_info = out["panoptic_seg"]
            pan_seg = np.asarray(pan_seg)
            pred_info = [
                {"id": s["id"], "category_id": s["category_id"], "isthing": s["isthing"]}
                for s in segments_info
            ]
            gt_png = read_png(inp["pan_seg_file_name"])
            gt_ids = decode_panoptic_ids(gt_png)
            gt_info = [
                {"id": s["id"], "category_id": s["category_id"], "iscrowd": s.get("iscrowd", 0)}
                for s in inp["segments_info"]
            ]
            # remap unknown ids (void) to 0
            known = {s["id"] for s in gt_info}
            gt_seg = np.where(np.isin(gt_ids, list(known)), gt_ids, 0).astype(np.int64)
            if gt_seg.shape != pan_seg.shape:
                pan_seg = resize_nearest(pan_seg.astype(np.int32), gt_seg.shape)
            self.stat.update(pan_seg, pred_info, gt_seg, gt_info)

    def state(self):
        return (self.stat.iou, self.stat.tp, self.stat.fp, self.stat.fn)

    def merge_state(self, states):
        self.stat.iou = sum(s[0] for s in states)
        self.stat.tp = sum(s[1] for s in states)
        self.stat.fp = sum(s[2] for s in states)
        self.stat.fn = sum(s[3] for s in states)

    def evaluate(self):
        return {"panoptic_seg": self.stat.summarize(self.thing_ids, self.stuff_ids)}


class CityscapesInstanceEvaluator(DatasetEvaluator):
    """Instance AP / AP50 for the 8 thing classes, GT from the
    *_instanceIds.png maps (id = dataset_id * 1000 + instance for things)."""

    def __init__(self, dataset_name: str):
        self.dataset_name = dataset_name
        from ..data.cityscapes_labels import ID_TO_TRAINID

        self.id_to_trainid = ID_TO_TRAINID
        self.thing_set = set(THING_TRAIN_IDS)
        # compact class index for AP accumulation
        self.thing_index = {t: i for i, t in enumerate(sorted(self.thing_set))}

    def reset(self):
        # exact confidence sweep (cityscapesscripts protocol), not COCO's
        # 101-point interpolation
        self.acc = APAccumulator(len(self.thing_index), interpolation="exact")

    def _gt_instances(self, path):
        ids = read_png(path)
        masks, classes, crowd = [], [], []
        for v in np.unique(ids):
            if v < 1000:
                # pixel-level label: instances of this class are crowd regions
                train = self.id_to_trainid.get(int(v))
                if train in self.thing_set:
                    masks.append(ids == v)
                    classes.append(self.thing_index[train])
                    crowd.append(True)
                continue
            train = self.id_to_trainid.get(int(v) // 1000)
            if train in self.thing_set:
                masks.append(ids == v)
                classes.append(self.thing_index[train])
                crowd.append(False)
        return masks, np.asarray(classes, np.int64), np.asarray(crowd, bool)

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            inst = out["instances"]
            gt_path = (
                inp["file_name"].replace("leftImg8bit", "gtFine").split(".")[0]
                + "_instanceIds.png"
            )
            gt_masks, gt_classes, gt_crowd = self._gt_instances(gt_path)
            pred_masks = [np.asarray(m, bool) for m in inst["masks"]]
            labels = np.asarray(inst["labels"])
            keep = [i for i, l in enumerate(labels) if int(l) in self.thing_set]
            pred_masks = [pred_masks[i] for i in keep]
            pred_classes = np.asarray([self.thing_index[int(labels[i])] for i in keep])
            pred_scores = np.asarray([float(inst["scores"][i]) for i in keep])
            if gt_masks and gt_masks[0].shape != (pred_masks[0].shape if pred_masks else gt_masks[0].shape):
                pred_masks = [resize_nearest(m.astype(np.uint8), gt_masks[0].shape) > 0 for m in pred_masks]
            self.acc.update(pred_masks, pred_classes, pred_scores, gt_masks, gt_classes, gt_crowd)

    def state(self):
        return (dict(self.acc.entries), self.acc.n_gt)

    def merge_state(self, states):
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


class CityscapesDepthEvaluator(DatasetEvaluator):
    """Reference protocol (cityscapes_evaluation.py:231-362): per-image —
    top-25% row cut, resize pred to GT size, fixed crop [256:, 192:1856],
    valid depth (1e-3, 80), median scaling, clamp, 7 metrics averaged."""

    MIN_DEPTH = 1e-3
    MAX_DEPTH = 80.0

    def __init__(self, dataset_name: str):
        self.dataset_name = dataset_name

    def reset(self):
        self.metrics: List[np.ndarray] = []

    def process(self, inputs, outputs):
        for inp, out in zip(inputs, outputs):
            gt_path = inp["file_name"].replace("/leftImg8bit/test/", "/gt_depths/").replace(
                ".png", ".npy"
            )
            depth_gt = np.load(gt_path)
            disp = np.asarray(out["disp_results"]).squeeze()
            pred_disp, _ = disp_to_depth(disp)
            pred_disp = np.asarray(pred_disp)

            gt_h, gt_w = depth_gt.shape[:2]
            gt_h = int(round(gt_h * 0.75))
            depth_gt = depth_gt[:gt_h]
            pred_disp = resize_disparity(pred_disp, (gt_h, gt_w))
            depth_pred = 1.0 / pred_disp

            depth_gt = depth_gt[256:, 192:1856]
            depth_pred = depth_pred[256:, 192:1856]
            mask = (depth_gt > self.MIN_DEPTH) & (depth_gt < self.MAX_DEPTH)
            depth_pred, depth_gt = depth_pred[mask], depth_gt[mask]
            ratio = np.median(depth_gt) / np.median(depth_pred)
            depth_pred = np.clip(depth_pred * ratio, self.MIN_DEPTH, self.MAX_DEPTH)
            self.metrics.append(_depth_errors(depth_gt, depth_pred))

    def state(self):
        return self.metrics

    def merge_state(self, states):
        self.metrics = [m for shard in states for m in shard]

    def evaluate(self):
        m = np.mean(np.stack(self.metrics), axis=0)
        keys = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
        return {"depth_error": dict(zip(keys, m.tolist()))}


def _depth_errors(gt, pred):
    thresh = np.maximum(gt / pred, pred / gt)
    return np.array(
        [
            np.mean(np.abs(gt - pred) / gt),
            np.mean((gt - pred) ** 2 / gt),
            np.sqrt(np.mean((gt - pred) ** 2)),
            np.sqrt(np.mean((np.log(gt) - np.log(pred)) ** 2)),
            (thresh < 1.25).mean(),
            (thresh < 1.25 ** 2).mean(),
            (thresh < 1.25 ** 3).mean(),
        ]
    )
