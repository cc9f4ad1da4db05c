"""Native numpy metric computations: mIoU, PQ, instance-mask AP (the port's
own copy of `uni_encoder_tpu/evaluation/metrics.py`).

The reference delegates to third-party scorers — cityscapesscripts (mIoU,
instance AP), panopticapi via d2's COCOPanopticEvaluator (PQ) — none of
which are in this environment, so the algorithms are implemented here
directly from their public definitions:

  * mIoU: per-class IoU from a confusion matrix over trainIds, ignore 255
    (equivalent to cityscapesscripts evalPixelLevelSemanticLabeling on the
    19 eval classes).
  * PQ (Kirillov et al.): segments match iff same class and IoU > 0.5 where
    IoU excludes void; unmatched predictions with > 50% void overlap are not
    counted as FP; PQ = sum(IoU_TP) / (|TP| + |FP|/2 + |FN|/2), with SQ/RQ.
  * AP: instance mask AP averaged over IoU 0.50:0.05:0.95 and AP50, with
    crowd/ignore-region handling. Two score sweeps are available:
    "exact" (default for the Cityscapes evaluator) — the non-interpolated
    area under the exact precision-recall curve, AP = sum_k (R_k - R_{k-1})
    * P_k over the score-sorted prediction prefix sweep, matching the
    cityscapesscripts protocol of sweeping every confidence threshold —
    and "coco101", COCO's 101-point interpolated variant.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

VOID = -1


# --------------------------------------------------------------------- mIoU
class ConfusionMatrix:
    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.mat = np.zeros((num_classes, num_classes), np.int64)

    def update(self, gt: np.ndarray, pred: np.ndarray):
        if gt.dtype == np.uint8 and pred.max(initial=0) < 256:
            from ..native import accumulate_confusion

            accumulate_confusion(
                gt.reshape(-1), pred.reshape(-1).astype(np.uint8),
                self.num_classes, self.ignore_label, self.mat,
            )
            return
        valid = gt != self.ignore_label
        gt = gt[valid].astype(np.int64)
        pred = pred[valid].astype(np.int64)
        idx = gt * self.num_classes + pred
        self.mat += np.bincount(idx, minlength=self.num_classes ** 2).reshape(
            self.num_classes, self.num_classes
        )

    def merge(self, other: "ConfusionMatrix"):
        """Accumulate another shard's confusion matrix (sharded evaluation)."""
        self.mat += other.mat

    def miou(self) -> Tuple[float, np.ndarray]:
        inter = np.diag(self.mat).astype(np.float64)
        union = self.mat.sum(0) + self.mat.sum(1) - np.diag(self.mat)
        iou = np.where(union > 0, inter / np.maximum(union, 1), np.nan)
        return float(np.nanmean(iou)), iou


# ----------------------------------------------------------------------- PQ
class PQStat:
    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.iou = np.zeros(num_classes)
        self.tp = np.zeros(num_classes, np.int64)
        self.fp = np.zeros(num_classes, np.int64)
        self.fn = np.zeros(num_classes, np.int64)

    def update(
        self,
        pred_seg: np.ndarray,  # (H, W) segment ids, 0 = unlabeled
        pred_info: List[Dict],  # [{id, category_id, isthing}]
        gt_seg: np.ndarray,  # (H, W) segment ids, 0 = void/unlabeled
        gt_info: List[Dict],  # [{id, category_id, iscrowd}]
    ):
        pred_cat = {s["id"]: s["category_id"] for s in pred_info}
        gt_cat = {s["id"]: s["category_id"] for s in gt_info}
        gt_crowd = {s["id"]: s.get("iscrowd", 0) for s in gt_info}

        # joint histogram of (gt_id, pred_id) areas
        combined = gt_seg.astype(np.int64) * (2 ** 32) + pred_seg.astype(np.int64)
        ids, counts = np.unique(combined, return_counts=True)
        inter = {}
        for v, c in zip(ids, counts):
            inter[(int(v // 2 ** 32), int(v % 2 ** 32))] = int(c)

        gt_area = defaultdict(int)
        pred_area = defaultdict(int)
        for (g, p), c in inter.items():
            gt_area[g] += c
            pred_area[p] += c

        matched_gt, matched_pred = set(), set()
        for (g, p), c in inter.items():
            if g == 0 or p == 0 or g not in gt_cat or p not in pred_cat:
                continue
            if gt_crowd.get(g, 0):
                continue
            if gt_cat[g] != pred_cat[p]:
                continue
            union = gt_area[g] + pred_area[p] - c - inter.get((0, p), 0)
            iou = c / union if union > 0 else 0.0
            if iou > 0.5:
                cat = gt_cat[g]
                self.tp[cat] += 1
                self.iou[cat] += iou
                matched_gt.add(g)
                matched_pred.add(p)

        crowd_area_by_cat = defaultdict(int)
        for g, cat in gt_cat.items():
            if gt_crowd.get(g, 0):
                crowd_area_by_cat[cat] += gt_area[g]
                continue
            if g not in matched_gt and gt_area[g] > 0:
                self.fn[cat] += 1

        for p, cat in pred_cat.items():
            if p in matched_pred:
                continue
            area = pred_area.get(p, 0)
            if area == 0:
                continue
            void_overlap = inter.get((0, p), 0)
            # crowd regions of the same class also don't make a pred FP
            for (g, pp), c in inter.items():
                if pp == p and g in gt_cat and gt_crowd.get(g, 0) and gt_cat[g] == cat:
                    void_overlap += c
            if void_overlap / area > 0.5:
                continue
            self.fp[cat] += 1

    def merge(self, other: "PQStat"):
        """Accumulate another shard's PQ statistics (sharded evaluation)."""
        self.iou += other.iou
        self.tp += other.tp
        self.fp += other.fp
        self.fn += other.fn

    def summarize(self, thing_ids: Sequence[int], stuff_ids: Sequence[int]) -> Dict[str, float]:
        def agg(ids):
            pq, sq, rq, n = 0.0, 0.0, 0.0, 0
            for c in ids:
                denom = self.tp[c] + 0.5 * self.fp[c] + 0.5 * self.fn[c]
                if denom == 0 and self.tp[c] + self.fp[c] + self.fn[c] == 0:
                    continue
                n += 1
                pq_c = self.iou[c] / denom if denom else 0.0
                sq_c = self.iou[c] / self.tp[c] if self.tp[c] else 0.0
                rq_c = self.tp[c] / denom if denom else 0.0
                pq, sq, rq = pq + pq_c, sq + sq_c, rq + rq_c
            n = max(n, 1)
            return 100 * pq / n, 100 * sq / n, 100 * rq / n

        all_ids = list(thing_ids) + list(stuff_ids)
        pq, sq, rq = agg(all_ids)
        pq_th, sq_th, rq_th = agg(thing_ids)
        pq_st, sq_st, rq_st = agg(stuff_ids)
        return {
            "PQ": pq, "SQ": sq, "RQ": rq,
            "PQ_th": pq_th, "SQ_th": sq_th, "RQ_th": rq_th,
            "PQ_st": pq_st, "SQ_st": sq_st, "RQ_st": rq_st,
        }


# ----------------------------------------------------------------------- AP
def mask_iou_matrix(preds: List[np.ndarray], gts: List[np.ndarray], gt_crowd: List[bool]):
    """IoU between boolean masks; for crowd GT, IoU = inter / pred area."""
    M, N = len(preds), len(gts)
    iou = np.zeros((M, N), np.float64)
    p_areas = [p.sum() for p in preds]
    g_areas = [g.sum() for g in gts]
    for j, g in enumerate(gts):
        for i, p in enumerate(preds):
            inter = np.logical_and(p, g).sum()
            if gt_crowd[j]:
                denom = p_areas[i]
            else:
                denom = p_areas[i] + g_areas[j] - inter
            iou[i, j] = inter / denom if denom > 0 else 0.0
    return iou


class APAccumulator:
    """Per-class score/match accumulation across images -> AP / AP50."""

    IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)

    def __init__(self, num_classes: int, interpolation: str = "coco101"):
        assert interpolation in ("coco101", "exact")
        self.num_classes = num_classes
        self.interpolation = interpolation
        # per class: list of (score, is_match_at_each_threshold (T,), ignored)
        self.entries = defaultdict(list)
        self.n_gt = np.zeros(num_classes, np.int64)

    def update(
        self,
        pred_masks: List[np.ndarray],
        pred_classes: np.ndarray,
        pred_scores: np.ndarray,
        gt_masks: List[np.ndarray],
        gt_classes: np.ndarray,
        gt_crowd: np.ndarray,
    ):
        T = len(self.IOU_THRESHOLDS)
        for c in range(self.num_classes):
            p_idx = [i for i in range(len(pred_masks)) if pred_classes[i] == c]
            g_idx = [j for j in range(len(gt_masks)) if gt_classes[j] == c]
            if not p_idx and not g_idx:
                continue
            g_crowd = [bool(gt_crowd[j]) for j in g_idx]
            self.n_gt[c] += sum(1 for x in g_crowd if not x)
            if not p_idx:
                continue
            order = sorted(p_idx, key=lambda i: -pred_scores[i])
            iou = mask_iou_matrix(
                [pred_masks[i] for i in order], [gt_masks[j] for j in g_idx], g_crowd
            )
            img_entries = [[pred_scores[i], np.zeros(T, bool), False] for i in order]
            for ti, t in enumerate(self.IOU_THRESHOLDS):
                taken = [False] * len(g_idx)
                for pi in range(len(order)):
                    best, best_j = t, -1
                    for gj in range(len(g_idx)):
                        if taken[gj] and not g_crowd[gj]:
                            continue
                        if iou[pi, gj] >= best:
                            best, best_j = iou[pi, gj], gj
                    if best_j >= 0:
                        if g_crowd[best_j]:
                            img_entries[pi][2] = True  # matched crowd: ignore
                        else:
                            taken[best_j] = True
                            img_entries[pi][1][ti] = True
            self.entries[c].extend(img_entries)

    def merge(self, other: "APAccumulator"):
        """Accumulate another shard's detections and GT counts (sharded
        evaluation)."""
        for c, es in other.entries.items():
            self.entries[c].extend(es)
        self.n_gt += other.n_gt

    def summarize(self) -> Dict[str, float]:
        T = len(self.IOU_THRESHOLDS)
        ap_per_class, ap50_per_class = [], []
        for c in range(self.num_classes):
            entries = self.entries[c]
            if self.n_gt[c] == 0:
                continue
            if not entries:
                ap_per_class.append(0.0)
                ap50_per_class.append(0.0)
                continue
            entries = sorted(entries, key=lambda e: -e[0])
            aps = []
            for ti in range(T):
                tp = np.array([e[1][ti] for e in entries if not (e[2] and not e[1][ti])])
                if len(tp) == 0:
                    aps.append(0.0)
                    continue
                fp = ~tp
                ctp, cfp = np.cumsum(tp), np.cumsum(fp)
                recall = ctp / self.n_gt[c]
                precision = ctp / np.maximum(ctp + cfp, 1)
                if self.interpolation == "exact":
                    # exact sweep: area under the exact PR curve, rectangle
                    # rule with the precision at each recall step
                    dr = np.diff(np.concatenate([[0.0], recall]))
                    aps.append(float(np.sum(dr * precision)))
                else:
                    # COCO 101-point interpolation
                    prec_interp = np.maximum.accumulate(precision[::-1])[::-1]
                    rs = np.linspace(0, 1, 101)
                    p_at_r = np.zeros_like(rs)
                    for k, r in enumerate(rs):
                        inds = np.searchsorted(recall, r, side="left")
                        if inds < len(prec_interp):
                            p_at_r[k] = prec_interp[inds]
                    aps.append(p_at_r.mean())
            ap_per_class.append(float(np.mean(aps)))
            ap50_per_class.append(float(aps[0]))
        ap = 100 * float(np.mean(ap_per_class)) if ap_per_class else 0.0
        ap50 = 100 * float(np.mean(ap50_per_class)) if ap50_per_class else 0.0
        return {"AP": ap, "AP50": ap50}
