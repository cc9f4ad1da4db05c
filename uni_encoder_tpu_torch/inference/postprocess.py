"""Vectorized task inference (port of `uni_encoder_tpu/inference/postprocess.py`).

  * semantic_inference: softmax(cls)[:, :-1] x sigmoid(masks), qc,qhw->chw;
  * panoptic_inference: keep-filter by class score, per-pixel argmax of
    score-weighted sigmoid masks (dropped queries at -1), per-query overlap
    filtering, first-seen stuff-class merging, sequential segment ids;
  * instance_inference: flattened top-k over Q*K class scores, mask
    binarization at logit > 0, mask-probability rescoring, boxes.

Every step is a fixed-shape tensor op; together with the upsample they make
up the plain version of the fused post-process kernel.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops import interpolate
from ..utils.misc import masks_to_boxes


def topk_lowest_index_first(x: torch.Tensor, k: int):
    """Top-k of a 1-D tensor with ties to the lowest index, as
    `jax.lax.top_k` (`torch.topk` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
    """(Q, K+1) logits, (Q, H, W) mask logits -> (K, H, W) fp32 class probabilities."""
    cls = torch.softmax(mask_cls.float(), dim=-1)[..., :-1]
    masks = torch.sigmoid(mask_pred).float()
    return torch.einsum("qc,qhw->chw", cls, masks)


def _panoptic_bookkeeping(labels, keep, mask_area, original_area, final_area, thing_mask, overlap_threshold):
    """Per-query panoptic logic shared by the unfused and fused paths:
    (seg_id, isthing, is_new_segment, assigned id per query)."""
    Q = labels.shape[0]
    K = thing_mask.shape[0]
    ratio = mask_area / torch.clamp(original_area, min=1)
    valid = keep & (mask_area > 0) & (original_area > 0) & (final_area > 0) & (ratio >= overlap_threshold)
    q_idx = torch.arange(Q, device=labels.device)
    safe_labels = torch.clamp(labels, 0, K - 1)
    isthing = thing_mask.to(labels.device)[safe_labels] & (labels != K)

    # first-seen stuff-class bookkeeping (reference stuff_memory_list)
    valid_stuff = valid & ~isthing
    same_label = labels[:, None] == labels[None, :]
    earlier = q_idx[None, :] < q_idx[:, None]  # earlier[k, j] = j < k
    exists_earlier = (valid_stuff[None, :] & same_label & earlier).any(dim=1)
    is_first_stuff = valid_stuff & ~exists_earlier

    new_segment = valid & (isthing | is_first_stuff)
    seg_id = torch.cumsum(new_segment.to(torch.int32), dim=0).to(torch.int32)  # 1-based where new
    # stuff queries inherit the id of the first valid stuff query of their class
    stuff_id = ((is_first_stuff[None, :] & same_label).to(torch.int32) * seg_id[None, :]).sum(dim=1)
    assigned = torch.where(isthing, seg_id, stuff_id.to(torch.int32)) * valid.to(torch.int32)
    return seg_id, isthing, new_segment, assigned


def panoptic_inference(
    mask_cls: torch.Tensor,  # (Q, K+1)
    mask_pred: torch.Tensor,  # (Q, H, W) logits
    thing_mask: torch.Tensor,  # (K,) bool
    object_mask_threshold: float,
    overlap_threshold: float,
) -> Dict[str, torch.Tensor]:
    """panoptic_seg (H, W) int32 plus per-query segment metadata (seg_id,
    label, isthing, is_new_segment) for host-side segments_info assembly."""
    Q, Kp1 = mask_cls.shape
    K = Kp1 - 1
    probs = torch.softmax(mask_cls.float(), dim=-1)
    scores = probs.amax(dim=-1)
    labels = probs.argmax(dim=-1)
    keep = (labels != K) & (scores > object_mask_threshold)

    # dtype-following full-resolution pipeline (bf16 stays bf16)
    sig = torch.sigmoid(mask_pred)
    prob_masks = scores.to(sig.dtype)[:, None, None] * sig
    prob_masks = torch.where(keep[:, None, None], prob_masks, torch.tensor(-1.0, dtype=sig.dtype, device=sig.device))
    ids = prob_masks.argmax(dim=0)  # (H, W) winner query per pixel, ties -> lowest

    q_idx = torch.arange(Q, device=mask_pred.device)
    win = ids[None] == q_idx[:, None, None]  # (Q, H, W)
    binm = mask_pred >= 0  # sigmoid(x) >= 0.5 <=> x >= 0
    final_mask = win & binm
    mask_area = win.sum(dim=(1, 2))
    original_area = binm.sum(dim=(1, 2))
    final_area = final_mask.sum(dim=(1, 2))

    seg_id, isthing, new_segment, assigned = _panoptic_bookkeeping(
        labels, keep, mask_area, original_area, final_area, thing_mask, overlap_threshold
    )
    panoptic_seg = (assigned[:, None, None] * final_mask.to(torch.int32)).sum(dim=0)
    return {
        "panoptic_seg": panoptic_seg.to(torch.int32),
        "seg_id": seg_id,
        "label": labels.to(torch.int32),
        "isthing": isthing,
        "is_new_segment": new_segment,
    }


def segments_info_from_arrays(pan: Dict) -> List[Dict]:
    """Host-side: convert panoptic arrays to d2-style segments_info."""
    infos = []
    seg_id = np.asarray(pan["seg_id"])
    label = np.asarray(pan["label"])
    isthing = np.asarray(pan["isthing"])
    new = np.asarray(pan["is_new_segment"])
    for k in range(len(seg_id)):
        if new[k]:
            infos.append({"id": int(seg_id[k]), "isthing": bool(isthing[k]), "category_id": int(label[k])})
    return infos


def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor, topk: int) -> Dict[str, torch.Tensor]:
    """Flattened top-k + mask rescoring. Thing-class filtering / demo
    thresholds are cheap host-side ops on the fixed-size (topk,) outputs."""
    Q, Kp1 = mask_cls.shape
    K = Kp1 - 1
    scores = torch.softmax(mask_cls.float(), dim=-1)[:, :-1]
    scores_per_image, topk_indices = topk_lowest_index_first(scores.reshape(-1), topk)
    labels_per_image = topk_indices % K
    q_indices = topk_indices // K

    masks = mask_pred[q_indices]  # (topk, H, W) logits
    bin_masks = masks > 0
    sig = torch.sigmoid(masks)
    mask_scores = torch.where(bin_masks, sig, torch.zeros_like(sig)).sum(dim=(1, 2), dtype=torch.float32) / (
        bin_masks.sum(dim=(1, 2), dtype=torch.float32) + 1e-6
    )
    return {
        "scores": scores_per_image * mask_scores,
        "labels": labels_per_image.to(torch.int32),
        "masks": bin_masks,
        "boxes": masks_to_boxes(bin_masks),
        "query_indices": q_indices.to(torch.int32),
    }


def sem_seg_postprocess(result: torch.Tensor, img_size: Tuple[int, int], output_height: int,
                        output_width: int) -> torch.Tensor:
    """d2 sem_seg_postprocess: crop the padded region, then bilinear-resize
    (align_corners=False) the channel maps (C, H, W) to the original
    resolution."""
    result = result[:, : img_size[0], : img_size[1]]
    x = result.permute(1, 2, 0)[None]  # (1, H, W, C)
    x = interpolate(x, size=(output_height, output_width), mode="bilinear", align_corners=False)
    return x[0].permute(2, 0, 1)
