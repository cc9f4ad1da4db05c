"""Misc tensor utilities (port of the parts of `uni_encoder_tpu/utils/misc.py`
the segmentation path uses)."""

from __future__ import annotations

import torch


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) binary -> (N, 4) xyxy with inclusive max coords
    (reference box_ops.py:106-132); empty masks give zeros."""
    N, H, W = masks.shape
    if N == 0:
        return torch.zeros((0, 4), dtype=torch.float32, device=masks.device)
    m = masks.bool()
    rows = m.any(dim=2)  # (N, H)
    cols = m.any(dim=1)  # (N, W)
    ys = torch.arange(H, dtype=torch.float32, device=masks.device)
    xs = torch.arange(W, dtype=torch.float32, device=masks.device)
    big = 1e8
    y_min = torch.where(rows, ys, big).amin(dim=1)
    x_min = torch.where(cols, xs, big).amin(dim=1)
    y_max = torch.where(rows, ys, -1.0).amax(dim=1)
    x_max = torch.where(cols, xs, -1.0).amax(dim=1)
    boxes = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return torch.where(rows.any(dim=1)[:, None], boxes, torch.zeros_like(boxes))
