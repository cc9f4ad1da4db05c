"""Misc tensor utilities (port of `uni_encoder_tpu/utils/misc.py`):
`masks_to_boxes`, `inverse_sigmoid`, the box conversions and IoUs, and the
MAE-style 2-D sin-cos position embedding."""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


# ------------------------------------------------------------------ box ops
def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 4) x (M, 4) xyxy -> IoU (N, M) and union (N, M); a zero union
    counts as 1e-9."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    iou, union = box_iou(a, b)
    lt = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


# ---------------------------------------------------- MAE-style 2D pos embed
def get_2d_sincos_pos_embed(embed_dim: int, grid_h: int, grid_w: int, cls_token: bool = False) -> np.ndarray:
    """(grid_h * grid_w [+ 1], embed_dim) float32 sin-cos table (reference
    pos_embed.py): the first half embeds the row, the second the column."""

    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gw = np.arange(grid_w, dtype=np.float32)
    gh = np.arange(grid_h, dtype=np.float32)
    grid = np.meshgrid(gw, gh)  # w goes first (reference pos_embed.py)
    emb_h = _1d(embed_dim // 2, grid[1])
    emb_w = _1d(embed_dim // 2, grid[0])
    pos = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros((1, embed_dim)), pos], axis=0)
    return pos.astype(np.float32)
