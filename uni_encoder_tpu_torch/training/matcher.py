"""Hungarian matcher for mask-classification training (port of
`uni_encoder_tpu/training/matcher.py`).

Per image, cost = class_weight * (-p_class[target]) + mask_weight *
point-sampled sigmoid-CE + dice_weight * point-sampled dice, with a NaN/Inf
guard and `BIG_COST` for invalid (padded) target slots. The costs are batched
tensor ops on the device. The assignment is scipy's `linear_sum_assignment`
on the host, where the JAX package runs optax's solver on the device:
`assign_on_host` copies a whole stack of cost matrices to the host at once
and counts its copies and assignments. The sample points are drawn by the
caller and passed in.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import grid_sample

BIG_COST = 1e8


def point_sample_per_mask(masks: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Sample mask logits (M, H, W) at per-mask normalized [0, 1] xy points
    (M, P, 2) (d2 point_sample: grid_sample(2 * p - 1, align_corners=False)).
    Returns (M, P)."""
    return grid_sample(masks[..., None], (2.0 * points - 1.0)[:, None], align_corners=False)[:, 0, :, 0]


def batch_sigmoid_ce_cost(pred_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    """(..., Q, P) logits x (..., N, P) binary -> (..., Q, N) mean-BCE cost."""
    pos = F.softplus(-pred_pts)  # -log sigmoid(x)
    neg = F.softplus(pred_pts)  # -log(1 - sigmoid(x))
    P = pred_pts.shape[-1]
    return (pos @ tgt_pts.transpose(-1, -2) + neg @ (1.0 - tgt_pts).transpose(-1, -2)) / P


def batch_dice_cost(pred_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    prob = torch.sigmoid(pred_pts)
    num = 2.0 * (prob @ tgt_pts.transpose(-1, -2))
    den = prob.sum(-1)[..., :, None] + tgt_pts.sum(-1)[..., None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


@torch.no_grad()
def match_costs(
    pred_logits: torch.Tensor,  # (B, Q, K+1)
    pred_masks: torch.Tensor,  # (B, Q, H, W) logits
    tgt_labels: torch.Tensor,  # (B, N) int
    tgt_masks: torch.Tensor,  # (B, N, H, W) {0, 1}
    tgt_valid: torch.Tensor,  # (B, N) bool
    points: torch.Tensor,  # (B, P, 2) in [0, 1]
    cost_class: float = 2.0,
    cost_mask: float = 5.0,
    cost_dice: float = 5.0,
) -> torch.Tensor:
    """The (B, N, Q) target-major assignment costs, on the device."""
    B, Q, _ = pred_logits.shape
    N = tgt_labels.shape[1]
    prob = torch.softmax(pred_logits, dim=-1)
    c_class = -prob.gather(2, tgt_labels[:, None, :].expand(B, Q, N).long())  # (B, Q, N)
    # every image's masks sampled at its points: the masks ride as channels
    grid = (2.0 * points - 1.0)[:, None]  # (B, 1, P, 2)
    # (B, Q, P) and (B, N, P), made row-major for the cost products below
    pred_pts = grid_sample(pred_masks.permute(0, 2, 3, 1), grid)[:, 0].transpose(1, 2).contiguous()
    tgt_pts = grid_sample(tgt_masks.to(pred_masks.dtype).permute(0, 2, 3, 1), grid)[:, 0].transpose(1, 2).contiguous()
    cost = (cost_mask * batch_sigmoid_ce_cost(pred_pts, tgt_pts) + cost_class * c_class
            + cost_dice * batch_dice_cost(pred_pts, tgt_pts))
    cost = torch.where(torch.isfinite(cost), cost, BIG_COST)  # NaN guard
    cost = torch.where(tgt_valid[:, None, :], cost, BIG_COST)
    return cost.transpose(1, 2)


def assign_on_host(costs: torch.Tensor) -> torch.Tensor:
    """(..., N, Q) target-major costs -> (..., N) the query assigned to each
    target, N <= Q, by `scipy.optimize.linear_sum_assignment` on the host.
    The whole stack crosses to the host in one copy. Counts the copies in
    `.copies` and the assignments solved in `.assignments`."""
    from scipy.optimize import linear_sum_assignment

    *lead, N, Q = costs.shape
    host = costs.detach().to("cpu", torch.float64).numpy().reshape(-1, N, Q)
    assign_on_host.copies += 1
    out = np.zeros(host.shape[:2], np.int64)
    for k, c in enumerate(host):
        rows, cols = linear_sum_assignment(c)
        out[k, rows] = cols
    assign_on_host.assignments += host.shape[0]
    return torch.from_numpy(out.reshape(*lead, N)).to(costs.device)


assign_on_host.copies = 0
assign_on_host.assignments = 0


def hungarian_match(pred_logits, pred_masks, tgt_labels, tgt_masks, tgt_valid, points,
                    cost_class: float = 2.0, cost_mask: float = 5.0,
                    cost_dice: float = 5.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(query_for_target (B, N), tgt_valid (B, N)): for each target slot, the
    assigned query; a padded slot's assignment means nothing."""
    costs = match_costs(pred_logits, pred_masks, tgt_labels, tgt_masks, tgt_valid, points,
                        cost_class, cost_mask, cost_dice)
    return assign_on_host(costs), tgt_valid
