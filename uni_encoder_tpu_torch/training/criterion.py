"""Set criterion for the mask-classification head (port of
`uni_encoder_tpu/training/criterion.py`).

Hungarian-matched weighted cross-entropy (no-object weight), point-sampled
mask BCE and dice with uncertainty-based importance sampling, deep
supervision over the auxiliary prediction sets (terms suffixed `_0`, `_1`,
...), and a bidirectional query-text InfoNCE with a clamped learnable logit
scale. Targets are fixed-shape: N padded slots with a validity mask; padded
slots contribute nothing. `num_masks` is the per-batch count (the JAX
trainer builds its criterion with `axis_name=None`).

In a process group (`parallel/mesh.py`) each rank holds its rows of the
global batch and computes its share of the global loss (the mean over the
ranks of the shares is the loss of the global batch): `num_masks` and the
class loss's weight sum are the global batch's, summed over the ranks and
divided by their number (d2's `num_masks / world_size`), and the
contrastive loss is the InfoNCE over the global batch, every other rank's
texts and queries among the negatives (the normalized features gathered
with gradients).

Random points are drawn by the caller (`SetCriterion.make_draws`) and passed
in, one dict per prediction set. The matcher's assignments for every
prediction set cross to the host in one copy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..parallel import mesh
from .matcher import assign_on_host, match_costs, point_sample_per_mask


def _dice_loss(pred_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    prob = torch.sigmoid(pred_pts)
    num = 2.0 * (prob * tgt_pts).sum(-1)
    den = prob.sum(-1) + tgt_pts.sum(-1)
    return 1.0 - (num + 1.0) / (den + 1.0)


def _bce_loss(pred_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    return (F.softplus(-pred_pts) * tgt_pts + F.softplus(pred_pts) * (1 - tgt_pts)).mean(-1)


def uncertainty_points(mask_logits: torch.Tensor, oversampled: torch.Tensor, uniform: torch.Tensor,
                       n_uncertain: int) -> torch.Tensor:
    """d2 get_uncertain_point_coords_with_randomness with its draws given:
    of the `oversampled` (M, n_sampled, 2) points keep the `n_uncertain`
    most uncertain (smallest |logit|) of each mask, then append `uniform`
    (M, n_random, 2). mask_logits: (M, H, W) -> (M, n_uncertain + n_random, 2)."""
    scores = -point_sample_per_mask(mask_logits, oversampled).abs()
    idx = scores.topk(n_uncertain, dim=1).indices
    top = oversampled.gather(1, idx[..., None].expand(-1, -1, 2))
    return torch.cat([top, uniform], dim=1)


class SetCriterion:
    def __init__(
        self,
        num_classes: int,
        class_weight: float = 2.0,
        mask_weight: float = 5.0,
        dice_weight: float = 5.0,
        no_object_weight: float = 0.1,
        contrastive_weight: float = 0.5,
        contrastive_temperature: float = 0.07,
        num_points: int = 12544,
        oversample_ratio: float = 3.0,
        importance_sample_ratio: float = 0.75,
        deep_supervision: bool = True,
    ):
        self.num_classes = num_classes
        self.class_weight = class_weight
        self.mask_weight = mask_weight
        self.dice_weight = dice_weight
        self.no_object_weight = no_object_weight
        self.contrastive_weight = contrastive_weight
        self.tau = contrastive_temperature
        self.num_points = num_points
        self.n_sampled = int(num_points * oversample_ratio)
        self.n_uncertain = int(importance_sample_ratio * num_points)
        self.deep_supervision = deep_supervision

    def make_draws(self, generator: torch.Generator, n_sets: int, batch: int, slots: int,
                   device: torch.device) -> List[Dict[str, torch.Tensor]]:
        """The uniform draws of `n_sets` prediction sets, in the JAX copy's
        order: per set the matcher's (B, P, 2) points, then the (B * N,
        n_sampled, 2) oversampled and (B * N, n_random, 2) uniform points of
        the mask losses. Drawn where `generator` lives, then moved."""
        M = batch * slots

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=generator.device).to(device)

        return [{"match": rand(batch, self.num_points, 2), "oversampled": rand(M, self.n_sampled, 2),
                 "uniform": rand(M, self.num_points - self.n_uncertain, 2)} for _ in range(n_sets)]

    # ------------------------------------------------------------------ losses
    def _class_targets(self, pred_logits, tgt_labels, q_for_t, tgt_valid):
        """Each query's target class (K for no object) and its CE weight
        (no_object_weight for no object)."""
        B, Q, _ = pred_logits.shape
        K = self.num_classes
        target_q = torch.full((B, Q), K, dtype=torch.int64, device=pred_logits.device)
        b_idx = torch.arange(B, device=pred_logits.device)[:, None].expand_as(q_for_t)
        target_q[b_idx[tgt_valid], q_for_t[tgt_valid]] = tgt_labels[tgt_valid].long()
        return target_q, torch.where(target_q == K, self.no_object_weight, 1.0)

    def _labels_loss(self, pred_logits, target_q, w, w_sum):
        """Weighted CE: torch CE 'mean' with class weights, the weights'
        sum `w_sum` given."""
        nll = -torch.log_softmax(pred_logits, dim=-1).gather(2, target_q[..., None])[..., 0]
        return (w * nll).sum() / w_sum

    def _masks_loss(self, draws, pred_masks, tgt_masks, q_for_t, tgt_valid, num_masks):
        B, Q, H, W = pred_masks.shape
        N = tgt_masks.shape[1]
        b_idx = torch.arange(B, device=pred_masks.device)[:, None]
        mp = pred_masks[b_idx, q_for_t.clamp(0, Q - 1)].reshape(B * N, H, W)
        mt = tgt_masks.reshape(B * N, *tgt_masks.shape[2:]).to(mp.dtype)
        valid = tgt_valid.reshape(B * N).to(mp.dtype)
        pts = uncertainty_points(mp.detach(), draws["oversampled"], draws["uniform"], self.n_uncertain)
        pred_pts = point_sample_per_mask(mp, pts)
        tgt_pts = point_sample_per_mask(mt, pts)
        bce = (_bce_loss(pred_pts, tgt_pts) * valid).sum() / num_masks
        dice = (_dice_loss(pred_pts, tgt_pts) * valid).sum() / num_masks
        return bce, dice

    def contrastive_loss(self, query_feats: torch.Tensor, text_feats: torch.Tensor,
                         logit_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Bidirectional InfoNCE across the batch between each image's
        flattened, L2-normalized query features and text features. In a
        process group: over the global batch, this rank's rows (query to
        text) and columns (text to query) of its logits."""
        b = query_feats.shape[0]
        q = query_feats.reshape(b, -1)
        t = text_feats.reshape(b, -1)
        q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-8)
        t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-8)
        scale = 1.0 / self.tau if logit_scale is None else torch.clamp(torch.exp(logit_scale), max=100.0)
        # the targets are the diagonal: -log_softmax picked there, as the
        # class loss does (F.cross_entropy's NLLLoss has no deterministic
        # CUDA version)
        q_all, t_all = mesh.all_gather(torch.cat([q, t], dim=1)).split([q.shape[1], t.shape[1]], dim=1)
        mine = torch.arange(b, device=q.device)
        theirs = mesh.rank() * b + mine
        l_qt = -torch.log_softmax(q @ t_all.T * scale, dim=1)[mine, theirs].mean()
        l_tq = -torch.log_softmax(q_all @ t.T * scale, dim=0)[theirs, mine].mean()
        return l_qt + l_tq

    # ------------------------------------------------------------------ main
    def __call__(self, outputs: Dict, targets: Dict, draws: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """targets: labels (B, N), masks (B, N, H, W) at the pred_masks
        resolution, valid (B, N), and optionally text_feats and logit_scale.
        draws: `make_draws` for every prediction set (the final one, then
        the auxiliary ones under deep supervision)."""
        tgt_labels, tgt_masks, tgt_valid = targets["labels"], targets["masks"], targets["valid"]
        layers = [outputs] + (list(outputs.get("aux_outputs", [])) if self.deep_supervision else [])
        if len(draws) != len(layers):
            raise ValueError(f"{len(draws)} draws for {len(layers)} prediction sets")

        # every set's matching costs, then one copy to the host for all
        costs = torch.stack([
            match_costs(lo["pred_logits"].detach(), lo["pred_masks"].detach(), tgt_labels, tgt_masks, tgt_valid,
                        d["match"], self.class_weight, self.mask_weight, self.dice_weight)
            for lo, d in zip(layers, draws)
        ])
        q_for_t = assign_on_host(costs)  # (sets, B, N)

        # the normalizers: the batch's valid targets, and per set the class
        # weights' sum; in a process group the global batch's over the
        # number of ranks, in one all-reduce
        classes = [self._class_targets(lo["pred_logits"], tgt_labels, q_for_t[li], tgt_valid)
                   for li, lo in enumerate(layers)]
        norms = mesh.all_reduce_sum(torch.stack([tgt_valid.sum().to(torch.float32)] + [w.sum() for _, w in classes]))
        num_masks = torch.clamp(norms[0], min=1.0) / mesh.world()
        w_sums = norms[1:] / mesh.world()

        losses = {}
        total = 0.0
        for li, (layer_out, d) in enumerate(zip(layers, draws)):
            l_ce = self._labels_loss(layer_out["pred_logits"], *classes[li], w_sums[li])
            l_bce, l_dice = self._masks_loss(d, layer_out["pred_masks"], tgt_masks, q_for_t[li], tgt_valid,
                                             num_masks)
            tag = "" if li == 0 else f"_{li - 1}"
            losses[f"loss_ce{tag}"] = self.class_weight * l_ce
            losses[f"loss_mask{tag}"] = self.mask_weight * l_bce
            losses[f"loss_dice{tag}"] = self.dice_weight * l_dice
            total = total + losses[f"loss_ce{tag}"] + losses[f"loss_mask{tag}"] + losses[f"loss_dice{tag}"]

        if outputs.get("contrastive_logits") is not None and "text_feats" in targets:
            l_con = self.contrastive_loss(outputs["contrastive_logits"], targets["text_feats"],
                                          targets.get("logit_scale"))
            losses["loss_contrastive"] = self.contrastive_weight * l_con
            total = total + losses["loss_contrastive"]

        losses["loss_total"] = total
        return losses
