"""Self-supervised depth / ego-motion / object-motion training loss (port of
`uni_encoder_tpu/training/monodepth.py`).

Seven weighted terms over the decoder's scales:
  p_photo        (1.0)   min-reprojection photometric (0.85 SSIM + 0.15 L1)
                         with identity automasking and a noise tie-break
  d_smooth       (1e-3)  edge-aware mean-normalized disparity smoothness
  d_ground       (0.1)   disparity below the RANSAC ground plane
  c_smooth       (1e-3)  edge-aware complete-3D-flow smoothness
  c_consistency  (5.0)   |residual flow| outside the motion mask
  m_sparsity     (0.04)  BCE(motion_prob, 0) on quasi-static pixels
  m_smooth       (0.1)   edge-aware motion-mask smoothness
with a linear ramp on the last four (clip(3 * step / 35000, 0, 1)) and the
total averaged over scales.

In a process group (`parallel/mesh.py`) each rank holds its rows of the
global batch. Every term but m_sparsity is a mean over the images, pixels
or points of equal local shapes, so the mean over the ranks of their terms
is the global batch's; m_sparsity's static threshold (a mean over the
batch's pixels per frame), its count of static pixels and its `all` over
the batch are the global batch's, summed over the ranks.

Each scale is its disparity's size: the motion decoders emit scale s at
stride 2^s, as TransDSSL emits its disparity, while DCMNet's disparity of
scale s comes at stride 2^(s+1) and the DepthTransformerEncoder and
DepthMSDeformAttn decoders' at 2^(s+2). The loss first resizes each scale's
complete flow, motion mask and motion probability (bilinear) to that
scale's disparity; then it is the JAX copy's. Where the sizes agree
(TransDSSL) nothing is resized and the loss is the JAX copy's as it
stands; where they differ the JAX copy fails (it multiplies maps of both
sizes), so the port departs from it there, and its tests hold it against
the JAX loss given the resized maps.

The photometric warp runs batched over (frame, scale, batch) at full
resolution. The RANSAC ground plane fits every candidate plane of a scale at
once (batched 3x3 `torch.linalg.inv`). The identity noise and the RANSAC
sample indices are drawn by the caller (`make_draws`) and passed in.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..geometry import (
    backproject_depth,
    compute_smooth_loss,
    depth_to_disp,
    disp_to_depth,
    pix_coords_homogeneous,
    project_3d,
    ssim,
)
from ..ops import grid_sample, interpolate
from ..parallel import mesh

COEFS = {
    "p_photo": 1.0,
    "d_smooth": 1e-3,
    "d_ground": 0.1,
    "c_smooth": 1e-3,
    "c_consistency": 5.0,
    "m_sparsity": 0.04,
    "m_smooth": 0.1,
}
RAMPED = ("c_smooth", "c_consistency", "m_sparsity", "m_smooth")
RANSAC_ITERS = 100
RANSAC_POINTS = 5
RANSAC_TOL = 0.005
GROUND_PRIOR = 0.4  # the lowest 40% of the rows hold the candidate ground points
MOTION_KEYS = ("complete_flow", "motion_mask", "motion_prob")  # the motion decoders' per-scale maps


def ground_rows(h: int) -> int:
    return int(GROUND_PRIOR * h)


def make_draws(generator: torch.Generator, batch: int, height: int, width: int,
               scale_sizes: Sequence[Tuple[int, int]], n_frames: int, device: torch.device) -> Dict[str, List]:
    """The draws of one loss, in the JAX copy's order: per scale the
    identity noise (B, H, W, F) ~ N(0, 1), then the RANSAC sample indices
    (B, 100, 5) into that scale's ground points. Drawn where `generator`
    lives, then moved."""
    kw = dict(generator=generator, device=generator.device)
    noise, idx, n_ground = [], [], []
    for h, w in scale_sizes:
        noise.append(torch.randn((batch, height, width, n_frames), **kw).to(device))
        n = ground_rows(h) * w
        idx.append(torch.randint(0, n, (batch, RANSAC_ITERS, RANSAC_POINTS), **kw).to(device))
        n_ground.append(n)
    return {"noise": noise, "ransac_idx": idx, "n_ground": n_ground}


# ----------------------------------------------------------------- ground plane
def _plane_lstsq(pts: torch.Tensor) -> torch.Tensor:
    """pts: (..., n, 3) -> plane params (..., 3, 1) solving y = w1*x + w2*z + w3
    (the 1e-6 is added to every entry of A^T A, as the JAX copy does)."""
    y = pts[..., 1:2]
    A = torch.cat([pts[..., 0:1], pts[..., 2:3], torch.ones_like(y)], dim=-1)
    At = A.transpose(-1, -2)
    return torch.linalg.inv(At @ A + 1e-6) @ (At @ y)


@torch.no_grad()
def ransac_ground_plane(points: torch.Tensor, idx: torch.Tensor, tol: float = RANSAC_TOL) -> torch.Tensor:
    """points (B, N, 3) candidate ground points, idx (B, it, n) sample
    indices -> the plane (B, 3, 1) of the fit with the most inliers (the
    first such, as jnp.argmax), no grad."""
    B = points.shape[0]
    samples = points[torch.arange(B, device=points.device)[:, None, None], idx]  # (B, it, n, 3)
    ws = _plane_lstsq(samples)  # (B, it, 3, 1)
    y = points[..., 1:2]
    A = torch.cat([points[..., 0:1], points[..., 2:3], torch.ones_like(y)], dim=-1)
    dist = A[:, None] @ ws - y[:, None]  # (B, it, N, 1)
    inlier_frac = (dist[..., 0].abs() < tol).float().mean(-1)  # (B, it)
    return ws[torch.arange(B, device=points.device), inlier_frac.argmax(dim=1)]


def _ground_term(idx, disp_s, inv_K, h, w):
    """d_ground for one scale: disparity below the estimated ground plane."""
    B = disp_s.shape[0]
    _, depth = disp_to_depth(disp_s[..., 0])  # (B, h, w)
    pts = backproject_depth(depth, inv_K, h, w)[:, :3].transpose(1, 2)  # (B, hw, 3)
    ground_pts = pts.reshape(B, h, w, 3)[:, -ground_rows(h):].reshape(B, -1, 3)
    w_best = ransac_ground_plane(ground_pts.detach(), idx)

    w1, w2, w3 = w_best[:, 0], w_best[:, 1], w_best[:, 2] + RANSAC_TOL  # plane_param4diff: w3 += tol
    rays = inv_K[:, :3, :3] @ pix_coords_homogeneous(h, w, B, disp_s.device)  # (B, 3, hw)
    vx, vy, vz = rays[:, 0], rays[:, 1], rays[:, 2]
    ground_depth = w3 / (vy - vx * w1 - vz * w2 + 1e-12)
    invalid = (ground_depth < 0) | (ground_depth > 100)
    ground_depth = torch.where(invalid, 100.0, ground_depth)
    ground_disp = depth_to_disp(ground_depth).reshape(B, h, w)
    diff = disp_s[..., 0] - ground_disp
    diff = torch.where(invalid.reshape(B, h, w), 0.0, diff)
    return -torch.clamp(diff, max=0.0).mean()  # only penalize below ground


def _reprojection_loss(pred, target):
    l1 = (target - pred).abs().mean(-1, keepdim=True)
    s = ssim(pred, target).mean(-1, keepdim=True)
    return 0.85 * s + 0.15 * l1  # (B, H, W, 1)


def _up(x, H, W):
    return interpolate(x, size=(H, W), mode="bilinear", align_corners=False)


def _at_size(x, hw):
    """`x` (B, h, w, C) resized to `hw` (bilinear), or as it is at that size."""
    return x if tuple(x.shape[1:3]) == tuple(hw) else interpolate(x, size=hw, mode="bilinear", align_corners=False)


def monodepth_loss(
    outputs: Dict,
    targets: Dict,
    step: int,
    draws: Dict[str, List],
    frame_ids: Sequence[int] = (-1, 1),
    ramp_steps: int = 35000,
    mask_disp_threshold: float = 0.03,
) -> Dict[str, torch.Tensor]:
    """
    outputs (UniEncoder.forward_sequence_train):
      disps:          {scale: (B, h_s, w_s, 1)} sigmoid disparity (scale 0 the finest)
      cam_T_cam:      {frame_id: (B, 4, 4)}
      complete_flow:  {(frame_id, scale): (B, H / 2^s, W / 2^s, 3)}
      motion_mask:    {(frame_id, scale): (B, H / 2^s, W / 2^s, 1)} sigmoid
      motion_prob:    {(frame_id, scale): (B, H / 2^s, W / 2^s, 1)}
      (the three resized to (h_s, w_s) where they differ)
    targets:
      color:          {frame_id (incl. 0): (B, H, W, 3)} photometric frames
      K, inv_K:       (B, 4, 4)
    draws: `make_draws` for these scale sizes and len(frame_ids) frames.
    """
    color0 = targets["color"][0]
    B, H, W, _ = color0.shape
    K, inv_K = targets["K"], targets["inv_K"]
    S = len(outputs["disps"])
    Fn = len(frame_ids)
    sizes = [tuple(outputs["disps"][s].shape[1:3]) for s in range(S)]
    if draws["n_ground"] != [ground_rows(h) * w for h, w in sizes]:
        raise ValueError(f"draws made for ground-point counts {draws['n_ground']}, the scales are {sizes}")
    outputs = dict(outputs, **{key: {(f, s): _at_size(x, sizes[s]) for (f, s), x in outputs[key].items()}
                               for key in MOTION_KEYS})

    ramp = min(max(3.0 * float(step) / ramp_steps, 0.0), 1.0)
    coefs = {k: (v * ramp if k in RAMPED else v) for k, v in COEFS.items()}

    # ---------------------------------------------------------------- warping
    # every (frame, scale) pair at full (H, W), batched along one axis
    # ordered (F, S, B)
    disp_full = torch.stack([_up(outputs["disps"][s], H, W) for s in range(S)])  # (S, B, H, W, 1)
    _, depth = disp_to_depth(disp_full[..., 0].reshape(S * B, H, W))
    cam_points = backproject_depth(depth, inv_K.repeat(S, 1, 1), H, W)  # (SB, 4, HW)

    cam_f = cam_points.repeat(Fn, 1, 1)  # (FSB, 4, HW)
    K_f = K.repeat(Fn * S, 1, 1)
    T_f = torch.cat([outputs["cam_T_cam"][f].repeat(S, 1, 1) for f in frame_ids], dim=0)
    sample_ego, ego_flow = project_3d(cam_f, K_f, T_f, H, W)  # (FSB, H, W, 2), (FSB, 3, HW)

    def up_full(key, ch):
        # outputs[key][(f, s)]: (B, h_s, w_s, ch) -> (F, S, B, H, W, ch)
        return torch.stack([
            _up(torch.cat([outputs[key][(f, s)] for f in frame_ids], dim=0), H, W).reshape(Fn, B, H, W, ch)
            for s in range(S)
        ], dim=1)

    cflow_flat = up_full("complete_flow", 3).reshape(Fn * S * B, H * W, 3).transpose(1, 2)  # (FSB, 3, HW)
    mask_full = up_full("motion_mask", 1).reshape(Fn * S * B, 1, H * W)
    residual = cflow_flat - ego_flow
    independ = residual * mask_full

    with torch.no_grad():  # the detached complete-flow sample
        cp_tmp = torch.cat([cam_f[:, :3] + cflow_flat, cam_f[:, 3:]], dim=1)
        sample_complete = project_3d(cp_tmp, K_f, None, H, W)[0]
    sample_ego_d = sample_ego.detach()

    sample, _ = project_3d(torch.cat([cam_f[:, :3] + independ, cam_f[:, 3:]], dim=1), K_f, T_f, H, W)

    src_stack = torch.cat([targets["color"][f] for f in frame_ids], dim=0)  # (FB, H, W, 3)
    src_f = torch.cat([targets["color"][f].repeat(S, 1, 1, 1) for f in frame_ids], dim=0)  # (FSB, H, W, 3)
    warped = grid_sample(src_f, sample, align_corners=True, padding_mode="border")
    reproj = _reprojection_loss(warped, color0.repeat(Fn * S, 1, 1, 1))[..., 0].reshape(Fn, S, B, H, W)
    identity = _reprojection_loss(src_stack, color0.repeat(Fn, 1, 1, 1))[..., 0].reshape(Fn, 1, B, H, W)

    noise = torch.stack(draws["noise"], dim=0).permute(4, 0, 1, 2, 3) * 1e-5  # (S,B,H,W,F) -> (F,S,B,H,W)
    combined = torch.cat([identity + noise, reproj], dim=0)  # (2F, S, B, H, W)
    p_photo_s = combined.min(dim=0).values.mean(dim=(1, 2, 3))  # (S,)

    residual_img = residual.transpose(1, 2).reshape(Fn, S, B, H, W, 3)
    sample_ego_fs = sample_ego_d.reshape(Fn, S, B, H, W, 2)
    sample_complete_fs = sample_complete.reshape(Fn, S, B, H, W, 2)

    # ------------------------------------------------- per-scale regularizers
    losses = {k: 0.0 for k in COEFS}
    total = 0.0
    for scale in range(S):
        disp_s = outputs["disps"][scale]
        h, w = sizes[scale]
        div = 2 ** scale
        color_s = interpolate(color0, size=(h, w), mode="bilinear", align_corners=False)
        color_sf = color_s.repeat(Fn, 1, 1, 1)

        ps = {"p_photo": p_photo_s[scale]}
        norm_disp = disp_s / (disp_s.mean(dim=(1, 2), keepdim=True) + 1e-7)
        ps["d_smooth"] = compute_smooth_loss(norm_disp, color_s) / div
        ps["d_ground"] = _ground_term(draws["ransac_idx"][scale], disp_s, inv_K, h, w) / div

        # motion regularization, frames stacked along the batch
        mask_s = torch.cat([outputs["motion_mask"][(f, scale)] for f in frame_ids], dim=0)
        prob_s = torch.cat([outputs["motion_prob"][(f, scale)] for f in frame_ids], dim=0)
        cflow_s = torch.cat([outputs["complete_flow"][(f, scale)] for f in frame_ids], dim=0)
        residual_s = interpolate(residual_img[:, scale].reshape(Fn * B, H, W, 3), size=(h, w),
                                 mode="bilinear", align_corners=False)
        ps["c_smooth"] = compute_smooth_loss(cflow_s, color_sf) / div

        valid_disp = (disp_s.repeat(Fn, 1, 1, 1) > mask_disp_threshold).to(disp_s.dtype)
        ps["c_consistency"] = torch.mean(valid_disp * (1 - mask_s.detach()) * residual_s.abs()) / div

        se = interpolate(sample_ego_fs[:, scale].reshape(Fn * B, H, W, 2), size=(h, w),
                         mode="bilinear", align_corners=False)
        sc = interpolate(sample_complete_fs[:, scale].reshape(Fn * B, H, W, 2), size=(h, w),
                         mode="bilinear", align_corners=False)
        disp_mag = ((se - sc) ** 2).sum(dim=-1).reshape(Fn, B, h, w)
        # BCEWithLogits(prob, 0) == softplus(prob); masked mean over static pixels
        bce_map = F.softplus(prob_s[..., 0]).reshape(Fn, B, h, w)
        # the global batch's per-frame threshold, static count and `all`
        # (over the data group: under tensor parallelism a model group's
        # ranks hold the same rows)
        data = mesh.data_group()
        mean_mag = mesh.all_reduce_sum(disp_mag.sum(dim=(1, 2, 3)), data) / (mesh.data_world() * B * h * w)
        static = (disp_mag < mean_mag[:, None, None, None]).to(disp_s.dtype)
        counts = mesh.all_reduce_sum(torch.cat([static.sum(dim=(1, 2, 3)),
                                                (static.sum(dim=(2, 3)) == 0).sum(dim=1).to(static.dtype)]), data)
        n_static, all_have_static = counts[:Fn], counts[Fn:] == 0  # (F,) each
        # this rank's share: the mean over the ranks of the shares is the global masked mean
        bce = (bce_map * static).sum(dim=(1, 2, 3)) / (n_static.clamp(min=1) / mesh.data_world())
        ps["m_sparsity"] = torch.where(all_have_static, 3.0 * bce, 0.0).mean() / div

        ps["m_smooth"] = compute_smooth_loss(mask_s, color_sf) / div

        scale_total = 0.0
        for k in COEFS:
            scale_total = scale_total + ps[k] * coefs[k]
            losses[k] = losses[k] + ps[k]
        total = total + scale_total / S  # the reference divides by num_scales

    out = {f"monodepth/{k}": v for k, v in losses.items()}
    out["loss_monodepth"] = total
    return out
