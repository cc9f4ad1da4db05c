"""Depth / ego-motion geometry (port of `uni_encoder_tpu/geometry.py`).

Pure tensor functions: disparity <-> depth, the SE(3) pose algebra the
sequence path serves (`transformation_from_parameters`), back-projection and
projection, and the self-supervised loss terms (edge-aware smoothness, SSIM)
and depth metrics. Image tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F


def disp_to_depth(disp, min_depth: float = 0.1, max_depth: float = 100.0):
    """Sigmoid disparity -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def depth_to_disp(depth, min_depth: float = 0.1, max_depth: float = 100.0):
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    return (1.0 / depth - min_disp) / (max_disp - min_disp)


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (B, 1, 3) -> rotation as 4x4 (B, 4, 4) (Rodrigues)."""
    angle = torch.linalg.norm(vec, dim=2, keepdim=True)  # (B, 1, 1)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[:, 0, 0]
    sa = torch.sin(angle)[:, 0, 0]
    C = 1 - ca
    x, y, z = axis[:, 0, 0], axis[:, 0, 1], axis[:, 0, 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    rot = torch.zeros((vec.shape[0], 4, 4), dtype=vec.dtype, device=vec.device)
    rot[:, 0, 0] = x * xC + ca
    rot[:, 0, 1] = xyC - zs
    rot[:, 0, 2] = zxC + ys
    rot[:, 1, 0] = xyC + zs
    rot[:, 1, 1] = y * yC + ca
    rot[:, 1, 2] = yzC - xs
    rot[:, 2, 0] = zxC - ys
    rot[:, 2, 1] = yzC + xs
    rot[:, 2, 2] = z * zC + ca
    rot[:, 3, 3] = 1.0
    return rot


def get_translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """(B, 1, 3) or (B, 3) translation -> (B, 4, 4)."""
    t = t.reshape(-1, 3)
    T = torch.eye(4, dtype=t.dtype, device=t.device).repeat(t.shape[0], 1, 1)
    T[:, :3, 3] = t
    return T


def transformation_from_parameters(axisangle: torch.Tensor, translation: torch.Tensor, invert: bool = False):
    """(axisangle (B,1,3), translation (B,1,3)) -> SE(3) (B,4,4)."""
    R = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        R = R.transpose(1, 2)
        t = -t
    T = get_translation_matrix(t)
    return R @ T if invert else T @ R


def pix_coords_homogeneous(height: int, width: int, batch: int,
                           device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """(B, 3, H*W) homogeneous pixel coordinates [x; y; 1]."""
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    ones = torch.ones((height * width,), dtype=torch.float32, device=device)
    pc = torch.stack([gx.reshape(-1), gy.reshape(-1), ones], dim=0)
    return pc[None].expand(batch, 3, height * width)


def backproject_depth(depth: torch.Tensor, inv_K: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """depth (B, H, W) or (B, H, W, 1), inv_K (B, 4, 4) -> cam points (B, 4, H*W)."""
    B = depth.shape[0]
    pix = pix_coords_homogeneous(height, width, B, depth.device)
    cam = inv_K[:, :3, :3] @ pix
    cam = depth.reshape(B, 1, -1) * cam
    ones = torch.ones((B, 1, height * width), dtype=cam.dtype, device=cam.device)
    return torch.cat([cam, ones], dim=1)


def project_3d(points: torch.Tensor, K: torch.Tensor, T: Optional[torch.Tensor], height: int, width: int,
               eps: float = 1e-7):
    """points (B,4,HW), K (B,4,4), T (B,4,4)|None -> (pix_coords (B,H,W,2) in
    [-1,1], ego_motion (B,3,HW))."""
    cam3d = T @ points if T is not None else points
    cam = K[:, :3, :] @ cam3d
    pix = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    B = points.shape[0]
    pix = pix.reshape(B, 2, height, width).permute(0, 2, 3, 1)
    pix = pix / torch.tensor([width - 1, height - 1], dtype=pix.dtype, device=pix.device)
    pix = (pix - 0.5) * 2.0
    ego = cam3d[:, :3] - points[:, :3]
    return pix, ego


def compute_smooth_loss(inp: torch.Tensor, img: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Edge-aware smoothness on NHWC tensors."""
    gx = (inp[:, :, :-1, :] - inp[:, :, 1:, :]).abs()
    gy = (inp[:, :-1, :, :] - inp[:, 1:, :, :]).abs()
    if img is not None:
        igx = (img[:, :, :-1, :] - img[:, :, 1:, :]).abs().mean(dim=-1, keepdim=True)
        igy = (img[:, :-1, :, :] - img[:, 1:, :, :]).abs().mean(dim=-1, keepdim=True)
        gx = gx * torch.exp(-igx)
        gy = gy * torch.exp(-igy)
    return gx.mean() + gy.mean()


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM loss map between NHWC images: 3x3 means over reflection-padded
    inputs."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2

    def pool(z):
        z = F.pad(z.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        return F.avg_pool2d(z, 3, stride=1).permute(0, 2, 3, 1)

    mu_x, mu_y = pool(x), pool(y)
    sig_x = pool(x * x) - mu_x ** 2
    sig_y = pool(y * y) - mu_y ** 2
    sig_xy = pool(x * y) - mu_x * mu_y
    n = (2 * mu_x * mu_y + C1) * (2 * sig_xy + C2)
    d = (mu_x ** 2 + mu_y ** 2 + C1) * (sig_x + sig_y + C2)
    return torch.clamp((1 - n / d) / 2, 0, 1)


def compute_depth_errors(gt: torch.Tensor, pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The 7 standard metrics (abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3)."""
    thresh = torch.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).float().mean()
    a2 = (thresh < 1.25 ** 2).float().mean()
    a3 = (thresh < 1.25 ** 3).float().mean()
    rmse = torch.sqrt(((gt - pred) ** 2).mean())
    rmse_log = torch.sqrt(((torch.log(gt) - torch.log(pred)) ** 2).mean())
    abs_rel = ((gt - pred).abs() / gt).mean()
    sq_rel = (((gt - pred) ** 2) / gt).mean()
    return dict(abs_rel=abs_rel, sq_rel=sq_rel, rmse=rmse, rmse_log=rmse_log, a1=a1, a2=a2, a3=a3)
