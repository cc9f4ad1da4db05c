"""Torch-semantics image resampling (port of `uni_encoder_tpu/ops/resize.py`).

Bilinear (both `align_corners` settings) and nearest resizes with PyTorch's
coordinate conventions:

  * bilinear, align_corners=False: src = (dst + 0.5) * in/out - 0.5,
    clamped below at 0; upper corner index clipped to in-1.
  * bilinear, align_corners=True:  src = dst * (in-1)/(out-1).
  * nearest: src = floor(dst * in/out).

The resize is separable, y then x, and each pass computes
`x0 * (1 - w) + x1 * w` in the input dtype, as the JAX copy does.
`F.interpolate` blends both axes in one pass and rounds differently in bf16;
the fused post-process's plain version depends on this order, so the port
never calls it.

`grid_sample` (bilinear, `zeros` or `border` padding, both `align_corners`)
takes and gives NHWC tensors, as the JAX copy's does. The JAX package computes
it with XLA outside any kernel; here `F.grid_sample` computes it, and its
gradients with respect to the input and the grid (none through a clamped
`border` coordinate, as `jnp.clip`'s).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _source_coords(out_size: int, in_size: int, align_corners: bool, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (idx0, idx1, frac) for one axis with torch bilinear semantics."""
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        if out_size == 1:
            src = torch.zeros((1,), dtype=torch.float32, device=device)
        else:
            src = dst * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (dst + 0.5) * scale - 0.5
        src = torch.clamp(src, min=0.0)  # torch clamps negative source coords
    idx0 = torch.clamp(torch.floor(src).to(torch.int64), 0, in_size - 1)
    idx1 = torch.clamp(idx0 + 1, max=in_size - 1)
    frac = src - idx0.to(torch.float32)
    return idx0, idx1, frac


def _resize_axis_linear(x: torch.Tensor, axis: int, out_size: int, align_corners: bool) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    idx0, idx1, frac = _source_coords(out_size, in_size, align_corners, x.device)
    x0 = x.index_select(axis, idx0)
    x1 = x.index_select(axis, idx1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = frac.reshape(shape).to(x.dtype)
    return x0 * (1 - w) + x1 * w


def _resize_axis_nearest(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    dst = torch.arange(out_size, dtype=torch.float32, device=x.device)
    src = torch.clamp(torch.floor(dst * (in_size / out_size)).to(torch.int64), 0, in_size - 1)
    return x.index_select(axis, src)


def resize_hw(
    x: torch.Tensor,
    size: Sequence[int],
    dims: Tuple[int, int],
    mode: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize the two spatial `dims` (y, x) of `x` to `size`, y first."""
    out_h, out_w = int(size[0]), int(size[1])
    dy, dx = dims
    if mode == "bilinear":
        x = _resize_axis_linear(x, dy, out_h, align_corners)
        return _resize_axis_linear(x, dx, out_w, align_corners)
    if mode == "nearest":
        x = _resize_axis_nearest(x, dy, out_h)
        return _resize_axis_nearest(x, dx, out_w)
    raise ValueError(f"unsupported mode {mode!r}")


def interpolate(
    x: torch.Tensor,
    size: Optional[Sequence[int]] = None,
    scale_factor: Optional[float] = None,
    mode: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """`F.interpolate` equivalent for NHWC tensors (the JAX package's layout).

    x: (B, H, W, C). `size`: (out_h, out_w).
    """
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got shape {tuple(x.shape)}")
    if size is None:
        if scale_factor is None:
            raise ValueError("give size or scale_factor")
        size = (int(x.shape[1] * scale_factor), int(x.shape[2] * scale_factor))
    return resize_hw(x, size, (1, 2), mode, align_corners)


def grid_sample(
    x: torch.Tensor,
    grid: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """`F.grid_sample(mode='bilinear', padding_mode='zeros'|'border')` on NHWC.

    x: (B, H, W, C); grid: (B, Ho, Wo, 2) with normalized (gx, gy) in [-1, 1].
    Returns (B, Ho, Wo, C).
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1)
