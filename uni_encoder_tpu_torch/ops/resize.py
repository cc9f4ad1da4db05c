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
takes and gives NHWC tensors, as the JAX copy's does, and is written as the
JAX copy writes it: four corner gathers with their weights, clamps and
validity (one `torch.gather` of all four). Its gradient with respect to the
input is then a `scatter_add`, which has a deterministic CUDA version
(`F.grid_sample`'s backward has none); the grid's gradient flows through
the corner weights (none through a clamped `border` coordinate).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


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
    Returns (B, Ho, Wo, C): the corners (y0, x0), (y0, x0+1), (y0+1, x0),
    (y0+1, x0+1), in that order, each weighted by (x weight * y weight) *
    validity as the JAX copy weights them (the validity is folded into
    each axis's weight: the same products, since it is 0 or 1). Each axis's
    two corners are computed once, and the four are their outer product.
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    B, H, W, C = x.shape
    Ho, Wo = grid.shape[1], grid.shape[2]
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (W - 1)
        fy = (gy + 1.0) * 0.5 * (H - 1)
    else:
        fx = ((gx + 1.0) * W - 1.0) * 0.5
        fy = ((gy + 1.0) * H - 1.0) * 0.5
    if padding_mode == "border":  # torch clamps the source coordinate, so the corner weights follow
        fx = torch.clamp(fx, 0, W - 1)
        fy = torch.clamp(fy, 0, H - 1)
    step = torch.arange(2, dtype=fx.dtype, device=fx.device)  # made on the device: no host copy, no sync

    def axis(f, n):
        """(weights, clamped indices) of the two corners along one axis, (..., 2)."""
        lo = torch.floor(f)
        frac = (f - lo)[..., None]
        i = lo[..., None] + step
        wgt = torch.where(step > 0, frac, 1.0 - frac)
        if padding_mode == "zeros":
            wgt = wgt * ((i >= 0) & (i <= n - 1)).to(wgt.dtype)
        return wgt, torch.clamp(i, 0, n - 1).long()

    wx, ix = axis(fx, W)
    wy, iy = axis(fy, H)
    w = wx[..., None, :] * wy[..., :, None]  # (B, Ho, Wo, 2 (y), 2 (x))
    lin = (iy * W)[..., :, None] + ix[..., None, :]
    corners = torch.gather(x.reshape(B, H * W, C), 1, lin.reshape(B, -1, 1).expand(B, Ho * Wo * 4, C))
    return (corners.reshape(B, Ho, Wo, 4, C) * w.reshape(B, Ho, Wo, 4, 1)).sum(dim=3)
