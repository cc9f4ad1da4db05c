"""Multi-scale deformable-attention sampling (port of
`uni_encoder_tpu/ops/ms_deform_attn.py`).

Contract (the query-major form of the JAX `layout="cm_abs"` path):

  value:              (B, S, M, D)        bf16 or fp32, S = sum(H_l * W_l)
  spatial_shapes:     static ((H_0, W_0), ...)
  sampling_locations: (B, Lq, M, L, P, 2) fp32 ABSOLUTE source coords (fx, fy),
                      i.e. grid_sample's loc * (W, H) - 0.5 already applied
  attention_weights:  (B, Lq, M, L, P)    fp32, softmax-normalised
  returns:            (B, Lq, M * D)      value dtype

Semantics are those of JAX `ms_deform_attn_corners`: bilinear, zero padding
outside the map, fp32 accumulation, one rounding to the value dtype.

`ms_deform_attn` runs the hand-written CUDA kernel
(`kernels/csrc/ms_deform_attn.cu`) on CUDA tensors and the plain version,
`ms_deform_attn_plain`, on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: four corner gathers per level, summed in fp32."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if len(spatial_shapes) != L or sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match value {tuple(value.shape)} / L={L}")
    orig_dtype = value.dtype
    value = value.float()
    loc = sampling_locations.float()
    attw = attention_weights.float()

    out = torch.zeros((B, M, Lq, D), dtype=torch.float32, device=value.device)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v = value[:, start : start + H * W].permute(0, 2, 1, 3)  # (B, M, HW, D)
        start += H * W
        fx = loc[:, :, :, lvl, :, 0].permute(0, 2, 1, 3)  # (B, M, Lq, P)
        fy = loc[:, :, :, lvl, :, 1].permute(0, 2, 1, 3)
        w_l = attw[:, :, :, lvl].permute(0, 2, 1, 3)
        x0 = torch.floor(fx)
        y0 = torch.floor(fy)
        wx = fx - x0
        wy = fy - y0
        acc = torch.zeros((B, M, Lq, D), dtype=torch.float32, device=value.device)
        for dy, wgt_y in ((0.0, 1.0 - wy), (1.0, wy)):
            for dx, wgt_x in ((0.0, 1.0 - wx), (1.0, wx)):
                xi = x0 + dx
                yi = y0 + dy
                valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
                xi_c = torch.clamp(xi, 0, W - 1).to(torch.int64)
                yi_c = torch.clamp(yi, 0, H - 1).to(torch.int64)
                lin = (yi_c * W + xi_c).reshape(B, M, Lq * P, 1).expand(B, M, Lq * P, D)
                g = torch.gather(v, 2, lin).reshape(B, M, Lq, P, D)
                wgt = (wgt_x * wgt_y * valid.float() * w_l)[..., None]
                acc = acc + (g * wgt).sum(dim=3)
        out = out + acc
    return out.permute(0, 2, 1, 3).reshape(B, Lq, M * D).to(orig_dtype)


def ms_deform_attn_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel. Counts its launches in `.launches`."""
    B, S, M, D = value.shape
    if sampling_locations.ndim != 6 or attention_weights.ndim != 5:
        raise ValueError("expected locations (B, Lq, M, L, P, 2) and weights (B, Lq, M, L, P)")
    Lq, L, P = sampling_locations.shape[1], sampling_locations.shape[3], sampling_locations.shape[4]
    if tuple(sampling_locations.shape) != (B, Lq, M, L, P, 2):
        raise ValueError(f"locations shape {tuple(sampling_locations.shape)} != {(B, Lq, M, L, P, 2)}")
    if tuple(attention_weights.shape) != (B, Lq, M, L, P):
        raise ValueError(f"weights shape {tuple(attention_weights.shape)} != {(B, Lq, M, L, P)}")
    if len(spatial_shapes) != L or sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match value {tuple(value.shape)} / L={L}")
    if not 1 <= L <= 8:
        raise ValueError(f"the kernel takes 1..8 levels, got {L}")
    for t, name in ((value, "value"), (sampling_locations, "locations"), (attention_weights, "weights")):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"value must be bf16 or fp32, got {value.dtype}")
    if sampling_locations.dtype != torch.float32 or attention_weights.dtype != torch.float32:
        raise ValueError("locations and weights must be fp32")

    from ..kernels import load

    lib = load("ms_deform_attn")
    fn = lib.msda_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * L))(*[int(v) for hw in spatial_shapes for v in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(), out.data_ptr(),
            B, S, M, D, Lq, L, P, shapes, int(value.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn kernel launch failed: cudaError {rc}")
    ms_deform_attn_cuda.launches += 1
    return out


ms_deform_attn_cuda.launches = 0


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if value.is_cuda:
        return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations, attention_weights)
    return ms_deform_attn_plain(value, spatial_shapes, sampling_locations, attention_weights)
