"""Multi-scale deformable-attention sampling (port of
`uni_encoder_tpu/ops/ms_deform_attn.py` and of the producer half of
`MSDeformAttnModule` in `uni_encoder_tpu/models/pixel_decoders/msdeformattn.py`).

The sampling core, `ms_deform_attn_plain` (the query-major form of the JAX
`layout="cm_abs"` path):

  value:              (B, S, M, D)        bf16 or fp32, S = sum(H_l * W_l)
  spatial_shapes:     static ((H_0, W_0), ...)
  sampling_locations: (B, Lq, M, L, P, 2) fp32 ABSOLUTE source coords (fx, fy),
                      i.e. grid_sample's loc * (W, H) - 0.5 already applied
  attention_weights:  (B, Lq, M, L, P)    fp32, softmax-normalised
  returns:            (B, Lq, M * D)      value dtype

Semantics are those of JAX `ms_deform_attn_corners`: bilinear, zero padding
outside the map, fp32 accumulation, one rounding to the value dtype.

The fused op, `ms_deform_attn_fused`, takes the module's raw Linear outputs
instead of locations and weights:

  offsets:  (B, Lq, M * L * P * 2)  the sampling_offsets output, value dtype
  logits:   (B, Lq, M * L * P)      the attention_weights output, value dtype
  ref_abs:  (L, Lq, 2)              fp32 absolute reference points

and computes `sampling_inputs` (softmax over each head's L * P logits,
rounded to the logits' dtype as torch.softmax returns it, then
`ref_abs + offset` in fp32) followed by the sampling core. On CUDA tensors
it runs the hand-written kernel `kernels/csrc/ms_deform_attn.cu`
(`ms_deform_attn_fused_cuda`); on CPU tensors its plain version,
`ms_deform_attn_fused_plain`.
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
    """Plain PyTorch sampling core: four corner gathers per level, summed in fp32."""
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


def sampling_inputs(offsets: torch.Tensor, logits: torch.Tensor, ref_abs: torch.Tensor, n_heads: int):
    """The plain producer: (locations (B, Lq, M, L, P, 2) fp32 absolute,
    weights (B, Lq, M, L, P) fp32) from the raw Linear outputs."""
    B, Lq, _ = offsets.shape
    L = ref_abs.shape[0]
    P = logits.shape[-1] // (n_heads * L)
    off = offsets.view(B, Lq, n_heads, L, P, 2)
    w = logits.view(B, Lq, n_heads, L * P)
    w = torch.softmax(w, dim=-1).view(B, Lq, n_heads, L, P).float()
    loc = ref_abs.permute(1, 0, 2)[None, :, None, :, None, :] + off.float()
    return loc, w


def ms_deform_attn_fused_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    offsets: torch.Tensor,
    logits: torch.Tensor,
    ref_abs: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the fused kernel: `sampling_inputs`, then the core."""
    loc, w = sampling_inputs(offsets, logits, ref_abs, value.shape[2])
    return ms_deform_attn_plain(value, spatial_shapes, loc, w)


def ms_deform_attn_fused_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    offsets: torch.Tensor,
    logits: torch.Tensor,
    ref_abs: torch.Tensor,
) -> torch.Tensor:
    """Launch the fused CUDA kernel. Counts its launches in `.launches`."""
    if value.ndim != 4 or offsets.ndim != 3 or logits.ndim != 3 or ref_abs.ndim != 3:
        raise ValueError("expected value (B, S, M, D), offsets and logits (B, Lq, .), ref_abs (L, Lq, 2)")
    B, S, M, D = value.shape
    L, Lq = ref_abs.shape[0], ref_abs.shape[1]
    P = logits.shape[-1] // max(M * L, 1)
    if (L, P) != (3, 4):
        raise ValueError(f"the kernel is built for 3 levels and 4 points, got L={L}, P={P}")
    if D % 2:
        raise ValueError(f"the kernel reads channel pairs: D must be even, got {D}")
    if tuple(ref_abs.shape) != (L, Lq, 2):
        raise ValueError(f"ref_abs shape {tuple(ref_abs.shape)} != {(L, Lq, 2)}")
    if tuple(logits.shape) != (B, Lq, M * L * P):
        raise ValueError(f"logits shape {tuple(logits.shape)} != {(B, Lq, M * L * P)}")
    if tuple(offsets.shape) != (B, Lq, M * L * P * 2):
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != {(B, Lq, M * L * P * 2)}")
    if len(spatial_shapes) != L or sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match value {tuple(value.shape)} / L={L}")
    for t, name in ((value, "value"), (offsets, "offsets"), (logits, "logits"), (ref_abs, "ref_abs")):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"value must be bf16 or fp32, got {value.dtype}")
    if offsets.dtype != value.dtype or logits.dtype != value.dtype:
        raise ValueError(f"offsets and logits must be {value.dtype} like value, got {offsets.dtype}, {logits.dtype}")
    if ref_abs.dtype != torch.float32:
        raise ValueError(f"ref_abs must be fp32, got {ref_abs.dtype}")
    if max(value.numel(), offsets.numel(), B * Lq * M * D, B * Lq * M * 16) >= 2**31:
        raise ValueError("the kernel indexes with 32-bit offsets; split the batch")

    from ..kernels import load

    lib = load("ms_deform_attn")
    fn = lib.msda_fused_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    shapes = (ctypes.c_int * (2 * L))(*[int(v) for hw in spatial_shapes for v in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            value.data_ptr(), offsets.data_ptr(), logits.data_ptr(), ref_abs.data_ptr(), out.data_ptr(),
            B, S, M, D, Lq, L, P, shapes, int(value.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn kernel launch failed: cudaError {rc}")
    ms_deform_attn_fused_cuda.launches += 1
    return out


ms_deform_attn_fused_cuda.launches = 0


def ms_deform_attn_fused(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    offsets: torch.Tensor,
    logits: torch.Tensor,
    ref_abs: torch.Tensor,
) -> torch.Tensor:
    """The fused CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if value.is_cuda:
        return ms_deform_attn_fused_cuda(value, spatial_shapes, offsets, logits, ref_abs)
    return ms_deform_attn_fused_plain(value, spatial_shapes, offsets, logits, ref_abs)
