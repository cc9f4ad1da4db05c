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
(`ms_deform_attn_fused_cuda`) inside a `torch.autograd.Function` whose
backward is the hand-written kernel `kernels/csrc/ms_deform_attn_backward.cu`
(`ms_deform_attn_fused_backward_cuda`, fp32): gradients for value, offsets
and logits; `ref_abs`, a constant of the shapes, gets none. On CPU tensors it
runs the plain version, `ms_deform_attn_fused_plain`, which autograd
differentiates; that is also the backward kernel's reference.

The backward kernel is bitwise deterministic: it sums the scatter into
grad_value exactly, as 64-bit integers in units of 2**-e, where e comes from
max|grad_out| on the device by the rule in `fixed_point_shift` and
`fixed_point_exponent`, and converts the sums to fp32 once.
"""

from __future__ import annotations

import ctypes
import math
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


def _check_fused_args(value, spatial_shapes, offsets, logits, ref_abs):
    """Raise on what the fused kernels do not take; return (B, S, M, D, Lq, L, P)."""
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
    return B, S, M, D, Lq, L, P


FIXED_POINT_BITS = 62  # |sum| < 2**62 units: a bit of headroom below int64's sign bit


def fixed_point_shift(Lq: int) -> int:
    """The query-count part of the backward kernel's fixed-point scale.

    grad_value's sums are taken in units of 2**-e with
    e = fixed_point_shift(Lq) - floor(log2(max|grad_out|)). A value row gets
    at most one corner of each sample (l, p) of each query, with corner
    weight at most 1, and the attention weights of a query's samples sum to
    1, so |sum| <= Lq * max|g| < 2**(ceil(log2 Lq) + floor(log2 max|g|) + 1),
    which is at most 2**FIXED_POINT_BITS units. One unit is at most
    2**-(shift) * max|g|: 2**-47 * max|g| at Lq = 10752. The wrapper passes
    this to the kernel, which reads the exponent of max|g| on the device."""
    if Lq < 1:
        raise ValueError(f"Lq must be positive, got {Lq}")
    return FIXED_POINT_BITS - 1 - (Lq - 1).bit_length()


def fixed_point_exponent(max_abs: float, Lq: int) -> int:
    """e of the fixed-point unit 2**-e for a finite max|grad_out| > 0, as the
    kernel computes it from the float's exponent."""
    if not (0.0 < max_abs < math.inf):
        raise ValueError(f"max|grad_out| must be finite and positive, got {max_abs}")
    return fixed_point_shift(Lq) - (math.frexp(max_abs)[1] - 1)


def _shapes_arg(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(*[int(v) for hw in spatial_shapes for v in hw])


def ms_deform_attn_fused_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    offsets: torch.Tensor,
    logits: torch.Tensor,
    ref_abs: torch.Tensor,
) -> torch.Tensor:
    """Launch the fused CUDA kernel. Counts its launches in `.launches`."""
    B, S, M, D, Lq, L, P = _check_fused_args(value, spatial_shapes, offsets, logits, ref_abs)

    from ..kernels import load

    lib = load("ms_deform_attn")
    fn = lib.msda_fused_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    out = torch.empty((B, Lq, M * D), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            value.data_ptr(), offsets.data_ptr(), logits.data_ptr(), ref_abs.data_ptr(), out.data_ptr(),
            B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes), int(value.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn kernel launch failed: cudaError {rc}")
    ms_deform_attn_fused_cuda.launches += 1
    return out


ms_deform_attn_fused_cuda.launches = 0


def ms_deform_attn_fused_backward_cuda(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    offsets: torch.Tensor,
    logits: torch.Tensor,
    ref_abs: torch.Tensor,
    grad_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward CUDA kernel: (grad_value, grad_offsets,
    grad_logits) of the fused op for `grad_out` (B, Lq, M * D), all fp32 and
    bitwise the same from run to run (grad_value summed in fixed point; NaN
    everywhere if grad_out holds an inf or a NaN). One call is three CUDA
    kernels on the current stream and counts one in `.launches`."""
    B, S, M, D, Lq, L, P = _check_fused_args(value, spatial_shapes, offsets, logits, ref_abs)
    if value.dtype != torch.float32:
        raise ValueError(f"the backward kernel is built for fp32, the training dtype; got {value.dtype}")
    if tuple(grad_out.shape) != (B, Lq, M * D) or grad_out.dtype != torch.float32:
        raise ValueError(f"grad_out must be fp32 {(B, Lq, M * D)}, got {grad_out.dtype} {tuple(grad_out.shape)}")
    if grad_out.device != value.device or not grad_out.is_contiguous():
        raise ValueError(f"grad_out must be contiguous on {value.device}")

    from ..kernels import load

    lib = load("ms_deform_attn_backward")
    fn = lib.msda_fused_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    grad_value = torch.empty_like(value)
    grad_offsets = torch.empty_like(offsets)
    grad_logits = torch.empty_like(logits)
    acc = torch.zeros(value.shape, dtype=torch.int64, device=value.device)  # the fixed-point sums
    max_bits = torch.zeros((1,), dtype=torch.int32, device=value.device)  # max|grad_out|'s bits
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            value.data_ptr(), offsets.data_ptr(), logits.data_ptr(), ref_abs.data_ptr(), grad_out.data_ptr(),
            grad_value.data_ptr(), grad_offsets.data_ptr(), grad_logits.data_ptr(), acc.data_ptr(),
            max_bits.data_ptr(), B, S, M, D, Lq, L, P, _shapes_arg(spatial_shapes), fixed_point_shift(Lq), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn backward kernel launch failed: cudaError {rc}")
    ms_deform_attn_fused_backward_cuda.launches += 1
    return grad_value, grad_offsets, grad_logits


ms_deform_attn_fused_backward_cuda.launches = 0


class _FusedCuda(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, value, offsets, logits, ref_abs, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, offsets, logits, ref_abs)
        return ms_deform_attn_fused_cuda(value, spatial_shapes, offsets, logits, ref_abs)

    @staticmethod
    def backward(ctx, grad_out):
        value, offsets, logits, ref_abs = ctx.saved_tensors
        grads = ms_deform_attn_fused_backward_cuda(
            value, ctx.spatial_shapes, offsets, logits, ref_abs, grad_out.contiguous()
        )
        return grads + (None, None)


def ms_deform_attn_fused(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    offsets: torch.Tensor,
    logits: torch.Tensor,
    ref_abs: torch.Tensor,
) -> torch.Tensor:
    """The fused CUDA kernels (forward, and backward under autograd) for CUDA
    tensors, the plain version for CPU tensors."""
    if value.is_cuda:
        return _FusedCuda.apply(value, offsets, logits, ref_abs, tuple(spatial_shapes))
    return ms_deform_attn_fused_plain(value, spatial_shapes, offsets, logits, ref_abs)
