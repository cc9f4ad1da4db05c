"""(Dilated) neighborhood attention (port of
`uni_encoder_tpu/ops/neighborhood_attention.py`, which replaced the NATTEN
CUDA library of the reference's DiNAT backbone).

Semantics (NATTEN's, as the JAX package states them): each query (i, j)
attends to a k x k window of keys on the dilation-d sub-grid of its residue
class (i mod d, j mod d). The window is clamped inside the map: it slides
inward at the borders and never pads. Where a sub-grid is shorter than the
kernel (`sub_len < kernel`), the clamped window repeats the sub-grid's last
index, so that key enters the softmax several times, each time with the same
bias. A relative-position bias `rpb[head, rel_h, rel_w]`, indexed by the
clamped sub-grid offset, is added to each logit.

  q, k, v: (B, H, W, heads, dh)  bf16 or fp32; may be strided views of the
                                 qkv projection's (B, H, W, 3, heads, dh)
                                 output (the last dim contiguous)
  rpb:     (heads, 2k-1, 2k-1)   the same dtype
  scale:   q is multiplied by it in its own dtype first (the module's
           `q * dh ** -0.5`); 1.0 for a pre-scaled q, as the JAX op takes it
  returns: (B, H, W, heads, dh)  contiguous, the input dtype

`neighborhood_attention_2d_plain` is the plain version: the JAX op's loop
over the k*k window offsets, with index tensors, the logits, the softmax and
the weighted sum of values all in fp32 and one rounding to the input dtype
(the JAX op sums the values in the input dtype). On CUDA tensors
`neighborhood_attention_2d` runs the hand-written kernel K4,
`kernels/csrc/neighborhood_attention.cu` (`neighborhood_attention_2d_cuda`),
which has no backward: it raises when autograd would need one. K4 works on
tiles of one residue class's sub-grid and the halo of keys their windows
cover, each key once, weighted by how often a window repeats it;
`_tile_halo` is that arithmetic in Python, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

# the head dim the kernel is built for: every DiNAT-L stage's
KERNEL_HEAD_DIM = 32


@functools.lru_cache(maxsize=128)
def _axis_indices(size: int, kernel: int, dilation: int) -> Tuple[np.ndarray, np.ndarray]:
    """(idx, rel): idx[i, a] is the absolute position of the a-th window
    element of query i along one axis, rel[i, a] its bias index in
    [0, 2k-2] (the JAX package's `_axis_indices`)."""
    r = kernel // 2
    idx = np.zeros((size, kernel), np.int64)
    rel = np.zeros((size, kernel), np.int64)
    for i in range(size):
        m = i % dilation
        q = i // dilation
        sub_len = (size - m + dilation - 1) // dilation
        start = min(max(q - r, 0), max(sub_len - kernel, 0))
        for a in range(kernel):
            sub = min(start + a, sub_len - 1)
            idx[i, a] = sub * dilation + m
            rel[i, a] = sub - q + (kernel - 1)
    return idx, rel


# K4's tile: KERNEL_TILE x KERNEL_TILE queries of one residue class's sub-grid
KERNEL_TILE = 8


def _window_start(q: int, sub_len: int, kernel: int) -> int:
    """Sub-grid index of the first key of query q's clamped window."""
    return min(max(q - kernel // 2, 0), max(sub_len - kernel, 0))


def _tile_halo(size: int, kernel: int, dilation: int, residue: int, tile: int) -> Tuple[int, int, np.ndarray]:
    """K4's integer arithmetic along one axis, mirrored here for the tests:
    for tile `tile` (KERNEL_TILE queries) of residue class `residue`'s
    sub-grid, (q0, h0, counts). q0 is the sub-grid index of the tile's first
    query (its queries are q0 .. min(q0 + KERNEL_TILE, sub_len) - 1); the
    halo is the keys h0 .. h0 + len(counts) - 1 (sub-grid indices), which
    hold every window of the tile; counts[e] is how often a window that holds
    key h0 + e lists it: 1, but k - sub_len + 1 for a sub-grid's last key
    where the sub-grid is shorter than the kernel (every window is then the
    whole sub-grid)."""
    sub_len = (size - residue + dilation - 1) // dilation
    q0 = tile * KERNEL_TILE
    nq = min(KERNEL_TILE, sub_len - q0)
    if nq < 1:
        raise ValueError(f"tile {tile} of residue {residue} holds no query (sub-grid of {sub_len})")
    length = min(kernel, sub_len)
    h0 = _window_start(q0, sub_len, kernel)
    counts = np.ones(_window_start(q0 + nq - 1, sub_len, kernel) + length - h0, np.int64)
    if sub_len < kernel:
        counts[sub_len - 1 - h0] = kernel - sub_len + 1
    return q0, h0, counts


def _check_shapes(q, k, v, rpb, kernel: int, dilation: int) -> None:
    if q.ndim != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, W, heads, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if kernel < 1 or dilation < 1:
        raise ValueError(f"kernel and dilation must be positive, got {kernel}, {dilation}")
    if tuple(rpb.shape) != (q.shape[3], 2 * kernel - 1, 2 * kernel - 1):
        raise ValueError(f"rpb shape {tuple(rpb.shape)} != {(q.shape[3], 2 * kernel - 1, 2 * kernel - 1)}")


def neighborhood_attention_2d_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rpb: torch.Tensor,
                                    kernel: int, dilation: int = 1, scale: float = 1.0) -> torch.Tensor:
    """The plain version: one gather of K per window offset for the logits,
    an fp32 softmax over the k*k offsets, one gather of V per offset for the
    weighted sum, in fp32."""
    _check_shapes(q, k, v, rpb, kernel, dilation)
    B, H, W, nh, dh = q.shape
    dtype = q.dtype
    if scale != 1.0:
        q = q * scale  # in q's dtype, as the module scales it
    qf, kf, vf, bias = q.float(), k.float(), v.float(), rpb.float()
    idx_h, rel_h = (torch.from_numpy(a).to(q.device) for a in _axis_indices(H, kernel, dilation))
    idx_w, rel_w = (torch.from_numpy(a).to(q.device) for a in _axis_indices(W, kernel, dilation))

    logits = []
    for a in range(kernel):
        k_row = kf.index_select(1, idx_h[:, a])
        for b in range(kernel):
            k_ab = k_row.index_select(2, idx_w[:, b])
            bias_ab = bias[:, rel_h[:, a][:, None], rel_w[:, b][None, :]]  # (nh, H, W)
            logits.append((qf * k_ab).sum(-1) + bias_ab.permute(1, 2, 0))
    attn = torch.softmax(torch.stack(logits, dim=-1), dim=-1)  # (B, H, W, nh, k*k)

    out = torch.zeros_like(qf)
    for a in range(kernel):
        v_row = vf.index_select(1, idx_h[:, a])
        for b in range(kernel):
            out += attn[..., a * kernel + b, None] * v_row.index_select(2, idx_w[:, b])
    return out.to(dtype)


def _check_cuda_args(q, k, v, rpb, kernel: int, dilation: int) -> None:
    """Raise on what the kernel does not take."""
    _check_shapes(q, k, v, rpb, kernel, dilation)
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (rpb, "rpb")):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} like q, got {t.dtype}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q, k, v must be bf16 or fp32, got {q.dtype}")
    if q.shape[4] != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel is built for head dim {KERNEL_HEAD_DIM}, got {q.shape[4]}")
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(4) != 1:
        raise ValueError(f"q, k, v must share strides with a contiguous last dim, got "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")
    if not rpb.is_contiguous():
        raise ValueError("rpb must be contiguous")
    # the kernel reads 16-byte vectors
    if any(t.data_ptr() % 16 for t in (q, k, v)) or any((s * q.element_size()) % 16 for s in q.stride()[:4]):
        raise ValueError("q, k and v rows must be 16-byte aligned: pointers and strides")


def neighborhood_attention_2d_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rpb: torch.Tensor,
                                   kernel: int, dilation: int = 1, scale: float = 1.0) -> torch.Tensor:
    """Launch K4. Counts its launches in `.launches`. It has no backward: with
    grad mode on and an input that requires grad it raises, rather than
    return an output without a grad_fn."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rpb)):
        raise RuntimeError("the neighborhood-attention kernel (K4) has no backward: call it under "
                           "torch.no_grad() or torch.inference_mode() (training on DiNAT is not ported)")
    _check_cuda_args(q, k, v, rpb, kernel, dilation)
    B, H, W, nh, dh = q.shape

    from ..kernels import load

    lib = load("neighborhood_attention")
    fn = lib.na2d_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    out = torch.empty((B, H, W, nh, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), out.data_ptr(), B, H, W, nh, dh,
                *q.stride()[:4], kernel, dilation, float(scale), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"neighborhood_attention kernel launch failed: cudaError {rc}")
    neighborhood_attention_2d_cuda.launches += 1
    return out


neighborhood_attention_2d_cuda.launches = 0


def neighborhood_attention_2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rpb: torch.Tensor,
                              kernel: int, dilation: int = 1, scale: float = 1.0) -> torch.Tensor:
    """K4 for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, dilation, scale)
    return neighborhood_attention_2d_plain(q, k, v, rpb, kernel, dilation, scale)
