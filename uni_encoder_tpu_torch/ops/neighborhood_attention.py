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

A row window `rows = (height, q_row, k_row)` (one image's rows split over
ranks, `parallel/spatial.py`) makes q the rows [q_row, q_row + H_q) of a map
of `height` rows, and k and v its rows [k_row, k_row + H_k), which must hold
every window of those queries: the windows, their clamping and the bias come
from the whole map's `_axis_indices(height, ...)`, the values from the local
blocks, and the output holds the query rows. With the window
(H, 0, 0) on whole maps nothing changes. `reach_rows(height, kernel,
dilation, q_rows)` gives the key rows a block of queries reaches.

`neighborhood_attention_2d_plain` is the plain version: the JAX op's loop
over the k*k window offsets, with index tensors, the logits, the softmax and
the weighted sum of values all in fp32 and one rounding to the input dtype
(the JAX op sums the values in the input dtype); its autograd is the plain
backward (`neighborhood_attention_2d_backward_plain`).

On CUDA tensors `neighborhood_attention_2d` and
`neighborhood_attention_2d_qkv` (the DiNAT module's call: the qkv
projection's whole (B, H, W, 3, heads, dh) output) run the hand-written
kernels. With no gradient to record (serving: no_grad or inference_mode),
the forward kernel K4 alone, `kernels/csrc/neighborhood_attention.cu`
(`neighborhood_attention_2d_cuda`), with nothing saved. When autograd needs
a backward, `neighborhood_attention_2d_qkv` runs
`NeighborhoodAttention2DFunction` (`neighborhood_attention_2d` raises): K4
forward, which also writes each window's log-sum-exp (its fp32 kernel's
optional `lse` output), then K5,
`kernels/csrc/neighborhood_attention_backward.cu`
(`neighborhood_attention_2d_backward_cuda`, its products on the tensor
cores in 3xTF32), which takes that lse and writes dq, dk and dv into one
buffer in the qkv layout and drpb; fp32 only (training runs fp32), bf16
under autograd raises. Both kernels work on tiles of one residue class's
sub-grid: K4 (and K5's query pass) on the halo of keys a tile's windows
cover, each key once, weighted by how often a window repeats it
(`_tile_halo`); K5's key pass on the range of queries whose windows hold a
key (`_inverse_range`). Those two are the kernels' integer arithmetic in
Python, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

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


def _inverse_range(sub_len: int, kernel: int, key: int) -> Tuple[int, int]:
    """K5's key pass, along one axis: the sub-grid indices [lo, hi] of the
    queries whose clamped windows hold sub-grid key `key`. `start` never
    decreases, so they are one range: [key - k + 1 + k//2, key + k//2]
    inside, from 0 where the window is clamped at the low edge, to
    sub_len - 1 at the high edge; the whole sub-grid where it is no longer
    than the kernel."""
    if sub_len <= kernel:
        return 0, sub_len - 1
    lo = 0 if key - kernel + 1 <= 0 else key - kernel + 1 + kernel // 2
    hi = sub_len - 1 if key >= sub_len - kernel else min(key + kernel // 2, sub_len - 1)
    return lo, hi


def reach_rows(height: int, kernel: int, dilation: int, q_rows: Tuple[int, int]) -> Tuple[int, int]:
    """The rows [lo, hi) of a map of `height` rows that the windows of the
    query rows `q_rows` = (a, b) reach together (a < b): the union of their
    windows, contiguous, since a window always holds its own query."""
    idx = _axis_indices(height, kernel, dilation)[0][q_rows[0]:q_rows[1]]
    return int(idx.min()), int(idx.max()) + 1


def _row_axis(q_height: int, k_height: int, kernel: int, dilation: int,
              rows: Optional[Tuple[int, int, int]]) -> Tuple[np.ndarray, np.ndarray]:
    """(idx, rel) of `_axis_indices` along the rows for the row window
    `rows` (None: the whole map), idx counted from k's first row."""
    if rows is None:
        return _axis_indices(q_height, kernel, dilation)
    height, q_row, k_row = rows
    idx, rel = _axis_indices(height, kernel, dilation)
    return idx[q_row:q_row + q_height] - k_row, rel[q_row:q_row + q_height]


def _check_shapes(q, k, v, rpb, kernel: int, dilation: int, rows: Optional[Tuple[int, int, int]] = None) -> None:
    same = [q.shape[:1] + q.shape[2:]] * 3 == [x.shape[:1] + x.shape[2:] for x in (q, k, v)]
    if q.ndim != 5 or not same or v.shape != k.shape or (rows is None and k.shape != q.shape):
        raise ValueError(f"q, k, v must share one (B, H, W, heads, dh) shape (k and v may hold other rows under "
                         f"a row window), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if kernel < 1 or dilation < 1:
        raise ValueError(f"kernel and dilation must be positive, got {kernel}, {dilation}")
    if rows is not None:
        height, q_row, k_row = rows
        if not (0 <= q_row and q_row + q.shape[1] <= height and 0 <= k_row and k_row + k.shape[1] <= height):
            raise ValueError(f"row window {rows}: q's rows [{q_row}, {q_row + q.shape[1]}) and k's "
                             f"[{k_row}, {k_row + k.shape[1]}) must lie in the map's {height} rows")
        if q.shape[1]:
            lo, hi = reach_rows(height, kernel, dilation, (q_row, q_row + q.shape[1]))
            if lo < k_row or hi > k_row + k.shape[1]:
                raise ValueError(f"row window {rows}: the queries' windows reach rows [{lo}, {hi}), k and v hold "
                                 f"[{k_row}, {k_row + k.shape[1]})")
    if tuple(rpb.shape) != (q.shape[3], 2 * kernel - 1, 2 * kernel - 1):
        raise ValueError(f"rpb shape {tuple(rpb.shape)} != {(q.shape[3], 2 * kernel - 1, 2 * kernel - 1)}")


def _plain_logits(q: torch.Tensor, k: torch.Tensor, rpb: torch.Tensor, kernel: int, dilation: int,
                  scale: float, rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """The plain version's fp32 logits (B, H, W, heads, k*k): one gather of
    K per window offset, q scaled in its own dtype first; a clamped window's
    repeated key is listed as often as the window repeats it."""
    B, H, W, nh, dh = q.shape
    if scale != 1.0:
        q = q * scale  # in q's dtype, as the module scales it
    qf, kf, bias = q.float(), k.float(), rpb.float()
    idx_h, rel_h = (torch.from_numpy(a).to(q.device) for a in _row_axis(H, k.shape[1], kernel, dilation, rows))
    idx_w, rel_w = (torch.from_numpy(a).to(q.device) for a in _axis_indices(W, kernel, dilation))

    logits = []
    for a in range(kernel):
        k_row = kf.index_select(1, idx_h[:, a])
        for b in range(kernel):
            k_ab = k_row.index_select(2, idx_w[:, b])
            bias_ab = bias[:, rel_h[:, a][:, None], rel_w[:, b][None, :]]  # (nh, H, W)
            logits.append((qf * k_ab).sum(-1) + bias_ab.permute(1, 2, 0))
    return torch.stack(logits, dim=-1)


def neighborhood_attention_2d_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rpb: torch.Tensor,
                                    kernel: int, dilation: int = 1, scale: float = 1.0,
                                    rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """The plain version: the logits (`_plain_logits`), an fp32 softmax over
    the k*k offsets, one gather of V per offset for the weighted sum, in
    fp32. `rows`: the row window (height, q_row, k_row), or None."""
    _check_shapes(q, k, v, rpb, kernel, dilation, rows)
    B, H, W, nh, dh = q.shape
    dtype = q.dtype
    vf = v.float()
    idx_h = torch.from_numpy(_row_axis(H, k.shape[1], kernel, dilation, rows)[0]).to(q.device)
    idx_w = torch.from_numpy(_axis_indices(W, kernel, dilation)[0]).to(q.device)
    attn = torch.softmax(_plain_logits(q, k, rpb, kernel, dilation, scale, rows), dim=-1)  # (B, H, W, nh, k*k)

    out = q.new_zeros((B, H, W, nh, dh), dtype=torch.float32)
    for a in range(kernel):
        v_row = vf.index_select(1, idx_h[:, a])
        for b in range(kernel):
            out += attn[..., a * kernel + b, None] * v_row.index_select(2, idx_w[:, b])
    return out.to(dtype)


def neighborhood_attention_2d_lse_plain(q: torch.Tensor, k: torch.Tensor, rpb: torch.Tensor, kernel: int,
                                        dilation: int = 1, scale: float = 1.0) -> torch.Tensor:
    """What K4's `lse` output holds, plainly: the log-sum-exp of the plain
    version's logits over each window's k*k entries, repeats included, fp32
    (B, H, W, heads)."""
    _check_shapes(q, k, k, rpb, kernel, dilation)
    return torch.logsumexp(_plain_logits(q, k, rpb, kernel, dilation, scale), dim=-1)


def _check_cuda_args(q, k, v, rpb, kernel: int, dilation: int, rows=None) -> None:
    """Raise on what the kernel does not take."""
    _check_shapes(q, k, v, rpb, kernel, dilation, rows)
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
                                   kernel: int, dilation: int = 1, scale: float = 1.0,
                                   lse: Optional[torch.Tensor] = None,
                                   rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Launch K4. Counts its launches in `.launches`. With `lse` (fp32
    inputs only: a contiguous (B, H, W, heads) fp32 tensor on the same card)
    it also writes each window's log-sum-exp there, for K5; the output's
    bytes are the same either way. `rows`: the row window (height, q_row,
    k_row), or None (not with `lse`: K5 takes whole maps). Alone it has no
    backward: with grad mode on and an input that requires grad it raises,
    rather than return an output without a grad_fn
    (`neighborhood_attention_2d_qkv` pairs it with K5)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rpb)):
        raise RuntimeError("the neighborhood-attention forward kernel (K4) alone has no backward: call "
                           "neighborhood_attention_2d_qkv, which pairs it with K5, or run under no_grad")
    _check_cuda_args(q, k, v, rpb, kernel, dilation, rows)
    B, H, W, nh, dh = q.shape
    if lse is not None and rows is not None:
        raise ValueError("K4 writes lse for whole maps only (its reader K5 takes no row window)")
    height, q_row, k_row = (H, 0, 0) if rows is None else rows
    if lse is not None and (q.dtype != torch.float32 or lse.dtype != torch.float32 or lse.device != q.device
                            or tuple(lse.shape) != (B, H, W, nh) or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous fp32 {(B, H, W, nh)} tensor on {q.device}, for fp32 inputs; "
                         f"got {lse.dtype} {tuple(lse.shape)} on {lse.device} for {q.dtype}")

    from ..kernels import load

    lib = load("neighborhood_attention")
    fn = lib.na2d_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    out = torch.empty((B, H, W, nh, dh), dtype=q.dtype, device=q.device)
    # q, k and v as the kernel addresses them: from the whole map's row 0
    row_bytes = q.stride(1) * q.element_size()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr() - q_row * row_bytes, k.data_ptr() - k_row * row_bytes, v.data_ptr() - k_row * row_bytes,
                rpb.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(), B, height, W, nh, dh,
                *q.stride()[:4], kernel, dilation, float(scale), int(q.dtype == torch.bfloat16), q_row, q_row + H,
                stream)
    if rc != 0:
        raise RuntimeError(f"neighborhood_attention kernel launch failed: cudaError {rc}")
    neighborhood_attention_2d_cuda.launches += 1
    return out


neighborhood_attention_2d_cuda.launches = 0


def _check_backward_args(qkv, rpb, out, lse, grad_out, kernel: int, dilation: int) -> None:
    if qkv.ndim != 6 or qkv.shape[3] != 3:
        raise ValueError(f"qkv must be (B, H, W, 3, heads, dh), got {tuple(qkv.shape)}")
    B, H, W, _, nh, dh = qkv.shape
    _check_shapes(qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb, kernel, dilation)
    for t, name in ((qkv, "qkv"), (rpb, "rpb"), (out, "out"), (lse, "lse"), (grad_out, "grad_out")):
        if not t.is_cuda or t.device != qkv.device:
            raise ValueError(f"{name} must be a CUDA tensor on {qkv.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the backward kernel (K5) is fp32 only (training runs in fp32): {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if tuple(out.shape) != (B, H, W, nh, dh) or tuple(grad_out.shape) != (B, H, W, nh, dh):
        raise ValueError(f"out and grad_out must be {(B, H, W, nh, dh)}, got {tuple(out.shape)}, "
                         f"{tuple(grad_out.shape)}")
    if tuple(lse.shape) != (B, H, W, nh):
        raise ValueError(f"lse must be {(B, H, W, nh)}, got {tuple(lse.shape)}")
    if dh != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel is built for head dim {KERNEL_HEAD_DIM}, got {dh}")


def _k5_launch_shape(lib, B: int, H: int, W: int, nh: int, kernel: int, dilation: int) -> Tuple[int, int, int, int]:
    """(blocks, threads a block, shared memory bytes of the query and of the
    key pass) of K5's launch, from the kernel's own plan."""
    fn = lib.na2d_backward_launch_shape
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    blocks, threads, smem_a, smem_b = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = fn(B, H, W, nh, kernel, dilation, ctypes.byref(blocks), ctypes.byref(threads), ctypes.byref(smem_a),
            ctypes.byref(smem_b))
    if rc != 0:
        raise ValueError(f"the backward kernel (K5) refuses {(B, H, W, nh, kernel, dilation)}: cudaError {rc}")
    return blocks.value, threads.value, smem_a.value, smem_b.value


def neighborhood_attention_2d_backward_cuda(qkv: torch.Tensor, rpb: torch.Tensor, out: torch.Tensor,
                                            lse: torch.Tensor, grad_out: torch.Tensor, kernel: int,
                                            dilation: int = 1, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 (three kernels, one call): the gradients of
    `neighborhood_attention_2d_cuda(qkv[:, :, :, 0], qkv[:, :, :, 1],
    qkv[:, :, :, 2], rpb, kernel, dilation, scale, lse)`, whose output was
    `out` and whose log-sum-exp was `lse`, for `grad_out`: (dqkv in qkv's
    layout, drpb). fp32 only. Counts its calls in `.launches`."""
    _check_backward_args(qkv, rpb, out, lse, grad_out, kernel, dilation)
    B, H, W, _, nh, dh = qkv.shape

    from ..kernels import load

    lib = load("neighborhood_attention_backward")
    blocks = _k5_launch_shape(lib, B, H, W, nh, kernel, dilation)[0]
    fn = lib.na2d_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    dqkv = torch.empty_like(qkv)
    drpb = torch.empty_like(rpb)
    stats = torch.empty(lse.shape + (4,), dtype=torch.float32, device=qkv.device)
    partial = torch.empty((max(blocks, 1), (2 * kernel - 1) ** 2), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(qkv.data_ptr(), rpb.data_ptr(), out.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
                dqkv.data_ptr(), drpb.data_ptr(), stats.data_ptr(), partial.data_ptr(), B, H, W, nh, dh, kernel,
                dilation, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"neighborhood_attention backward kernel launch failed: cudaError {rc}")
    neighborhood_attention_2d_backward_cuda.launches += 1
    return dqkv, drpb


neighborhood_attention_2d_backward_cuda.launches = 0


def neighborhood_attention_2d_backward_plain(qkv: torch.Tensor, rpb: torch.Tensor, grad_out: torch.Tensor,
                                             kernel: int, dilation: int = 1,
                                             scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version: autograd of `neighborhood_attention_2d_plain` on
    the three views of `qkv`, for `grad_out`: (dqkv, drpb)."""
    with torch.enable_grad():
        qkv, rpb = qkv.detach().requires_grad_(True), rpb.detach().requires_grad_(True)
        out = neighborhood_attention_2d_plain(qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb, kernel,
                                              dilation, scale)
        return torch.autograd.grad(out, (qkv, rpb), grad_out)


class NeighborhoodAttention2DFunction(torch.autograd.Function):
    """K4 forward and K5 backward, on the qkv projection's whole output:
    saves qkv, rpb, the output and K4's log-sum-exp of each window, and
    returns dqkv (dq scaled, as q is scaled inside) and drpb. fp32 only."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, rpb: torch.Tensor, kernel: int, dilation: int, scale: float) -> torch.Tensor:
        if qkv.dtype != torch.float32 or rpb.dtype != torch.float32:
            raise ValueError(f"neighborhood attention under autograd on CUDA is fp32 only (its backward kernel "
                             f"K5 is fp32; training runs in fp32), got {qkv.dtype}: run bf16 under no_grad")
        qkv = qkv.contiguous()
        lse = torch.empty(qkv.shape[:3] + qkv.shape[4:5], dtype=torch.float32, device=qkv.device)
        out = neighborhood_attention_2d_cuda(qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb, kernel,
                                             dilation, scale, lse)
        ctx.save_for_backward(qkv, rpb, out, lse)
        ctx.geometry = (kernel, dilation, scale)
        return out

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        qkv, rpb, out, lse = ctx.saved_tensors
        dqkv, drpb = neighborhood_attention_2d_backward_cuda(qkv, rpb, out, lse, grad_out.contiguous(),
                                                             *ctx.geometry)
        return dqkv, drpb, None, None, None


def _needs_backward(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def neighborhood_attention_2d_qkv(qkv: torch.Tensor, rpb: torch.Tensor, kernel: int, dilation: int = 1,
                                  scale: float = 1.0) -> torch.Tensor:
    """Neighborhood attention on the three slots of `qkv` (B, H, W, 3, heads,
    dh): K4 for CUDA tensors (with K5 as its backward when autograd needs
    one), the plain version for CPU tensors."""
    if qkv.is_cuda and _needs_backward(qkv, rpb):
        return NeighborhoodAttention2DFunction.apply(qkv, rpb, kernel, dilation, scale)
    return neighborhood_attention_2d(qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb, kernel, dilation, scale)


def neighborhood_attention_2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rpb: torch.Tensor,
                              kernel: int, dilation: int = 1, scale: float = 1.0,
                              rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """K4 for CUDA tensors (under autograd it raises: the backward, K5,
    takes the qkv layout of `neighborhood_attention_2d_qkv`), the plain
    version for CPU tensors; `rows`: the row window, or None."""
    if q.is_cuda:
        return neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, dilation, scale, rows=rows)
    return neighborhood_attention_2d_plain(q, k, v, rpb, kernel, dilation, scale, rows)
