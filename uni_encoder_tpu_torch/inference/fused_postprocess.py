"""Fused full-resolution multi-task inference (port of
`uni_encoder_tpu/inference/fused_postprocess.py`).

`fused_multitask_inference` turns one image's (Q, K+1) class logits and
(Q, h, w) stride-4 mask logits into the union of the semantic, panoptic and
instance outputs at (4h, 4w): the semantic argmax and panoptic id maps as
(H, W) uint8 (labels <= K and ids <= Q, guarded below), the per-query
panoptic segment arrays, and the instance top-k scores, labels, boxes and
query indices. The output dict is the JAX function's.

On CUDA tensors the full-resolution pass is the hand-written kernel
`kernels/csrc/fused_postprocess.cu` (`fused_postprocess_cuda`), between a
per-query prologue and epilogue in PyTorch; no (Q, H, W) tensor is
materialised. On CPU tensors the function runs its plain version,
`fused_multitask_inference_plain`: the unfused pipeline (semantic, panoptic
and instance inference) over the materialised bf16 separable upsample, cast
to fp32 as the kernel does (the JAX kernel also upsamples in bf16 and takes
the sigmoid and everything after it in fp32). The two agree up to the bf16
rounding of the edge rows and columns (the kernel blends edge-clamped taps,
the resize copies them), fp32 summation order and sigmoid ulps: per-pixel
map mismatch < 3e-3, scores within 1e-3, boxes within 1 pixel, segment
arrays, labels and query indices exact (tests/test_fused_postprocess.py's
tolerances for the JAX kernel).

`phase_layout=True` returns the two maps in the JAX function's 16-phase
wire layout, (4, 4, H/4, W/4) uint8 with out[4k+jy, 4l+jx] = m[jy, jx, k,
l]: a permute of the (H, W) maps (the kernel does not change);
`deinterleave_phases_np` turns them back on the host.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import resize_hw
from .postprocess import (
    _panoptic_bookkeeping,
    instance_inference,
    panoptic_inference,
    semantic_inference,
    topk_lowest_index_first,
)

# per-query integer slots the kernel returns, in order
_SLOTS = ("win_area", "bin_area", "final_area", "strict_area", "xmin", "ymin", "xmax", "ymax")


def fused_postprocess_cuda(
    mask_pred: torch.Tensor,  # (Q, h, w) bf16
    clsprob: torch.Tensor,  # (Q, K) fp32 class probabilities (no-object column dropped)
    ks: torch.Tensor,  # (Q,) fp32 score of kept queries, 0 for dropped
    off: torch.Tensor,  # (Q,) fp32 0 for kept queries, -1 for dropped
) -> Dict[str, torch.Tensor]:
    """Launch the fused kernel. Counts its launches in `.launches`.

    Returns sem (H, W) u8, ids (H, W) u8 (winner id where the winner's logit
    >= 0, else Q), sig_sum (Q,) fp32 and the per-query int32 slots
    win_area, bin_area, final_area, strict_area (areas in pixels) and
    xmin, ymin, xmax, ymax (the inclusive box of logit > 0; meaningless
    where strict_area is 0)."""
    if mask_pred.ndim != 3:
        raise ValueError(f"mask_pred must be (Q, h, w), got {tuple(mask_pred.shape)}")
    Q, h, w = mask_pred.shape
    K = clsprob.shape[-1]
    if tuple(clsprob.shape) != (Q, K) or tuple(ks.shape) != (Q,) or tuple(off.shape) != (Q,):
        raise ValueError("clsprob must be (Q, K), ks and off (Q,)")
    if mask_pred.dtype != torch.bfloat16:
        raise ValueError(f"mask_pred must be bf16, got {mask_pred.dtype}")
    for t, name in ((mask_pred, "mask_pred"), (clsprob, "clsprob"), (ks, "ks"), (off, "off")):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != mask_pred.device:
            raise ValueError(f"{name} is on {t.device}, mask_pred on {mask_pred.device}")
        if t is not mask_pred and t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32, got {t.dtype}")
    if Q > 255 or K > 255:
        raise ValueError(f"uint8 maps need Q <= 255 and K <= 255, got Q={Q}, K={K}")

    from ..kernels import load

    lib = load("fused_postprocess")
    fn = lib.fused_postprocess
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int
        for aux in (lib.fused_postprocess_partial_size, lib.fused_postprocess_smem_bytes):
            aux.restype = ctypes.c_longlong
        lib.fused_postprocess_partial_size.argtypes = [ctypes.c_int] * 3
        lib.fused_postprocess_smem_bytes.argtypes = [ctypes.c_int]
    smem = lib.fused_postprocess_smem_bytes(Q)
    if smem > 227 * 1024:
        raise ValueError(f"Q={Q}, K={K} need {smem} bytes of shared memory, over the 227 KB a block can use")

    dev = mask_pred.device
    H, W = 4 * h, 4 * w
    sem = torch.empty((H, W), dtype=torch.uint8, device=dev)
    ids = torch.empty((H, W), dtype=torch.uint8, device=dev)
    slots = torch.empty((len(_SLOTS), Q), dtype=torch.int32, device=dev)
    partial = torch.empty((lib.fused_postprocess_partial_size(Q, h, w),), dtype=torch.float32, device=dev)
    sig_sum = torch.empty((Q,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            mask_pred.data_ptr(), clsprob.data_ptr(), ks.data_ptr(), off.data_ptr(), Q, K, h, w,
            sem.data_ptr(), ids.data_ptr(), slots.data_ptr(), partial.data_ptr(), sig_sum.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_postprocess kernel launch failed: cudaError {rc}")
    fused_postprocess_cuda.launches += 1
    out = {"sem": sem, "ids": ids, "sig_sum": sig_sum}
    out.update({name: slots[i] for i, name in enumerate(_SLOTS)})
    return out


fused_postprocess_cuda.launches = 0


def _check_wire_format(mask_cls: torch.Tensor) -> None:
    # the uint8 maps are lossless only while labels <= K and ids <= Q fit
    Q, K = mask_cls.shape[0], mask_cls.shape[1] - 1
    if Q > 255 or K > 255:
        raise ValueError(
            f"fused_multitask_inference uint8 wire format requires Q <= 255 "
            f"and num_classes <= 255; got Q={Q}, K={K}"
        )


def _prologue(mask_cls: torch.Tensor, object_mask_threshold: float) -> Tuple[torch.Tensor, ...]:
    _check_wire_format(mask_cls)
    K = mask_cls.shape[1] - 1
    probs = torch.softmax(mask_cls.float(), dim=-1)
    scores_all = probs.amax(dim=-1)
    labels_all = probs.argmax(dim=-1)
    keep = (labels_all != K) & (scores_all > object_mask_threshold)
    return probs, scores_all, labels_all, keep


def fused_postprocess_inputs(
    mask_cls: torch.Tensor, mask_pred: torch.Tensor, object_mask_threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The per-query prologue: class probabilities, labels and keep flags,
    and the four arguments `fused_postprocess_cuda` takes."""
    probs, scores_all, labels_all, keep = _prologue(mask_cls, object_mask_threshold)
    K = probs.shape[1] - 1
    # dropped queries score exactly -1 (prob = sig * ks + off), as the
    # unfused prob_masks = -1
    ks = torch.where(keep, scores_all, torch.zeros_like(scores_all)).contiguous()
    off = torch.where(keep, torch.zeros_like(scores_all), torch.full_like(scores_all, -1.0)).contiguous()
    args = (mask_pred.to(torch.bfloat16).contiguous(), probs[:, :K].contiguous(), ks, off)
    return probs, labels_all, keep, args


def _instance_topk(probs: torch.Tensor, topk: int):
    K = probs.shape[1] - 1
    scores_per_image, topk_indices = topk_lowest_index_first(probs[:, :-1].reshape(-1), topk)
    return scores_per_image, (topk_indices % K).to(torch.int32), topk_indices // K


def interleave_phases(m: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (4, 4, H/4, W/4): out[jy, jx, k, l] = m[4k+jy, 4l+jx]."""
    H, W = m.shape
    return m.reshape(H // 4, 4, W // 4, 4).permute(1, 3, 0, 2).contiguous()


def deinterleave_phases_np(m: np.ndarray) -> np.ndarray:
    """Host-side wire decode: (4, 4, h, w) phase layout -> (4h, 4w)."""
    _, _, h, w = m.shape
    return np.ascontiguousarray(m.transpose(2, 0, 3, 1).reshape(4 * h, 4 * w))


def _wire_layout(out: Dict[str, torch.Tensor], phase_layout: bool) -> Dict[str, torch.Tensor]:
    if phase_layout:
        for k in ("sem_seg_argmax", "panoptic_seg"):
            out[k] = interleave_phases(out[k])
    return out


def fused_multitask_inference(
    mask_cls: torch.Tensor,  # (Q, K+1) logits
    mask_pred: torch.Tensor,  # (Q, h, w) mask logits (stride 4)
    thing_mask: torch.Tensor,  # (K,) bool
    object_mask_threshold: float = 0.8,
    overlap_threshold: float = 0.8,
    topk: int = 150,
    phase_layout: bool = False,
) -> Dict[str, torch.Tensor]:
    """Semantic/panoptic/instance outputs at 4x the mask resolution: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors; the two
    maps in the phase layout with `phase_layout`."""
    if not mask_pred.is_cuda:
        return fused_multitask_inference_plain(
            mask_cls, mask_pred, thing_mask, object_mask_threshold, overlap_threshold, topk, phase_layout
        )
    probs, labels_all, keep, args = fused_postprocess_inputs(mask_cls, mask_pred, object_mask_threshold)
    r = fused_postprocess_cuda(*args)

    seg_id, isthing, new_segment, assigned = _panoptic_bookkeeping(
        labels_all, keep, r["win_area"], r["bin_area"], r["final_area"], thing_mask, overlap_threshold
    )
    # final id map: the winner query's assigned id where its >= 0 bit is set;
    # the sentinel id Q (no winner) maps to 0
    lut = torch.cat([assigned, assigned.new_zeros(1)]).to(torch.uint8)
    panoptic_seg = lut[r["ids"].long()]

    scores_per_image, labels_per_image, q_indices = _instance_topk(probs, topk)
    strict = r["strict_area"]
    mask_scores = r["sig_sum"][q_indices] / (strict[q_indices].float() + 1e-6)
    box = torch.stack([r["xmin"], r["ymin"], r["xmax"], r["ymax"]], dim=-1).float()
    boxes = torch.where((strict > 0)[:, None], box, torch.zeros_like(box))[q_indices]
    return _wire_layout({
        "sem_seg_argmax": r["sem"],
        "panoptic_seg": panoptic_seg,
        "seg_id": seg_id,
        "label": labels_all.to(torch.int32),
        "isthing": isthing,
        "is_new_segment": new_segment,
        "scores": scores_per_image * mask_scores,
        "labels": labels_per_image,
        "boxes": boxes,
        "query_indices": q_indices.to(torch.int32),
    }, phase_layout)


def fused_multitask_inference_plain(
    mask_cls: torch.Tensor,
    mask_pred: torch.Tensor,
    thing_mask: torch.Tensor,
    object_mask_threshold: float = 0.8,
    overlap_threshold: float = 0.8,
    topk: int = 150,
    phase_layout: bool = False,
) -> Dict[str, torch.Tensor]:
    """Plain version of the kernel path: the unfused pipeline over the
    materialised (Q, H, W) bf16 upsample cast to fp32, with the same output
    dict."""
    _check_wire_format(mask_cls)
    Q, h, w = mask_pred.shape
    up = resize_hw(mask_pred.to(torch.bfloat16), (4 * h, 4 * w), dims=(1, 2), mode="bilinear").float()
    sem = semantic_inference(mask_cls, up).argmax(dim=0)
    pan = panoptic_inference(mask_cls, up, thing_mask, object_mask_threshold, overlap_threshold)
    inst = instance_inference(mask_cls, up, topk)
    return _wire_layout({
        "sem_seg_argmax": sem.to(torch.uint8),
        "panoptic_seg": pan["panoptic_seg"].to(torch.uint8),
        "seg_id": pan["seg_id"],
        "label": pan["label"],
        "isthing": pan["isthing"],
        "is_new_segment": pan["is_new_segment"],
        "scores": inst["scores"],
        "labels": inst["labels"],
        "boxes": inst["boxes"],
        "query_indices": inst["query_indices"],
    }, phase_layout)
