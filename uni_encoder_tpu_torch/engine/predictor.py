"""Inference entry points from uint8 images (port of
`uni_encoder_tpu/engine/predictor.py`).

`Predictor.infer_segmentation` normalizes, pads to the size divisibility,
runs `forward_segmentation`, upsamples the masks bilinearly to the padded
size, crops the padding, resizes to the requested resolution and runs the
unfused semantic / panoptic / instance inference and the instance filters
(thing classes in panoptic mode, the demo score threshold, the ADE20K
label remap). `Predictor.infer_sequence` normalizes a frame pair and runs
`forward_sequence`. Results are numpy arrays, as from the JAX Predictor.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..inference.postprocess import (
    instance_inference,
    panoptic_inference,
    segments_info_from_arrays,
    semantic_inference,
)
from ..models.oneformer import UniEncoder
from ..ops import interpolate


def pad_to_multiple(h: int, w: int, div: int) -> Tuple[int, int]:
    return -(-h // div) * div, -(-w // div) * div


def _numpy(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:  # numpy has no bfloat16
        x = x.float()
    return x.cpu().numpy()


class Predictor:
    """Serves one item at a time with `model`. Without a model it builds a
    `UniEncoder(cfg.model, device)` with random weights (load a state dict
    into `predictor.model`); `device=None` means the GPU and raises when
    none is visible."""

    def __init__(self, cfg: Config, model: Optional[UniEncoder] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.model = model if model is not None else UniEncoder(cfg.model, device=device)
        param = next(self.model.parameters())
        self.device, self.dtype = param.device, param.dtype
        mc = cfg.model
        self.mean = torch.tensor(mc.pixel_mean, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(mc.pixel_std, dtype=torch.float32, device=self.device)
        self.thing_mask: Optional[torch.Tensor] = None  # set per dataset
        self.instance_label_remap: Optional[torch.Tensor] = None  # ADE20K quirk, set per dataset

    def set_thing_ids(self, thing_contiguous_ids, dataset_name: str = "") -> None:
        K = self.cfg.model.sem_seg_head.num_classes
        tm = torch.zeros((K,), dtype=torch.bool)
        for t in thing_contiguous_ids:
            tm[t] = True
        self.thing_mask = tm.to(self.device)
        # ADE20K instance quirk: outside demo mode, instance labels are
        # re-indexed into the thing list (150-class ids -> 0..99 instance
        # ids). Non-thing entries stay -1, and such predictions are dropped
        # (see infer_segmentation), never mapped to thing 0.
        self.instance_label_remap = None
        if "ade20k" in dataset_name and not self.cfg.model.is_demo:
            remap = torch.full((K,), -1, dtype=torch.int32)
            for i, t in enumerate(sorted(thing_contiguous_ids)):
                remap[t] = i
            self.instance_label_remap = remap.to(self.device)

    def _normalize(self, image_u8) -> torch.Tensor:
        """(H, W, 3) uint8 -> (H, W, 3) fp32, normalized."""
        image = torch.as_tensor(image_u8, device=self.device)
        return (image.to(torch.float32) - self.mean) / self.std

    # ------------------------------------------------------------ segmentation
    @torch.inference_mode()
    def infer_segmentation(self, item: Dict) -> Dict:
        """item: image (H, W, 3) uint8, task_tokens (77,) int, optional
        height / width of the output. Returns sem_seg (K, h, w) fp32,
        panoptic_seg ((h, w) int32, segments_info) and instances (scores,
        labels, masks, boxes, query_indices), as the configuration's test
        flags ask."""
        if self.thing_mask is None:
            raise RuntimeError("call set_thing_ids() first")
        t = self.cfg.model.test
        h, w = item["image"].shape[:2]
        out_hw = (int(item.get("height", h)), int(item.get("width", w)))
        ph, pw = pad_to_multiple(h, w, self.cfg.model.one_former.size_divisibility)
        img = F.pad(self._normalize(item["image"]), (0, 0, 0, pw - w, 0, ph - h)).to(self.dtype)
        tokens = torch.as_tensor(item["task_tokens"], device=self.device)
        out = self.model.forward_segmentation(img[None], tokens[None])
        logits = out["pred_logits"][0]  # (Q, K+1)
        masks = out["pred_masks"][0]  # (Q, ph/4, pw/4)
        # upsample to the padded input size, crop the padding, resize to the
        # output resolution
        m = interpolate(masks.permute(1, 2, 0)[None], size=(ph, pw), mode="bilinear")[0]
        m = interpolate(m[:h, :w][None], size=out_hw, mode="bilinear")[0].permute(2, 0, 1)

        res: Dict = {}
        if t.semantic_on:
            res["sem_seg"] = _numpy(semantic_inference(logits, m))
        if t.panoptic_on:
            pan = panoptic_inference(logits, m, self.thing_mask, t.object_mask_threshold, t.overlap_threshold)
            pan = {k: _numpy(v) for k, v in pan.items()}
            res["panoptic_seg"] = (pan["panoptic_seg"], segments_info_from_arrays(pan))
        if t.instance_on or t.detection_on:
            # the filters run on the device, so only kept masks reach the host
            inst = instance_inference(logits, m, t.detections_per_image)
            keep = torch.ones_like(inst["labels"], dtype=torch.bool)
            if t.panoptic_on:  # panoptic mode keeps only thing classes
                keep &= self.thing_mask[inst["labels"]]
            if self.cfg.model.is_demo:
                keep &= inst["scores"] > t.object_mask_threshold
            if self.instance_label_remap is not None:
                inst["labels"] = self.instance_label_remap[inst["labels"]]
                keep &= inst["labels"] >= 0
            res["instances"] = {k: _numpy(v[keep]) for k, v in inst.items()}
        return res

    # ---------------------------------------------------------------- sequence
    @torch.inference_mode()
    def infer_sequence(self, item: Dict) -> Dict:
        """item: image and prev_image (H, W, 3) uint8. Returns disp_results
        (the depth decoder's scale 0: (H, W) for TransDSSL, (H/2, W/2) for
        DCMNet, (H/4, W/4) for the DepthMSDeformAttn and
        DepthTransformerEncoder decoders, as in the JAX package), motion_mask
        (H, W), complete_flow (H, W, 3) and cam_T_cam (4, 4), fp32."""
        img = self._normalize(item["image"]).to(self.dtype)
        prev = self._normalize(item["prev_image"]).to(self.dtype)
        out = self.model.forward_sequence(img[None], prev[None])
        return {
            "disp_results": _numpy(out["disp"][0, ..., 0]),
            "motion_mask": _numpy(out["motion_mask"][0, ..., 0]),
            "complete_flow": _numpy(out["complete_flow"][0]),
            "cam_T_cam": _numpy(out["cam_T_cam"][0]),
        }
