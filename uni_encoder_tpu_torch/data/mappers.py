"""Test-time dataset mappers (the port's own copy of
`uni_encoder_tpu/data/mappers.py`, on `image_io` instead of PIL).

Capability spec: reference model/data/dataset_mappers/dataset_mapper.py —
  * segmentation items: ResizeShortestEdge(SEG_MIN_SIZE_TEST,
    SEG_MAX_SIZE_TEST) on the RGB image, task prompt string attached
    (:244-289);
  * sequence items: fixed LANCZOS resize at read time — 192x512 for
    cityscapes, 192x640 for KITTI (:53-78) — for current/prev/next frames;
    camera intrinsics loaded from the camera json (baseline kept for stereo).

Outputs are numpy uint8 HWC + metadata; normalization/padding to /32 happens
on the device in the Predictor. The resizes are PIL's (`image_io`), so an
item equals the JAX mapper's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from .image_io import read_image, resize_bilinear
from .tokenizer import tokenize_task


def resize_shortest_edge(
    image: np.ndarray, min_size: int, max_size: int
) -> Tuple[np.ndarray, float]:
    """d2 ResizeShortestEdge test-time semantics (bilinear)."""
    h, w = image.shape[:2]
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    if (nh, nw) == (h, w):
        return image, 1.0
    return resize_bilinear(image, (nh, nw)), scale


class TestMapper:
    """Maps a dataset item dict to model-ready numpy arrays."""

    def __init__(
        self,
        task: str = "panoptic",
        seg_min_size: int = 1024,
        seg_max_size: int = 2048,
        sequence_hw: Tuple[int, int] = (192, 512),  # cityscapes; kitti: (192, 640)
        task_seq_len: int = 77,
    ):
        self.task = task
        self.seg_min_size = seg_min_size
        self.seg_max_size = seg_max_size
        self.sequence_hw = sequence_hw
        self.task_seq_len = task_seq_len

    def __call__(self, item: Dict) -> Dict:
        out = dict(item)
        if item["type"] == "segmentation":
            image = read_image(item["file_name"])
            out["height"], out["width"] = image.shape[:2]
            image, scale = resize_shortest_edge(image, self.seg_min_size, self.seg_max_size)
            out["image"] = image
            out["scale"] = scale
            out["task"] = f"The task is {self.task}"
            out["task_tokens"] = np.asarray(tokenize_task(out["task"], self.task_seq_len), np.int32)
        elif item["type"] == "sequence":
            h, w = self.sequence_hw
            out["image"] = read_image(item["file_name"], (w, h))
            if item.get("left_prev_image_file"):
                out["prev_image"] = read_image(item["left_prev_image_file"], (w, h))
            if item.get("left_nxt_image_file"):
                out["next_image"] = read_image(item["left_nxt_image_file"], (w, h))
            cam = item.get("cam_info_file")
            if cam and os.path.isfile(cam):
                with open(cam) as f:
                    cam_data = json.load(f)
                out["camera"] = cam_data
                out["K"], out["inv_K"] = intrinsics_from_camera_json(cam_data, (h, w))
                out["baseline"] = cam_data.get("extrinsic", {}).get("baseline", 0.0)
        else:
            raise ValueError(f"unknown item type {item.get('type')!r}")
        return out


def intrinsics_from_camera_json(cam: Dict, target_hw: Tuple[int, int], orig_hw=(1024, 2048)):
    """Build 4x4 K / inv_K rescaled from the native cityscapes resolution to
    the model input resolution (reference multi-pass mapper K handling,
    oneformer_multi_pass_cityscapes_mapper.py:230-245)."""
    intr = cam["intrinsic"]
    th, tw = target_hw
    oh, ow = orig_hw
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = intr["fx"] * tw / ow
    K[1, 1] = intr["fy"] * th / oh
    K[0, 2] = intr["u0"] * tw / ow
    K[1, 2] = intr["v0"] * th / oh
    return K, np.linalg.inv(K).astype(np.float32)
