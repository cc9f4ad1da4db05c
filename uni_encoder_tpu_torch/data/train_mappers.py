"""Training-time dataset mappers (the port's own copy of
`uni_encoder_tpu/data/train_mappers.py`, on numpy, `image_io` and the
port's C++ resize instead of PIL and cv2).

Capability spec: reference model/data/dataset_mappers/ —
  * OneFormerUnifiedDatasetMapper (:93-160) + the multi-pass cityscapes
    mapper's segmentation branch (:314-437): resize-shortest-edge from a
    scale list, fixed absolute crop (pad value 128 / ignore 255), SSD-style
    color augmentation, task sampled by TASK_PROB (semantic .33 /
    instance .66 / else panoptic), per-task targets built from the panoptic
    PNG, per-query text prompts ("a {task} photo", "a photo with a {cls}");
  * the sequence branch / DepthCityscapesMapper (:438-554, :117-245):
    3-frame photometric pipeline — identical geometric transform across
    frames, color jitter applied jointly while `orig_*` uncolored copies are
    kept as photometric targets, K/inv_K rescaled to the crop with h-flip
    u0 correction;
  * custom_augs.py: SSD color augment (brightness/contrast/saturation/hue).

Every output is byte-equal to the JAX mappers' on the same files and seeds:
the same `np.random.RandomState` draws in the same order, and the arithmetic
copied expression for expression (NumPy 2 casts a Python float against a
float32 array to float32, so `img += rng.uniform(...)` is not rewritten).
The image resize is `native.resize_bilinear_u8` (the JAX package's C++
resize), the id map's NEAREST and the masks' BILINEAR are PIL's
(`image_io`), and the HSV conversions are cv2's (`color`).

Each mapper adds the host seconds of its stages to `stage_s` (decode,
resize, hsv, targets, mask_downsample, tokenize; the sequence mapper:
decode_resize, jitter, intrinsics), which a caller may reset and read.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import SEG_MIN_SIZES_TRAIN
from ..native import decode_panoptic_ids, resize_bilinear_u8
from .cityscapes_labels import CLASS_NAMES, NUM_CLASSES, THING_TRAIN_IDS
from .color import hsv_to_rgb, rgb_to_hsv
from .image_io import image_size, read_image, resize_bilinear, resize_nearest
from .mappers import intrinsics_from_camera_json
from .tokenizer import tokenize_task


class _Stages:
    """Host seconds per stage: `t = clock.lap("decode", t)` adds the time
    since `t` to the stage and returns now."""

    def __init__(self):
        self.stage_s: Dict[str, float] = defaultdict(float)

    def lap(self, stage: str, t0: float) -> float:
        now = time.perf_counter()
        self.stage_s[stage] += now - t0
        return now


# ----------------------------------------------------------------- augmenters
def color_aug_ssd_draws(rng: np.random.RandomState) -> Tuple[Optional[float], ...]:
    """The random numbers of one `color_aug_ssd`, in its order: the
    brightness delta, the contrast, the saturation and the hue delta, each
    None where its 1/2-probability coin says no. The saturation and hue
    coins are both drawn before either value, so the stream's consumption
    does not depend on which applies (d2 ColorAugSSDTransform semantics)."""
    delta = rng.uniform(-32, 32) if rng.randint(2) else None
    alpha = rng.uniform(0.5, 1.5) if rng.randint(2) else None
    do_sat = bool(rng.randint(2))
    do_hue = bool(rng.randint(2))
    sat = rng.uniform(0.5, 1.5) if do_sat else None
    hue = rng.uniform(-18, 18) if do_hue else None
    return delta, alpha, sat, hue


def apply_color_aug_ssd(img: np.ndarray, draws: Tuple[Optional[float], ...]) -> np.ndarray:
    """SSD photometric distortion with `color_aug_ssd_draws`' numbers (d2
    ColorAugSSDTransform defaults: brightness delta 32, contrast/saturation
    [0.5, 1.5], hue delta 18)."""
    delta, alpha, sat, hue = draws
    img = img.astype(np.float32)
    if delta is not None:
        img += delta
    if alpha is not None:
        img *= alpha
    # saturation / hue in HSV
    if sat is not None or hue is not None:
        hsv = rgb_to_hsv(np.clip(img, 0, 255).astype(np.uint8)).astype(np.float32)
        if sat is not None:
            hsv[..., 1] *= sat
        if hue is not None:
            hsv[..., 0] = (hsv[..., 0] + hue) % 180
        img = hsv_to_rgb(np.clip(hsv, 0, 255).astype(np.uint8)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def color_aug_ssd(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """SSD photometric distortion of `img`, its numbers drawn from `rng`."""
    return apply_color_aug_ssd(img, color_aug_ssd_draws(rng))


def _resize(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    if img.shape[:2] == hw:
        return img
    return resize_bilinear_u8(img, hw[0], hw[1])


# ------------------------------------------------------------------- seg task
class SegmentationTrainMapper(_Stages):
    def __init__(
        self,
        crop_size: Tuple[int, int] = (512, 1024),
        min_sizes: Sequence[int] = SEG_MIN_SIZES_TRAIN,
        max_size: int = 4096,
        task_prob_semantic: float = 0.33,
        task_prob_instance: float = 0.66,
        max_instances: int = 100,
        color_aug: bool = True,
        seed: int = 0,
        num_texts: int = 134,  # NUM_OBJECT_QUERIES - TEXT_ENCODER.N_CTX
    ):
        super().__init__()
        self.crop_size = crop_size
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.p_sem = task_prob_semantic
        self.p_inst = task_prob_instance
        self.max_instances = max_instances
        self.color_aug = color_aug
        self.num_texts = num_texts
        self.rng = np.random.RandomState(seed)

    def _draws(self, h: int, w: int) -> Dict:
        """The random numbers of one item of (h, w) pixels, in the order
        the reference draws them: the resize's shortest edge (and the size
        it gives), the flip, the crop's corner, the color augmentation and
        the task."""
        rng = self.rng
        # resize shortest edge (choice) capped by max_size
        min_size = self.min_sizes[rng.randint(len(self.min_sizes))]
        scale = min_size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        flip = bool(rng.randint(2))
        # the crop's corner in the image padded to at least the crop
        ch, cw = self.crop_size
        y0 = rng.randint(max(nh, ch) - ch + 1)
        x0 = rng.randint(max(nw, cw) - cw + 1)
        color = color_aug_ssd_draws(rng) if self.color_aug else None
        return {"hw": (nh, nw), "flip": flip, "corner": (y0, x0), "color": color, "task": rng.rand()}

    def skip(self, item: Dict) -> None:
        """Advance the random stream past `item` as mapping it would, reading
        only the image's header: a rank of a data-parallel run maps only its
        rows of each global batch and skips the others' (it raises, as
        mapping does, where a file is missing)."""
        os.stat(item["pan_seg_file_name"])
        self._draws(*image_size(item["file_name"]))

    def __call__(self, item: Dict) -> Dict:
        t = time.perf_counter()
        image = read_image(item["file_name"])
        pan_ids = decode_panoptic_ids(read_image(item["pan_seg_file_name"]))
        t = self.lap("decode", t)

        d = self._draws(*image.shape[:2])
        nh, nw = d["hw"]
        image = _resize(image, (nh, nw))
        pan_ids = resize_nearest(pan_ids.astype(np.int32), (nh, nw))

        # random flip
        if d["flip"]:
            image = image[:, ::-1]
            pan_ids = pan_ids[:, ::-1]

        # absolute crop (pad 128 / void 0 if short)
        ch, cw = self.crop_size
        if nh < ch or nw < cw:
            pad_h, pad_w = max(0, ch - nh), max(0, cw - nw)
            image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), constant_values=128)
            pan_ids = np.pad(pan_ids, ((0, pad_h), (0, pad_w)), constant_values=0)
        y0, x0 = d["corner"]
        image = np.ascontiguousarray(image[y0 : y0 + ch, x0 : x0 + cw])
        pan_ids = np.ascontiguousarray(pan_ids[y0 : y0 + ch, x0 : x0 + cw])
        t = self.lap("resize", t)

        if self.color_aug:
            image = apply_color_aug_ssd(image, d["color"])
        t = self.lap("hsv", t)

        # task sampling (reference TASK_PROB semantics)
        p = d["task"]
        if p < self.p_sem:
            task = "semantic"
        elif p < self.p_inst:
            task = "instance"
        else:
            task = "panoptic"

        labels, masks, texts = self._targets(pan_ids, item["segments_info"], task)
        t = self.lap("targets", t)
        N = self.max_instances
        n = min(len(labels), N)
        pad_labels = np.zeros((N,), np.int32)
        pad_masks = np.zeros((N, ch // 4, cw // 4), bool)
        valid = np.zeros((N,), bool)
        for i in range(n):
            pad_labels[i] = labels[i]
            m = masks[i].astype(np.uint8)
            pad_masks[i] = resize_bilinear(m * 255, (ch // 4, cw // 4)) > 127
            valid[i] = True
        t = self.lap("mask_downsample", t)

        # per-query text list, padded with the task prompt (reference
        # oneformer_unified_dataset_mapper.py:143-170: texts initialized to
        # "a {task} photo" and overwritten per object instance)
        text_list = [f"a {task} photo"] * self.num_texts
        for i, t_ in enumerate(texts[1:][: self.num_texts]):
            text_list[i] = t_
        text_tokens = np.stack(
            [np.asarray(tokenize_task(t_), np.int32) for t_ in text_list]
        )
        out = {
            "images": image,
            "task_tokens": np.asarray(tokenize_task(f"The task is {task}"), np.int32),
            "text_tokens": text_tokens,
            "labels": pad_labels,
            "masks": pad_masks,
            "valid": valid,
            "task": task,
        }
        self.lap("tokenize", t)
        return out

    def _targets(self, pan_ids: np.ndarray, segments_info: List[Dict], task: str):
        labels, masks, texts = [], [], [f"a {task} photo"]
        thing_set = set(THING_TRAIN_IDS)
        if task == "semantic":
            # one mask per present class
            for cls in range(NUM_CLASSES):
                m = np.zeros(pan_ids.shape, bool)
                for seg in segments_info:
                    if seg["category_id"] == cls:
                        m |= pan_ids == seg["id"]
                if m.any():
                    labels.append(cls)
                    masks.append(m)
                    texts.append(f"a photo with a {CLASS_NAMES[cls]}")
        else:
            for seg in segments_info:
                if seg.get("iscrowd", 0):
                    continue
                cls = seg["category_id"]
                if task == "instance" and cls not in thing_set:
                    continue
                m = pan_ids == seg["id"]
                if m.any():
                    labels.append(cls)
                    masks.append(m)
                    texts.append(f"a photo with a {CLASS_NAMES[cls]}")
        return labels, masks, texts


# -------------------------------------------------------------- sequence task
class SequenceTrainMapper(_Stages):
    def __init__(self, hw: Tuple[int, int] = (192, 512), color_jitter: bool = True, seed: int = 0):
        super().__init__()
        self.hw = hw
        self.color_jitter = color_jitter
        self.rng = np.random.RandomState(seed)

    def _jitter_params(self):
        r = self.rng
        return dict(
            brightness=r.uniform(0.8, 1.2),
            contrast=r.uniform(0.8, 1.2),
            saturation=r.uniform(0.8, 1.2),
            hue=r.uniform(-0.05, 0.05),
        )

    def _apply_jitter(self, img: np.ndarray, p: Dict) -> np.ndarray:
        out = img.astype(np.float32) * p["brightness"]
        mean = out.mean(axis=(0, 1), keepdims=True)
        out = (out - mean) * p["contrast"] + mean
        hsv = rgb_to_hsv(np.clip(out, 0, 255).astype(np.uint8)).astype(np.float32)
        hsv[..., 1] *= p["saturation"]
        hsv[..., 0] = (hsv[..., 0] + p["hue"] * 180) % 180
        return hsv_to_rgb(np.clip(hsv, 0, 255).astype(np.uint8))

    def _draws(self) -> Tuple[bool, Optional[Dict]]:
        """The random numbers of one item: the flip, then the jitter's."""
        flip = bool(self.rng.randint(2))
        return flip, (self._jitter_params() if self.color_jitter else None)

    def skip(self, item: Dict) -> None:
        """Advance the random stream past `item` as mapping it would, without
        reading it (see `SegmentationTrainMapper.skip`)."""
        for key in ("file_name", "left_prev_image_file", "left_nxt_image_file"):
            os.stat(item[key])
        self._draws()

    def __call__(self, item: Dict) -> Dict:
        h, w = self.hw
        t = time.perf_counter()
        cur = read_image(item["file_name"], (w, h))
        prev = read_image(item["left_prev_image_file"], (w, h))
        nxt = read_image(item["left_nxt_image_file"], (w, h))
        t = self.lap("decode_resize", t)

        flip, p = self._draws()
        if flip:
            cur, prev, nxt = cur[:, ::-1], prev[:, ::-1], nxt[:, ::-1]

        # photometric targets keep the *uncolored* frames (reference keeps
        # orig_* copies; color jitter only feeds the network input)
        out = {
            "orig_images": np.ascontiguousarray(cur),
            "orig_prev_images": np.ascontiguousarray(prev),
            "orig_next_images": np.ascontiguousarray(nxt),
        }
        if self.color_jitter:
            cur, prev, nxt = (self._apply_jitter(x, p) for x in (cur, prev, nxt))
        out.update(
            images=np.ascontiguousarray(cur),
            prev_images=np.ascontiguousarray(prev),
            next_images=np.ascontiguousarray(nxt),
        )
        t = self.lap("jitter", t)

        cam_file = item.get("cam_info_file")
        if cam_file:
            with open(cam_file) as f:
                cam = json.load(f)
            K, inv_K = intrinsics_from_camera_json(cam, self.hw)
            if flip:
                K[0, 2] = w - 1 - K[0, 2]  # h-flip u0 correction
                inv_K = np.linalg.inv(K).astype(np.float32)
        else:
            K = np.eye(4, dtype=np.float32)
            K[0, 0] = K[1, 1] = 0.58 * w  # KITTI-style default intrinsics
            K[0, 2], K[1, 2] = 0.5 * w, 0.5 * h
            inv_K = np.linalg.inv(K).astype(np.float32)
        out["K"], out["inv_K"] = K, inv_K
        self.lap("intrinsics", t)
        return out


class BalancedSampler:
    """Infinite 1:1 interleave of segmentation and sequence items
    (reference model/utils/data_sampler.py:5-51)."""

    def __init__(self, seg_items: List, seq_items: List, seed: int = 0):
        self.seg_items = seg_items
        self.seq_items = seq_items
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        while True:
            si = self.rng.permutation(len(self.seg_items))
            qi = self.rng.permutation(len(self.seq_items))
            for a, b in zip(si, qi):
                yield ("segmentation", self.seg_items[a])
                yield ("sequence", self.seq_items[b])


def build_train_mappers(cfg) -> Tuple[SegmentationTrainMapper, SequenceTrainMapper]:
    """The two train mappers of a Config, as train.py builds them (seed 0)."""
    seg = SegmentationTrainMapper(
        crop_size=tuple(cfg.input.seg_crop_train),
        min_sizes=tuple(cfg.input.seg_min_size_train),
        max_size=cfg.input.seg_max_size_train,
        num_texts=cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx,
    )
    return seg, SequenceTrainMapper(hw=tuple(cfg.input.depth_hw_train))
