"""Test-time augmentation for semantic segmentation (the port's own copy
of `uni_encoder_tpu/engine/tta.py`; the scales are PIL-exact bilinear
resizes by `data.image_io`).

Capability spec: the reference carries d2's TEST.AUG config block
(MIN_SIZES multi-scale + FLIP; Base-Cityscapes-UnifiedSegmentation.yaml
TEST.AUG, model/config.py TTA slide params) wired to
SemanticSegmentorWithTTA. This wrapper runs the segmentation forward at
each scale (and horizontally flipped), resizes the per-class probability
maps back to the original resolution, and averages them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..data.mappers import resize_shortest_edge


class SemanticTTA:
    def __init__(self, predictor, min_sizes: Sequence[int] = (512, 768, 1024, 1280), max_size: int = 4096, flip: bool = True):
        self.predictor = predictor
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.flip = flip

    def __call__(self, item: Dict) -> Dict:
        image = item["image"]
        out_h = item.get("height", image.shape[0])
        out_w = item.get("width", image.shape[1])
        acc = None
        count = 0
        for ms in self.min_sizes:
            scaled, _ = resize_shortest_edge(image, ms, self.max_size)
            variants = [scaled]
            if self.flip:
                variants.append(scaled[:, ::-1])
            for vi, img in enumerate(variants):
                it = dict(item, image=np.ascontiguousarray(img), height=out_h, width=out_w)
                res = self.predictor.infer_segmentation(it)
                sem = np.asarray(res["sem_seg"], np.float32)  # (K, out_h, out_w)
                if vi == 1:
                    sem = sem[:, :, ::-1]
                acc = sem if acc is None else acc + sem
                count += 1
        out = dict(item)
        out["sem_seg"] = acc / count
        return out
