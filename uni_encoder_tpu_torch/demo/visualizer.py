"""Demo renderings (the port's own copy of `uni_encoder_tpu/demo/visualizer.py`).

Capability spec: reference demo/visualizer.py + demo/colormap.py (a 1.4k-line
detectron2 visualizer fork). This compact equivalent renders the same demo
artifacts: semantic overlays from the class palette, panoptic segments
(stuff + instance-shaded things with boundaries and class-name labels),
instance overlays with class-name + score text labels and boxes,
magma-coloured disparity, and HSV flow images.

The JAX package calls matplotlib for the magma colormap and the HSV
conversion; the port needs no matplotlib: `colorize_disparity` reads
matplotlib's 256-entry magma table from `data/assets/magma_256.json` and
indexes it as `Colormap.__call__` does, and `hsv_to_rgb` is matplotlib's
piecewise formula in numpy, so both give matplotlib's bytes. Text labels
are drawn by PIL (imported when one is drawn), with its default font.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.cityscapes_labels import CLASS_NAMES, PALETTE

_MAGMA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "assets", "magma_256.json")


def _palette() -> np.ndarray:
    return np.asarray(PALETTE, np.uint8)


def overlay(image: np.ndarray, color_map: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    return (image.astype(np.float32) * (1 - alpha) + color_map.astype(np.float32) * alpha).astype(np.uint8)


def draw_sem_seg(image: np.ndarray, sem_seg: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """sem_seg: (K, H, W) probabilities or (H, W) labels."""
    if sem_seg.ndim == 3:
        sem_seg = sem_seg.argmax(0)
    colors = _palette()[np.clip(sem_seg, 0, len(PALETTE) - 1)]
    return overlay(image, colors, alpha)


def _draw_text(image: np.ndarray, text: str, xy: Tuple[int, int]) -> np.ndarray:
    """Render `text` with its top-left at xy (PIL default font, white on a
    dark backing box: the reference visualizer's label style,
    demo/visualizer.py draw_text)."""
    from PIL import Image, ImageDraw

    pil = Image.fromarray(image)
    draw = ImageDraw.Draw(pil)
    x, y = int(xy[0]), int(xy[1])
    bbox = draw.textbbox((x, y), text)
    draw.rectangle(bbox, fill=(0, 0, 0))
    draw.text((x, y), text, fill=(255, 255, 255))
    return np.array(pil)  # writable copy


def _mask_label_anchor(mask: np.ndarray) -> Optional[Tuple[int, int]]:
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return None
    return int(np.median(xs)), int(np.median(ys))


def draw_panoptic(
    image: np.ndarray,
    panoptic_seg: np.ndarray,
    segments_info: List[Dict],
    alpha: float = 0.5,
    draw_labels: bool = True,
) -> np.ndarray:
    rng = np.random.RandomState(42)
    colors = np.zeros((*panoptic_seg.shape, 3), np.uint8)
    for seg in segments_info:
        base = np.asarray(PALETTE[seg["category_id"] % len(PALETTE)], np.float32)
        if seg["isthing"]:
            jitter = rng.uniform(-40, 40, 3)
            base = np.clip(base + jitter, 0, 255)
        colors[panoptic_seg == seg["id"]] = base.astype(np.uint8)
    out = overlay(image, colors, alpha)
    # thin boundaries between segments
    edges = np.zeros(panoptic_seg.shape, bool)
    edges[:-1] |= panoptic_seg[:-1] != panoptic_seg[1:]
    edges[:, :-1] |= panoptic_seg[:, :-1] != panoptic_seg[:, 1:]
    out[edges] = 255
    if draw_labels:
        for seg in segments_info:
            anchor = _mask_label_anchor(panoptic_seg == seg["id"])
            if anchor is None:
                continue
            name = CLASS_NAMES[seg["category_id"] % len(CLASS_NAMES)]
            out = _draw_text(out, name, anchor)
    return out


def draw_instances(
    image: np.ndarray,
    masks: np.ndarray,
    labels: np.ndarray,
    scores: np.ndarray,
    alpha: float = 0.5,
    score_threshold: float = 0.5,
    boxes: Optional[np.ndarray] = None,
    draw_labels: bool = True,
) -> np.ndarray:
    rng = np.random.RandomState(7)
    colors = np.zeros((*image.shape[:2], 3), np.uint8)
    order = np.argsort(scores)
    for i in order:
        if scores[i] < score_threshold:
            continue
        base = np.asarray(PALETTE[int(labels[i]) % len(PALETTE)], np.float32)
        base = np.clip(base + rng.uniform(-40, 40, 3), 0, 255)
        colors[np.asarray(masks[i], bool)] = base.astype(np.uint8)
    covered = colors.any(-1)
    out = image.copy()
    out[covered] = overlay(image, colors, alpha)[covered]
    for i in order[::-1]:
        if scores[i] < score_threshold:
            continue
        m = np.asarray(masks[i], bool)
        if boxes is not None:
            x0, y0, x1, y1 = [int(v) for v in boxes[i]]
            out[y0:y1 + 1, x0:x0 + 1] = 255
            out[y0:y1 + 1, x1:x1 + 1] = 255
            out[y0:y0 + 1, x0:x1 + 1] = 255
            out[y1:y1 + 1, x0:x1 + 1] = 255
        if draw_labels:
            anchor = _mask_label_anchor(m)
            if anchor is not None:
                name = CLASS_NAMES[int(labels[i]) % len(CLASS_NAMES)]
                out = _draw_text(out, f"{name} {float(scores[i]):.0%}", anchor)
    return out


@functools.lru_cache(maxsize=1)
def magma_table() -> np.ndarray:
    """matplotlib's magma lookup table, (256, 3) float64 RGB in [0, 1]."""
    with open(_MAGMA) as f:
        table = np.asarray(json.load(f)["rgb"], np.float64)
    table.flags.writeable = False
    return table


def colorize_disparity(disp: np.ndarray, percentile: float = 95) -> np.ndarray:
    """Magma colormap normalized at the 95th percentile (demo/defaults.py).

    The lookup is matplotlib's `Colormap.__call__` on floats: x * N in the
    input's dtype, N itself mapped to N - 1, truncated to an index; NaN
    takes the "bad" colour, black."""
    table = magma_table()
    n = len(table)
    disp = np.asarray(disp, np.float32)
    vmax = np.percentile(disp, percentile)
    disp = np.clip(disp / max(vmax, 1e-8), 0, 1)
    xa = disp * n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    rgb = table[np.clip(idx, 0, n - 1)]
    rgb[bad] = 0.0
    return (rgb * 255).astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) hsv in [0, 1] -> rgb, matplotlib's `colors.hsv_to_rgb`
    (sector i = floor(6h), fraction f, and p, q, t), computed in the input's
    float dtype (at least float32), as the JAX package's call computes it."""
    hsv = np.asarray(hsv)
    if hsv.shape[-1] != 3:
        raise ValueError(f"Last dimension of input array must be 3; shape {hsv.shape} was found.")
    in_shape = hsv.shape
    hsv = np.array(hsv, dtype=np.promote_types(hsv.dtype, np.float32), ndmin=2)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    for idx, (rr, gg, bb) in (
        (i % 6 == 0, (v, t, p)),
        (i == 1, (q, v, p)),
        (i == 2, (p, v, t)),
        (i == 3, (p, q, v)),
        (i == 4, (t, p, v)),
        (i == 5, (v, p, q)),
        (s == 0, (v, v, v)),
    ):
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    return np.stack([r, g, b], axis=-1).reshape(in_shape)


def flow_to_rgb(pix_motion: np.ndarray) -> np.ndarray:
    """2-D pixel motion (H, W, 2) -> inverted-HSV flow visualization
    (reference MonodepthLoss.vis_motion :622-653 / demo defaults vis_motion)."""
    dx, dy = pix_motion[..., 0], pix_motion[..., 1]
    mag = np.sqrt(dx ** 2 + dy ** 2)
    theta = np.arctan2(dy, dx + 1e-12)
    theta = (5 * np.pi / 2 - theta) % (2 * np.pi)
    hsv = np.ones((*mag.shape, 3), np.float32)
    hsv[..., 0] = ((theta - np.pi / 4) % (2 * np.pi)) / (2 * np.pi)
    hsv[..., 2] = mag / max(mag.max(), 1e-8)
    rgb = 1 - hsv_to_rgb(hsv)
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
