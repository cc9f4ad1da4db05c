"""2-D sine/cosine positional embedding (PositionEmbeddingSine equivalent).

Port of `uni_encoder_tpu/ops/position_encoding.py`: y/x embeds are 1-based
cumsums normalized by the last row/col (+eps) and scaled by 2*pi; channel
layout is [pos_y || pos_x], each half interleaving sin/cos over pairs of
equal frequencies. Computed once per static (H, W) in numpy float32 with the
same arithmetic as the JAX copy, so both packages get identical bits, and
kept on each device it is asked for (the stride-4 map's embedding is 134 MB
at 1024x2048; copying it from the host every request cost more than a third
of the request on an H100). Callers cast to the activation dtype at use and
must not modify the returned tensor in place. A rank that holds some rows
of an image (`parallel/spatial.py`) asks for those rows alone.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _cached(h: int, w: int, num_pos_feats: int, temperature: int, normalize: bool,
            rows: Optional[Tuple[int, int]] = None) -> np.ndarray:
    a, b = (0, h) if rows is None else rows
    y_embed = np.arange(a + 1, b + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x_embed = np.ones((b - a, 1), np.float32) * np.arange(1, w + 1, dtype=np.float32)[None, :]
    if normalize:
        eps = 1e-6
        scale = 2 * math.pi
        # by the map's last row (h), whatever rows are asked for
        y_embed = y_embed / (np.full((1, w), h, np.float32) + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale

    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)

    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    # interleave: even channel -> sin, odd channel -> cos (equal freqs pairwise)
    pos_x = np.stack((np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])), axis=3).reshape(b - a, w, num_pos_feats)
    pos_y = np.stack((np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])), axis=3).reshape(b - a, w, num_pos_feats)
    return np.concatenate((pos_y, pos_x), axis=2)


@functools.lru_cache(maxsize=64)
def _on_device(h: int, w: int, num_pos_feats: int, temperature: int, normalize: bool,
               device: torch.device, rows: Optional[Tuple[int, int]]) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode, so that
    # a training step may use it after a served request
    with torch.inference_mode(False):
        return torch.from_numpy(_cached(h, w, num_pos_feats, temperature, normalize, rows)).to(device)


def position_embedding_sine(
    h: int,
    w: int,
    num_pos_feats: int = 128,
    temperature: int = 10000,
    normalize: bool = True,
    device=None,
    rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Returns the (H, W, 2*num_pos_feats) float32 positional embedding, or
    with `rows` = (a, b) its rows a .. b-1 only (b - a, W, 2*num_pos_feats):
    the same numbers, normalized by the whole map's last row, and only those
    rows computed and kept on the device."""
    rows = None if rows is None else (int(rows[0]), int(rows[1]))
    return _on_device(int(h), int(w), int(num_pos_feats), int(temperature), bool(normalize),
                      torch.device(device or "cpu"), rows)
