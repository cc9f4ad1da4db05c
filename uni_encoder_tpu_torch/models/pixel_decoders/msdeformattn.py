"""Multi-scale deformable-attention pixel decoder and its depth variant
(port of `uni_encoder_tpu/models/pixel_decoders/msdeformattn.py`).

Project {res3, res4, res5} to `conv_dim` channels (1x1 conv + GroupNorm32),
run a deformable-attention encoder over the flattened multi-scale token
sequence (levels low-res first), split the tokens back into per-level maps,
extend to stride 4 through an FPN lateral/output conv pair on res2
(`_MSDeformTrunk`). `MSDeformAttnPixelDecoder` emits mask features through
a 1x1 conv; `DepthMSDeformAttnPixelDecoder` emits a sigmoid disparity per
level through reflect-conv / GroupNorm32 / ELU heads (`fpn.DispHead`), in
NHWC. The trunk's maps are channels-first (B, C, H, W), where the
convolutions and GroupNorm want them; tokens are (B, N, C). Both run K2
(`ms_deform_attn_fused`) once per encoder layer.

Parameter names follow the reference d2 state dict under
`sem_seg_head.pixel_decoder.` (or `.depth_decoder.`): `input_proj.{i}.{0,1}`,
`transformer.level_embed`, `transformer.encoder.layers.{l}.{self_attn.*,
norm1, norm2, linear1, linear2}`, `adapter_1(.norm)`, `layer_1(.norm)`,
`mask_features`; the depth heads follow the JAX copy's flax names,
`low_disp_{i}.{conv0, gn0, conv1, gn1, out}`.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops import ms_deform_attn_fused, position_embedding_sine, resize_hw
from ..layers import Conv2dNorm, relu
from .fpn import apply_disparity_heads, disparity_heads


@functools.lru_cache(maxsize=32)
def _reference_points(spatial_shapes: Tuple[Tuple[int, int], ...]) -> np.ndarray:
    """(N, 2) normalized (x, y) token centers, concatenated over levels
    (reference get_reference_points with valid_ratios == 1)."""
    pts = []
    for (H, W) in spatial_shapes:
        ys = (np.arange(H, dtype=np.float32) + 0.5) / H
        xs = (np.arange(W, dtype=np.float32) + 0.5) / W
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
    return np.concatenate(pts, axis=0)


@functools.lru_cache(maxsize=32)
def absolute_reference_points(spatial_shapes: Tuple[Tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    """(L, N, 2) fp32 source coordinates ref * (W_l, H_l) - 0.5 of every token
    center on every level: the grid_sample map folded into a constant, so the
    sampling location is `ref_abs + offset` (the reference's offset / (W, H)
    normalisation and the sampler's * (W, H) rescale cancel exactly). Kept
    on the device; callers must not modify it in place. A normal tensor even
    when first asked for under inference_mode, so that a training step may
    use it after a served request."""
    with torch.inference_mode(False):
        ref = torch.from_numpy(_reference_points(spatial_shapes)).to(device)  # (N, 2)
        wh = torch.tensor([[w, h] for (h, w) in spatial_shapes], dtype=torch.float32, device=device)
        return ref[None] * wh[:, None, :] - 0.5


class MSDeformAttnModule(nn.Module):
    """Deformable attention block: learned offsets/weights + the sampling op,
    which takes the two Linear outputs raw (softmax and locations inside)."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, ref_abs, value_src, spatial_shapes):
        B, N, C = query.shape
        value = self.value_proj(value_src).view(B, N, self.n_heads, C // self.n_heads)
        out = ms_deform_attn_fused(
            value, spatial_shapes, self.sampling_offsets(query), self.attention_weights(query), ref_abs
        )
        return self.output_proj(out)


class MSDeformAttnEncoderLayer(nn.Module):
    def __init__(self, d_model: int = 256, d_ffn: int = 1024, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.self_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, ref_abs, spatial_shapes):
        src = self.norm1(src + self.self_attn(src + pos, ref_abs, src, spatial_shapes))
        return self.norm2(src + self.linear2(relu(self.linear1(src))))


class _Encoder(nn.Module):
    def __init__(self, layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _DeformableTransformer(nn.Module):
    def __init__(self, conv_dim: int, n_levels: int, n_layers: int, n_heads: int, n_points: int):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(n_levels, conv_dim))
        self.encoder = _Encoder(
            [MSDeformAttnEncoderLayer(conv_dim, 1024, n_levels, n_heads, n_points) for _ in range(n_layers)]
        )


class _MSDeformTrunk(nn.Module):
    """The trunk both decoders share: input projections, the deformable
    encoder and the FPN extension."""

    def __init__(
        self,
        in_channels: Dict[str, int],
        conv_dim: int = 256,
        transformer_layers: int = 6,
        n_heads: int = 8,
        n_points: int = 4,
        transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
        fpn_in_features: Sequence[str] = ("res2",),
    ):
        super().__init__()
        C = conv_dim
        self.conv_dim = C
        self.transformer_in_features = tuple(transformer_in_features)
        self.fpn_in_features = tuple(fpn_in_features)
        L = len(self.transformer_in_features)
        # low-res first (res5 -> res3)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(in_channels[f], C, kernel_size=1), nn.GroupNorm(32, C, eps=1e-5))
            for f in reversed(self.transformer_in_features)
        )
        self.transformer = _DeformableTransformer(C, L, transformer_layers, n_heads, n_points)
        for idx, f in enumerate(reversed(self.fpn_in_features)):
            self.add_module(f"adapter_{idx + 1}", Conv2dNorm(
                in_channels[f], C, kernel_size=1, bias=False, norm=nn.GroupNorm(32, C, eps=1e-5)))
            self.add_module(f"layer_{idx + 1}", Conv2dNorm(
                C, C, kernel_size=3, padding=1, bias=False, norm=nn.GroupNorm(32, C, eps=1e-5)))

    def encode(self, features: Dict[str, torch.Tensor]):
        """Inputs of the deformable encoder: (src, pos, ref_abs, spatial_shapes)."""
        C = self.conv_dim
        srcs, poss, shapes = [], [], []
        for i, f in enumerate(reversed(self.transformer_in_features)):
            x = self.input_proj[i](features[f].permute(0, 3, 1, 2))  # (B, C, h, w)
            h, w = x.shape[2], x.shape[3]
            shapes.append((h, w))
            srcs.append(x.flatten(2).transpose(1, 2))
            poss.append(position_embedding_sine(h, w, C // 2, device=x.device))
        src = torch.cat(srcs, dim=1)
        level_embed = self.transformer.level_embed
        pos = torch.cat(
            [(p.reshape(1, -1, C) + level_embed[i][None, None]).to(src.dtype) for i, p in enumerate(poss)],
            dim=1,
        ).expand(src.shape[0], -1, -1)
        spatial_shapes = tuple(shapes)
        return src, pos, absolute_reference_points(spatial_shapes, src.device), spatial_shapes

    def trunk(self, features: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """features: channels-last {res2..res5}. Returns the per-level maps,
        low-res to high-res ([res5, res4, res3, res2]), channels-first."""
        y, pos, ref_abs, shapes = self.encode(features)
        for layer in self.transformer.encoder.layers:
            y = layer(y, pos, ref_abs, shapes)

        B, _, C = y.shape
        out = []
        start = 0
        for (h, w) in shapes:
            out.append(y[:, start : start + h * w].transpose(1, 2).reshape(B, C, h, w))
            start += h * w

        for idx, f in enumerate(reversed(self.fpn_in_features)):
            lat = getattr(self, f"adapter_{idx + 1}")(features[f].permute(0, 3, 1, 2))
            up = resize_hw(out[-1], lat.shape[2:], dims=(2, 3), mode="bilinear", align_corners=False)
            out.append(relu(getattr(self, f"layer_{idx + 1}")(lat + up)))
        return out


class MSDeformAttnPixelDecoder(_MSDeformTrunk):
    def __init__(
        self,
        in_channels: Dict[str, int],
        conv_dim: int = 256,
        mask_dim: int = 256,
        transformer_layers: int = 6,
        n_heads: int = 8,
        n_points: int = 4,
        transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
        fpn_in_features: Sequence[str] = ("res2",),
        num_multi_scale: int = 3,
    ):
        super().__init__(in_channels, conv_dim, transformer_layers, n_heads, n_points, transformer_in_features,
                         fpn_in_features)
        self.num_multi_scale = num_multi_scale
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, kernel_size=1)

    def forward(self, features: Dict[str, torch.Tensor]):
        """features: channels-last {res2..res5}. Returns (mask_features
        (B, mask_dim, H/4, W/4), the lowest-res map, the `num_multi_scale`
        lowest-res maps), all channels-first."""
        out = self.trunk(features)
        return self.mask_features(out[-1]), out[0], out[: self.num_multi_scale]


class DepthMSDeformAttnPixelDecoder(_MSDeformTrunk):
    def __init__(
        self,
        in_channels: Dict[str, int],
        conv_dim: int = 256,
        transformer_layers: int = 6,
        n_heads: int = 8,
        n_points: int = 4,
        transformer_in_features: Sequence[str] = ("res3", "res4", "res5"),
        fpn_in_features: Sequence[str] = ("res2",),
    ):
        super().__init__(in_channels, conv_dim, transformer_layers, n_heads, n_points, transformer_in_features,
                         fpn_in_features)
        disparity_heads(self, conv_dim, len(self.transformer_in_features) + len(self.fpn_in_features))

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict:
        """{("disp", s): (B, H / 2^(s+2), W / 2^(s+2), 1)} for s = 0..3
        (the res2 FPN level is s = 0)."""
        return apply_disparity_heads(self, self.trunk(features))
