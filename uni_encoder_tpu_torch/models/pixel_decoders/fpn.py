"""FPN-family pixel decoders (port of
`uni_encoder_tpu/models/pixel_decoders/fpn.py`).

  * `BasePixelDecoder`: a top-down FPN over res2..res5 (a 1x1 lateral conv
    and a 3x3 output conv per level, each with GroupNorm32, nearest
    upsampling), mask features by a 3x3 conv of the stride-4 map, and the
    3 lowest-resolution maps as the multi-scale features;
  * `TransformerEncoderPixelDecoder`: the same FPN, the res5 map first
    through a 1x1 input projection and a 6-layer post-norm transformer
    encoder (sine position embedding); also returns the encoder's map;
  * `DepthTransformerEncoderPixelDecoder`: the transformer FPN with a
    reflect-conv / GroupNorm32 / ELU / sigmoid disparity head per level.

Convolutions take no bias where a norm follows (d2's `Conv2d` with a norm).
The FPN's maps are channels-first (B, C, H, W), as the query decoder takes
them; the disparity heads take and give NHWC, as the JAX copy's.

Parameter names follow the reference d2 state dict (fpn.py:39-315):
`adapter_{1..3}(.norm)`, `layer_{1..4}(.norm)`, `mask_features`, and for
the transformer `input_proj`, `transformer.encoder.layers.{l}.{self_attn,
linear1, linear2, norm1, norm2}`. The disparity heads follow the JAX copy's
flax names: `low_disp_{i}.{conv0, gn0, conv1, gn1, out}`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops import position_embedding_sine, resize_hw
from ..layers import Conv2dNHWC, Conv2dNorm, GroupNorm32, MultiheadAttention, elu, reflect_conv, relu

IN_FEATURES = ("res2", "res3", "res4", "res5")


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-5)


class TransformerEncoderLayerPost(nn.Module):
    """Post-norm transformer encoder layer (reference transformer.py:161-234),
    no dropout; tokens (B, N, C)."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nheads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q = src + pos
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.linear2(relu(self.linear1(src))))


class _Encoder(nn.Module):
    def __init__(self, layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _TransformerEncoderOnly(nn.Module):
    def __init__(self, d_model: int, nheads: int, dim_feedforward: int, num_layers: int):
        super().__init__()
        self.encoder = _Encoder([TransformerEncoderLayerPost(d_model, nheads, dim_feedforward)
                                 for _ in range(num_layers)])


class DispHead(nn.Module):
    """Reflect conv 3x3, GroupNorm32, ELU, twice, then a 1x1 conv and a
    sigmoid: an NHWC map -> (B, h, w, 1) disparity in (0, 1)."""

    def __init__(self, channels: int):
        super().__init__()
        half = channels // 2
        self.conv0 = reflect_conv(channels, half)
        self.gn0 = GroupNorm32(half)
        self.conv1 = reflect_conv(half, half)
        self.gn1 = GroupNorm32(half)
        self.out = Conv2dNHWC(half, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = elu(self.gn0(self.conv0(x)))
        x = elu(self.gn1(self.conv1(x)))
        return torch.sigmoid(self.out(x))


def disparity_heads(module: nn.Module, channels: int, n_levels: int) -> None:
    """Add `low_disp_{i}` heads for maps ordered low-res to high-res."""
    for i in range(n_levels):
        module.add_module(f"low_disp_{i}", DispHead(channels))


def apply_disparity_heads(module: nn.Module, outs: Sequence[torch.Tensor]) -> Dict:
    """{("disp", s): (B, h, w, 1)} of channels-first maps ordered low-res to
    high-res: scale s counts from the highest resolution (s = 0), like the
    reference's {("disp", s)} dict."""
    n = len(outs)
    return {("disp", n - 1 - i): getattr(module, f"low_disp_{i}")(o.permute(0, 2, 3, 1)) for i, o in enumerate(outs)}


class _FPN(nn.Module):
    """The shared top-down pass, named as d2's BasePixelDecoder names it."""

    def __init__(self, in_channels: Dict[str, int], conv_dim: int, in_features: Sequence[str],
                 use_transformer: bool, transformer_layers: int = 6, nheads: int = 8, dim_feedforward: int = 2048):
        super().__init__()
        C = conv_dim
        self.conv_dim = C
        self.in_features = tuple(in_features)
        self.use_transformer = use_transformer
        n = len(self.in_features)
        if use_transformer:
            self.input_proj = nn.Conv2d(in_channels[self.in_features[-1]], C, kernel_size=1)
            self.transformer = _TransformerEncoderOnly(C, nheads, dim_feedforward, transformer_layers)
        for idx, f in enumerate(self.in_features):
            if idx == n - 1:
                cin = C if use_transformer else in_channels[f]
                self.add_module(f"layer_{idx + 1}", Conv2dNorm(cin, C, kernel_size=3, padding=1, bias=False,
                                                               norm=_gn(C)))
            else:
                self.add_module(f"adapter_{idx + 1}", Conv2dNorm(in_channels[f], C, kernel_size=1, bias=False,
                                                                 norm=_gn(C)))
                self.add_module(f"layer_{idx + 1}", Conv2dNorm(C, C, kernel_size=3, padding=1, bias=False,
                                                               norm=_gn(C)))

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        B, C, h, w = x.shape
        pos = position_embedding_sine(h, w, C // 2, device=x.device).reshape(1, h * w, C).to(x.dtype)
        t = x.flatten(2).transpose(1, 2)
        for layer in self.transformer.encoder.layers:
            t = layer(t, pos)
        return t.transpose(1, 2).reshape(B, C, h, w)

    def trunk(self, features: Dict[str, torch.Tensor]) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """features: channels-last {res2..res5}. Returns the per-level maps
        low-res to high-res and the encoder's map (None without the
        transformer), channels-first."""
        outs: List[torch.Tensor] = []
        enc = None
        n = len(self.in_features)
        y = None
        for idx, f in enumerate(reversed(self.in_features)):
            num = n - idx  # the reference names levels high-res to low-res: layer_1 .. layer_n
            x = features[f].permute(0, 3, 1, 2)
            if idx == 0:
                if self.use_transformer:
                    enc = self._encode(self.input_proj(x))
                    x = enc
            else:
                lat = getattr(self, f"adapter_{num}")(x)
                x = lat + resize_hw(y, lat.shape[2:], dims=(2, 3), mode="nearest")
            y = relu(getattr(self, f"layer_{num}")(x))
            outs.append(y)
        return outs, enc


class BasePixelDecoder(_FPN):
    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256, mask_dim: int = 256,
                 in_features: Sequence[str] = IN_FEATURES, num_multi_scale: int = 3):
        super().__init__(in_channels, conv_dim, in_features, use_transformer=False)
        self.num_multi_scale = num_multi_scale
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, kernel_size=3, padding=1)

    def forward(self, features: Dict[str, torch.Tensor]):
        """Returns (mask_features (B, mask_dim, H/4, W/4), None, the
        `num_multi_scale` lowest-res maps), channels-first."""
        outs, _ = self.trunk(features)
        return self.mask_features(outs[-1]), None, outs[: self.num_multi_scale]


class TransformerEncoderPixelDecoder(_FPN):
    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256, mask_dim: int = 256,
                 in_features: Sequence[str] = IN_FEATURES, transformer_layers: int = 6, nheads: int = 8,
                 dim_feedforward: int = 2048, num_multi_scale: int = 3):
        super().__init__(in_channels, conv_dim, in_features, True, transformer_layers, nheads, dim_feedforward)
        self.num_multi_scale = num_multi_scale
        self.mask_features = nn.Conv2d(conv_dim, mask_dim, kernel_size=3, padding=1)

    def forward(self, features: Dict[str, torch.Tensor]):
        """Returns (mask_features, the encoder's map, the `num_multi_scale`
        lowest-res maps), channels-first."""
        outs, enc = self.trunk(features)
        return self.mask_features(outs[-1]), enc, outs[: self.num_multi_scale]


class DepthTransformerEncoderPixelDecoder(_FPN):
    def __init__(self, in_channels: Dict[str, int], conv_dim: int = 256, in_features: Sequence[str] = IN_FEATURES,
                 transformer_layers: int = 6, nheads: int = 8, dim_feedforward: int = 2048):
        super().__init__(in_channels, conv_dim, in_features, True, transformer_layers, nheads, dim_feedforward)
        disparity_heads(self, conv_dim, len(self.in_features))

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict:
        """{("disp", s): (B, H / 2^(s+2), W / 2^(s+2), 1)} for s = 0..3."""
        outs, _ = self.trunk(features)
        return apply_disparity_heads(self, outs)
