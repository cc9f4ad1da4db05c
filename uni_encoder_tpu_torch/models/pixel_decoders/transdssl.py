"""TransDSSL depth decoder (port of
`uni_encoder_tpu/models/pixel_decoders/transdssl.py`).

DPT-like: 1x1 projections of res2..res5, attention-gated refinenet fusion
blocks with residual conv units and align_corners=True x2 upsampling, and
soft-argmax disparity heads over 32 bins in [0.01, 1]. Returns
{("disp", s): (B, H/2^s, W/2^s, 1)} for the emitted scales.

d2 keys, under `layers.`: `layer{1..4}_rn`, `refinenet{0..4}.{resConfUnit1,
resConfUnit2}.conv{1,2}`, `refinenet{k}.en_atten`, `refinenet{k}.out_conv`
(`refinenet4` has no `resConfUnit1` and no `en_atten`), and
`output_conv{,2,3,4}.{0,1}`.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...ops import interpolate
from ..layers import Conv2dNHWC, relu

# (head name, scale it emits), coarse to fine
_HEADS = (("output_conv4", 3), ("output_conv3", 2), ("output_conv2", 1), ("output_conv", 0))


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2dNHWC(features, features, 3, padding=1)
        self.conv2 = Conv2dNHWC(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(relu(self.conv1(relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Fuses the coarser path `xs[0]` with a skip `xs[1]` (when
    `input_length` is 2) through a softmax channel gate, then upsamples x2."""

    def __init__(self, features: int, input_length: int = 2):
        super().__init__()
        if input_length == 2:
            self.resConfUnit1 = ResidualConvUnit(features)
            self.en_atten = Conv2dNHWC(features, features, 1)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = Conv2dNHWC(features, features, 1)

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        if len(xs) == 2:
            res = xs[0] + xs[1]
            att = torch.softmax(self.en_atten(self.resConfUnit1(xs[1])), dim=-1)
            output = self.resConfUnit2(res * att) + res
        else:
            output = self.resConfUnit2(xs[0])
        output = interpolate(output, scale_factor=2, mode="bilinear", align_corners=True)
        return self.out_conv(output)


def soft_att_depth(x: torch.Tensor, alpha: float = 0.01, beta: float = 1.0) -> torch.Tensor:
    """Soft-argmax over the channel bins, weighted by a linspace(alpha, beta)
    grid; the softmax in fp32, the result in x's dtype. (B,H,W,D) -> (B,H,W,1)."""
    grid = torch.linspace(alpha, beta, x.shape[-1], dtype=torch.float32, device=x.device)
    z = torch.softmax(x.float(), dim=-1)
    return (z * grid).sum(dim=-1, keepdim=True).to(x.dtype)


class TransDSSL(nn.Module):
    """`in_channels`: the single-frame res2..res5 widths. `n_scales` (1..4)
    drops the coarse heads; the refinement path always runs in full."""

    def __init__(self, in_channels: Dict[str, int], features: int = 256, n_bins: int = 32, n_scales: int = 4):
        super().__init__()
        F = features
        layers = {f"layer{k}_rn": Conv2dNHWC(in_channels[f"res{k + 1}"], F, 1, bias=False) for k in range(1, 5)}
        for k in range(5):
            layers[f"refinenet{k}"] = FeatureFusionBlock(F, input_length=1 if k == 4 else 2)
        self.heads = [name for name, scale in _HEADS if scale < n_scales]
        for name in self.heads:
            layers[name] = nn.Sequential(Conv2dNHWC(F, F // 2, 3, padding=1),
                                         Conv2dNHWC(F // 2, n_bins, 3, padding=1))
        self.layers = nn.ModuleDict(layers)

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict:
        m = self.layers
        l1 = m["layer1_rn"](features["res2"])
        l2 = m["layer2_rn"](features["res3"])
        l3 = m["layer3_rn"](features["res4"])
        l4 = m["layer4_rn"](features["res5"])
        path3 = m["refinenet3"](m["refinenet4"](l4), l3)
        path2 = m["refinenet2"](path3, l2)
        path1 = m["refinenet1"](path2, l1)
        path0 = m["refinenet0"](path1, interpolate(l1, scale_factor=2, mode="bilinear", align_corners=True))
        paths = {3: path3, 2: path2, 1: path1, 0: path0}
        return {("disp", scale): soft_att_depth(m[name](paths[scale]))
                for name, scale in _HEADS if name in self.heads}
