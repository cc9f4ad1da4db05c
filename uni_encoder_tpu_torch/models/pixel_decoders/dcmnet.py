"""DCMNet, a UPerNet-style PSP + FPN disparity decoder (port of
`uni_encoder_tpu/models/pixel_decoders/dcmnet.py`).

A pyramid pooling module over res5 (adaptive average pools to 1, 2, 3 and
6 bins, each a 1x1 ConvModule, resized back bilinearly) and a 3x3
bottleneck; FPN laterals fused top-down; per scale a 3x3 `fpn_bottleneck`
over the finer FPN outputs resized to twice that scale's resolution, and a
1x1 sigmoid disparity head. mmcv's ConvModule (conv + SyncBN + ReLU) is
conv + `FrozenBatchNorm` with its stored statistics + ReLU, as in the JAX
copy. NHWC throughout. Returns {("disp", s): (B, H / 2^(s+1), W / 2^(s+1),
1)} for s = 0..3: scale 0 is at stride 2.

Parameter names follow the JAX copy's flax names (mmcv's ConvModule
children are `conv` and `bn`): `psp_{i}.{conv, bn}`, `bottleneck`,
`lateral_{i}`, `fpn_{i}`, `fpn_bottleneck_{s}`, `last_layer_{s}`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import interpolate
from ..layers import Conv2dNHWC, FrozenBatchNorm, relu


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """`AdaptiveAvgPool2d((out, out))` on NHWC: bin i of an axis of length n
    averages [floor(i n / out), ceil((i + 1) n / out)), as the JAX copy's
    loop of slices does (held equal at sizes that do not divide)."""
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)


class ConvModule(nn.Module):
    """Conv (no bias, padding kernel // 2) + BatchNorm with its stored
    statistics + ReLU, over NHWC."""

    def __init__(self, in_channels: int, features: int, kernel: int = 1):
        super().__init__()
        self.conv = Conv2dNHWC(in_channels, features, kernel, padding=kernel // 2, bias=False)
        self.bn = FrozenBatchNorm(features, use_running_average=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu(self.bn(self.conv(x)))


class DCMNet(nn.Module):
    def __init__(self, in_channels: Dict[str, int], pool_scales: Sequence[int] = (1, 2, 3, 6), channels: int = 512,
                 in_features: Sequence[str] = ("res2", "res3", "res4", "res5")):
        super().__init__()
        C = channels
        self.pool_scales = tuple(pool_scales)
        self.in_features = tuple(in_features)
        widths = [in_channels[f] for f in self.in_features]
        for si in range(len(self.pool_scales)):
            self.add_module(f"psp_{si}", ConvModule(widths[-1], C, 1))
        self.bottleneck = ConvModule(widths[-1] + len(self.pool_scales) * C, C, 3)
        n = len(widths)
        for i in range(n - 1):
            self.add_module(f"lateral_{i}", ConvModule(widths[i], C, 1))
        for i in range(n - 1):
            self.add_module(f"fpn_{i}", ConvModule(C, C, 3))
        for scale in range(3, -1, -1):
            self.add_module(f"fpn_bottleneck_{scale}", ConvModule((n - scale) * C, C, 3))
            self.add_module(f"last_layer_{scale}", Conv2dNHWC(C, 1, 1))

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict:
        inputs = [features[f] for f in self.in_features]
        x = inputs[-1]
        psp_outs = [x]
        for si, s in enumerate(self.pool_scales):
            p = getattr(self, f"psp_{si}")(adaptive_avg_pool(x, s))
            psp_outs.append(interpolate(p, size=x.shape[1:3], mode="bilinear", align_corners=False))
        laterals = [getattr(self, f"lateral_{i}")(inputs[i]) for i in range(len(inputs) - 1)]
        laterals.append(self.bottleneck(torch.cat(psp_outs, dim=-1)))

        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + interpolate(laterals[i], size=laterals[i - 1].shape[1:3],
                                                            mode="bilinear", align_corners=False)
        fpn_outs = [getattr(self, f"fpn_{i}")(laterals[i]) for i in range(len(laterals) - 1)]
        fpn_outs.append(laterals[-1])

        outputs = {}
        for scale in range(3, -1, -1):
            temp = fpn_outs[scale:]
            h, w = 2 * temp[0].shape[1], 2 * temp[0].shape[2]
            temp = [interpolate(t, size=(h, w), mode="bilinear", align_corners=False) for t in temp]
            out = getattr(self, f"fpn_bottleneck_{scale}")(torch.cat(temp, dim=-1))
            outputs[("disp", scale)] = torch.sigmoid(getattr(self, f"last_layer_{scale}")(out))
        return outputs
