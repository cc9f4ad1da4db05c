"""ResNet-like pose decoder over concatenated two-frame backbone features
(port of `uni_encoder_tpu/models/pose_decoder.py`).

Progressive fusion of the two-frame res2..res5 features into stages of
64/128/256/512 channels, squeeze to 256, three pose convs, a global mean and
0.01-scaled (axisangle, translation) for 2 frames. BatchNorm uses its stored
statistics in eval mode and the batch's in train mode (the JAX copy's
`train_bn`), updating the stored ones.

d2 keys: `layer{1..4}.0` (1x1 projection), `layer{k}.{1,2}` (residual
blocks: `left.{0,1,3,4}` = conv, BN, conv, BN and, only where the stride is
not 1 or the width changes, `shortcut.{0,1}`), `squeeze`,
`convs.pose_{0,1,2}`.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from .layers import Conv2dNHWC, FrozenBatchNorm, relu

STAGE_WIDTHS = (64, 128, 256, 512)
NUM_FRAMES = 2  # (axisangle, translation) pairs predicted per frame pair


class ResidualBlock(nn.Module):
    """conv3x3(stride) - BN - ReLU - conv3x3 - BN, plus the identity or a
    1x1(stride) conv - BN shortcut, then `act`."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 act: Callable[[torch.Tensor], torch.Tensor] = relu):
        super().__init__()
        self.left = nn.Sequential(
            Conv2dNHWC(in_channels, features, 3, stride=stride, padding=1, bias=False),
            FrozenBatchNorm(features),
            nn.ReLU(),
            Conv2dNHWC(features, features, 3, padding=1, bias=False),
            FrozenBatchNorm(features),
        )
        self.shortcut = None
        if stride != 1 or in_channels != features:
            self.shortcut = nn.Sequential(
                Conv2dNHWC(in_channels, features, 1, stride=stride, bias=False),
                FrozenBatchNorm(features),
            )
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = x if self.shortcut is None else self.shortcut(x)
        return self.act(self.left(x) + sc)


def residual_stage(in_channels: int, features: int, stride: int,
                   act: Callable[[torch.Tensor], torch.Tensor] = relu) -> nn.Sequential:
    """A 1x1 projection (with bias), then two residual blocks, the first
    with `stride` (the JAX package's `_Stage` / `_FusionStage`)."""
    return nn.Sequential(Conv2dNHWC(in_channels, features, 1), ResidualBlock(features, features, stride, act),
                         ResidualBlock(features, features, 1, act))


class ResNetLikePoseDecoder(nn.Module):
    """`in_channels`: the widths of the two-frame (concatenated) res2..res5."""

    def __init__(self, in_channels: Dict[str, int]):
        super().__init__()
        prev = 0
        for k, (res, width) in enumerate(zip(("res2", "res3", "res4", "res5"), STAGE_WIDTHS), start=1):
            self.add_module(f"layer{k}", residual_stage(prev + in_channels[res], width, stride=2))
            prev = width
        self.squeeze = Conv2dNHWC(prev, 256, 1)
        self.convs = nn.ModuleDict({
            "pose_0": Conv2dNHWC(256, 256, 3, padding=1),
            "pose_1": Conv2dNHWC(256, 256, 3, padding=1),
            "pose_2": Conv2dNHWC(256, 6 * NUM_FRAMES, 1),
        })

    def forward(self, features: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.layer1(features["res2"])
        out = self.layer2(torch.cat([out, features["res3"]], dim=-1))
        out = self.layer3(torch.cat([out, features["res4"]], dim=-1))
        out = self.layer4(torch.cat([out, features["res5"]], dim=-1))
        out = relu(self.squeeze(out))
        out = relu(self.convs["pose_0"](out))
        out = relu(self.convs["pose_1"](out))
        out = self.convs["pose_2"](out)
        out = out.mean(dim=(1, 2))  # global average over H, W
        out = 0.01 * out.reshape(-1, NUM_FRAMES, 1, 6)
        return out[..., :3], out[..., 3:]  # axisangle, translation
