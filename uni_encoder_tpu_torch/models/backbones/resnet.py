"""ResNet backbone with the stem as an output feature (port of
`uni_encoder_tpu/models/backbones/resnet.py`, after the reference's d2
`build_custom_resnet_backbone`).

The stem (7x7/2 conv, BatchNorm, ReLU, 3x3/2 max-pool, stride 4) is an output
feature beside res2..res5. BasicBlock for depths 18 and 34, BottleneckBlock
for 50 and 101; BatchNorm uses its stored statistics in training too
(`FrozenBatchNorm(use_running_average=True)`, as the JAX copy builds every
norm): they never move, while the norms' weights and biases train.
Feature maps are channels-last (B, H, W, C).

Parameter names follow the reference d2 state dict: `backbone.stem.conv1`
and `backbone.stem.conv1.norm`, `backbone.res{2..5}.{j}.conv{k}` and
`.conv{k}.norm`, and `backbone.res{2..5}.{j}.shortcut(.norm)` only in the
blocks that project (a stride or a change of width).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2dNHWC, FrozenBatchNorm, relu

BLOCKS_PER_STAGE = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class ConvBN(Conv2dNHWC):
    """d2 `Conv2d` without bias and with a BatchNorm `norm` child, over NHWC."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1, padding: int = 0):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding, bias=False)
        self.norm = FrozenBatchNorm(out_channels, use_running_average=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(in_channels, out_channels, 3, stride, 1)
        self.conv2 = ConvBN(out_channels, out_channels, 3, 1, 1)
        projects = stride != 1 or in_channels != out_channels
        self.shortcut = ConvBN(in_channels, out_channels, 1, stride) if projects else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(relu(self.conv1(x)))
        return relu(out + (x if self.shortcut is None else self.shortcut(x)))


class BottleneckBlock(nn.Module):
    """The stride is on the 3x3 conv (the JAX copy's default, which no config changes)."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(in_channels, bottleneck, 1)
        self.conv2 = ConvBN(bottleneck, bottleneck, 3, stride, 1)
        self.conv3 = ConvBN(bottleneck, out_channels, 1)
        projects = stride != 1 or in_channels != out_channels
        self.shortcut = ConvBN(in_channels, out_channels, 1, stride) if projects else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(relu(self.conv2(relu(self.conv1(x)))))
        return relu(out + (x if self.shortcut is None else self.shortcut(x)))


class BasicStem(nn.Module):
    def __init__(self, out_channels: int, in_channels: int = 3):
        super().__init__()
        self.conv1 = ConvBN(in_channels, out_channels, 7, 2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = relu(self.conv1(x))
        # torch's max_pool2d(3, 2, padding=1) pads with -inf, as the JAX copy does
        return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class ResNet(nn.Module):
    """Returns {"stem", "res2".."res5"} (those in `out_features`)
    channels-last feature maps, at `out_strides`; `in_channels` is 6 for the
    monodepth2 pose model's stacked frame pair."""

    # the stem comes after the max-pool, as in the JAX copy: stride 4, not 2
    out_strides = {"stem": 4, "res2": 4, "res3": 8, "res4": 16, "res5": 32}

    def __init__(self, depth: int = 18, stem_out_channels: int = 64, res2_out_channels: int = 64,
                 out_features: Sequence[str] = ("stem", "res2", "res3", "res4", "res5"), in_channels: int = 3):
        super().__init__()
        if depth not in BLOCKS_PER_STAGE:
            raise ValueError(f"ResNet depth must be one of {sorted(BLOCKS_PER_STAGE)}, got {depth}")
        self.stem_out_channels = stem_out_channels
        self.res2_out_channels = res2_out_channels
        self.out_features = tuple(out_features)
        self.stem = BasicStem(stem_out_channels, in_channels)
        cin = stem_out_channels
        for i, n_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
            cout = res2_out_channels * 2 ** i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                if depth >= 50:
                    blocks.append(BottleneckBlock(cin, cout, cout // 4, stride))
                else:
                    blocks.append(BasicBlock(cin, cout, stride))
                cin = cout
            self.add_module(f"res{i + 2}", nn.Sequential(*blocks))

    @property
    def out_channels(self) -> Dict[str, int]:
        chans = {"stem": self.stem_out_channels}
        chans.update({f"res{i + 2}": self.res2_out_channels * 2 ** i for i in range(4)})
        return {k: c for k, c in chans.items() if k in self.out_features}

    def forward(self, x: torch.Tensor, drop_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3). ResNet has no stochastic depth: `drop_masks` must be None."""
        if drop_masks is not None:
            raise ValueError("the ResNet backbone has no stochastic depth: drop_masks must be None")
        outs = {}
        x = self.stem(x)
        if "stem" in self.out_features:
            outs["stem"] = x
        for i in range(4):
            x = getattr(self, f"res{i + 2}")(x)
            if f"res{i + 2}" in self.out_features:
                outs[f"res{i + 2}"] = x
        return outs
