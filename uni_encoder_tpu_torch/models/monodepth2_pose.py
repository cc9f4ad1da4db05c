"""monodepth2-style pose model, an alternative pose network no config
selects (port of `uni_encoder_tpu/models/monodepth2_pose.py`).

A ResNet encoder over the stacked two-frame (B, H, W, 6) input (the port's
`ResNet` with a 6-channel stem; res5 only) and monodepth2's pose decoder:
a 1x1 squeeze, two 3x3 convs, a 1x1 conv to 6 numbers per frame, the
spatial mean, scaled by 0.01. Returns (axisangle, translation), each
(B, num_frames, 1, 3).

Keys: `encoder.*` the ResNet's d2 names (`stem.conv1(.norm)`,
`res{2..5}.{j}.conv{k}(.norm)`, `.shortcut(.norm)`); `decoder.{squeeze,
pose_0, pose_1, pose_2}` after the JAX copy's flax names.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from .backbones.resnet import ResNet
from .layers import Conv2dNHWC, relu


class Monodepth2PoseDecoder(nn.Module):
    def __init__(self, in_channels: int = 512, num_frames_to_predict_for: int = 2):
        super().__init__()
        self.num_frames = num_frames_to_predict_for
        self.squeeze = Conv2dNHWC(in_channels, 256, 1)
        self.pose_0 = Conv2dNHWC(256, 256, 3, padding=1)
        self.pose_1 = Conv2dNHWC(256, 256, 3, padding=1)
        self.pose_2 = Conv2dNHWC(256, 6 * num_frames_to_predict_for, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        out = relu(self.squeeze(features["res5"]))
        out = relu(self.pose_0(out))
        out = relu(self.pose_1(out))
        out = self.pose_2(out).mean(dim=(1, 2))
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]


class Monodepth2PoseModel(nn.Module):
    """ResNet encoder on a stacked (B, H, W, 6) frame pair + pose decoder."""

    def __init__(self, depth: int = 18):
        super().__init__()
        self.encoder = ResNet(depth=depth, out_features=("res5",), in_channels=6)
        self.decoder = Monodepth2PoseDecoder(self.encoder.out_channels["res5"])

    def forward(self, frame_pair: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.decoder(self.encoder(frame_pair))
