"""Coarse-to-fine motion decoder (port of
`uni_encoder_tpu/models/motion_decoder.py::MotionDecoderV2`).

Seeds a motion field from 100x the ego-motion vector through a 1x1 conv,
then refines it scale by scale, res5 to full resolution, with conv/squeeze
residual stages over the concatenated two-frame features and the full-res
RGB pair. out_dim=3 gives ("complete_flow", s) = 0.005 * out; out_dim=1
gives ("motion_prob", s) = 0.005 * out and ("motion_mask", s), its sigmoid.
BatchNorm (in `layer0`) follows the module's train/eval mode.
The model holds two: `motion_decoder` (flow) and `motion_mask`.

d2 keys: `layer0.*` (a residual stage with ELU blocks), `conv{s}.{0,1}`,
`squeeze{s}` for s = 0..5, `res_trans_conv`. `MotionDecoderV1` (the
`monodepth2_pose` variant) is not ported.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..ops import interpolate
from .layers import Conv2dNHWC, elu, relu
from .pose_decoder import residual_stage


class MotionDecoderV2(nn.Module):
    """`in_channels`: the widths of the two-frame (concatenated) res2..res5."""

    # output widths of the per-stage convs (stage 0 = RGB pair, 1 = refined
    # res2, 2..5 = two-frame res2..res5): fixed, whatever the backbone's widths
    num_inp_feat = (6, 64, 192, 384, 768, 1536)

    def __init__(self, in_channels: Dict[str, int], out_dim: int = 3, n_scales: int = 4):
        super().__init__()
        if out_dim not in (1, 3):
            raise ValueError(f"out_dim={out_dim}")
        self.out_dim = out_dim
        self.n_scales = n_scales
        self.layer0 = residual_stage(in_channels["res2"], 64, stride=1, act=elu)
        feat_channels = (6, 64) + tuple(in_channels[f"res{i}"] for i in range(2, 6))
        for idx, (feat, ch) in enumerate(zip(feat_channels, self.num_inp_feat)):
            self.add_module(f"conv{idx}", nn.ModuleList([
                Conv2dNHWC(out_dim + feat, ch, 3, padding=1),
                Conv2dNHWC(ch, ch, 3, padding=1),
            ]))
            self.add_module(f"squeeze{idx}", Conv2dNHWC(2 * ch, out_dim, 1))
        self.res_trans_conv = Conv2dNHWC(6, out_dim, 1)

    def _stage(self, idx: int, feat: torch.Tensor, motion_src: torch.Tensor) -> torch.Tensor:
        motion_field = interpolate(motion_src, size=feat.shape[1:3], mode="bilinear", align_corners=False)
        conv_a, conv_b = getattr(self, f"conv{idx}")
        xa = conv_a(torch.cat([motion_field, feat], dim=-1))
        xb = relu(conv_b(xa))
        return getattr(self, f"squeeze{idx}")(torch.cat([xa, xb], dim=-1)) + motion_field

    def forward(
        self,
        full_res_input: torch.Tensor,  # (B, H, W, 6) two-frame RGB
        features: Dict[str, torch.Tensor],  # concatenated two-frame res2..res5
        ego_motion: torch.Tensor,  # (B, 1, 1, 6) [translation || axisangle]
    ) -> Dict:
        # the refined res2 branch passes no gradient back into the backbone
        feat1 = interpolate(features["res2"].detach(), scale_factor=2, mode="bilinear", align_corners=False)
        feat1 = self.layer0(feat1)
        # a 1x1 seed, resized to res5 by the first stage
        res_trans = self.res_trans_conv(100.0 * ego_motion)
        out5 = self._stage(5, features["res5"], res_trans)
        out4 = self._stage(4, features["res4"], out5)
        out3 = self._stage(3, features["res3"], out4)
        out2 = self._stage(2, features["res2"], out3)
        out1 = self._stage(1, feat1, out2)
        out0 = self._stage(0, full_res_input, out1)

        outs = {}
        for scale, o in enumerate((out0, out1, out2, out3)[: self.n_scales]):
            if self.out_dim == 1:
                outs[("motion_prob", scale)] = 0.005 * o
                outs[("motion_mask", scale)] = torch.sigmoid(0.005 * o)
            else:
                outs[("complete_flow", scale)] = 0.005 * o
        return outs
