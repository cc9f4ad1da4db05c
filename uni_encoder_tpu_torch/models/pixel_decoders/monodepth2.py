"""monodepth2-style U-Net disparity decoder (port of
`uni_encoder_tpu/models/pixel_decoders/monodepth2.py`).

Decodes {stem, res2..res5} (monodepth2's encoder widths 64, 64, 128, 256,
512 at strides 2 to 32) through upconv blocks: a reflect-padded 3x3 conv
and ELU, nearest x2 upsampling, the skip concatenated, another reflect conv
and ELU; a reflect conv and a sigmoid give the disparity at scales 0..3
(scale 0 at full resolution). NHWC throughout. The first skip must be at
stride 2: `models/oneformer.py::build_pixel_decoder` refuses a backbone
whose stem is not (no backbone of either package has one).

Parameter names follow the JAX copy's flax names: `upconv_{i}_{0,1}`,
`dispconv_{s}`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ...ops import interpolate
from ..layers import elu, reflect_conv

IN_FEATURES = ("stem", "res2", "res3", "res4", "res5")


class MonodepthDecoder(nn.Module):
    def __init__(self, in_channels: Dict[str, int], num_ch_dec: Sequence[int] = (16, 32, 64, 128, 256),
                 scales: Sequence[int] = (0, 1, 2, 3), use_skips: bool = True,
                 in_features: Sequence[str] = IN_FEATURES):
        super().__init__()
        self.scales = tuple(scales)
        self.use_skips = use_skips
        self.in_features = tuple(in_features)
        enc = [in_channels[f] for f in self.in_features]
        for i in range(4, -1, -1):
            cin = enc[-1] if i == 4 else num_ch_dec[i + 1]
            self.add_module(f"upconv_{i}_0", reflect_conv(cin, num_ch_dec[i]))
            skip = enc[i - 1] if use_skips and i > 0 else 0
            self.add_module(f"upconv_{i}_1", reflect_conv(num_ch_dec[i] + skip, num_ch_dec[i]))
            if i in self.scales:
                self.add_module(f"dispconv_{i}", reflect_conv(num_ch_dec[i], 1))

    def forward(self, features: Dict[str, torch.Tensor]) -> Dict:
        feats = [features[f] for f in self.in_features]
        x = feats[-1]
        outputs = {}
        for i in range(4, -1, -1):
            x = elu(getattr(self, f"upconv_{i}_0")(x))
            x = interpolate(x, scale_factor=2, mode="nearest")
            if self.use_skips and i > 0:
                x = torch.cat([x, feats[i - 1]], dim=-1)
            x = elu(getattr(self, f"upconv_{i}_1")(x))
            if i in self.scales:
                outputs[("disp", i)] = torch.sigmoid(getattr(self, f"dispconv_{i}")(x))
        return outputs
