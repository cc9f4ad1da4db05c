"""ConvNeXt backbone (port of `uni_encoder_tpu/models/backbones/convnext.py`,
after the reference's D2ConvNeXt).

A 4x4/4 stem conv + LayerNorm, stages of blocks (7x7 depthwise conv,
LayerNorm, a 4x pointwise MLP with GELU, the LayerScale `gamma`, residual),
LayerNorm + 2x2/2 conv downsampling between stages, and one LayerNorm per
output; emits {res2..res5}. LayerNorms use eps 1e-6. Feature maps are
channels-last (B, H, W, C), so every LayerNorm acts on the last dim.

Parameter names follow the reference d2 state dict:
`backbone.downsample_layers.0.{0: conv, 1: norm}`,
`backbone.downsample_layers.{1,2,3}.{0: norm, 1: conv}`,
`backbone.stages.{i}.{j}.{dwconv, norm, pwconv1, pwconv2, gamma}`,
`backbone.norm{i}`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..layers import Conv2dNHWC, gelu


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dwconv = Conv2dNHWC(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        # LayerScale exists only with a positive init value, as in the JAX copy
        self.register_parameter("gamma", nn.Parameter(torch.empty(dim)) if layer_scale_init_value > 0 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv2(gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        if self.gamma is not None:
            y = self.gamma * y
        return x + y


class ConvNeXt(nn.Module):
    """Returns {"res2".."res5"} channels-last feature maps."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3), dims: Sequence[int] = (96, 192, 384, 768),
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dims = tuple(dims)
        layers = [nn.Sequential(Conv2dNHWC(3, dims[0], 4, stride=4), nn.LayerNorm(dims[0], eps=1e-6))]
        layers += [nn.Sequential(nn.LayerNorm(dims[i - 1], eps=1e-6), Conv2dNHWC(dims[i - 1], dims[i], 2, stride=2))
                   for i in range(1, len(dims))]
        self.downsample_layers = nn.ModuleList(layers)
        self.stages = nn.ModuleList(
            nn.Sequential(*(ConvNeXtBlock(dims[i], layer_scale_init_value) for _ in range(depths[i])))
            for i in range(len(dims))
        )
        for i, d in enumerate(dims):
            self.add_module(f"norm{i}", nn.LayerNorm(d, eps=1e-6))

    @property
    def out_channels(self) -> Dict[str, int]:
        return {f"res{i + 2}": d for i, d in enumerate(self.dims)}

    def forward(self, x: torch.Tensor, drop_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3), H and W multiples of 32. Stochastic depth is not
        ported for ConvNeXt: `drop_masks` must be None."""
        if drop_masks is not None:
            raise NotImplementedError("drop-path keep masks are not ported for the ConvNeXt backbone")
        outs = {}
        for i, (down, stage) in enumerate(zip(self.downsample_layers, self.stages)):
            x = stage(down(x))
            outs[f"res{i + 2}"] = getattr(self, f"norm{i}")(x)
        return outs
