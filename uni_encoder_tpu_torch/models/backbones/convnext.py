"""ConvNeXt backbone (port of `uni_encoder_tpu/models/backbones/convnext.py`,
after the reference's D2ConvNeXt).

A 4x4/4 stem conv + LayerNorm, stages of blocks (7x7 depthwise conv,
LayerNorm, a 4x pointwise MLP with GELU, the LayerScale `gamma`, residual),
LayerNorm + 2x2/2 conv downsampling between stages, and one LayerNorm per
output; emits {res2..res5}. LayerNorms use eps 1e-6. Feature maps are
channels-last (B, H, W, C), so every LayerNorm acts on the last dim.

Stochastic depth (training only): block rates on a linspace from 0 to
`drop_path_rate` over all blocks, applied to the residual branch after
LayerScale; the caller draws one keep mask per block and passes them to
`forward` (the first block's rate is 0, so it ignores its mask, as the JAX
copy draws none for it).

Parameter names follow the reference d2 state dict:
`backbone.downsample_layers.0.{0: conv, 1: norm}`,
`backbone.downsample_layers.{1,2,3}.{0: norm, 1: conv}`,
`backbone.stages.{i}.{j}.{dwconv, norm, pwconv1, pwconv2, gamma}`,
`backbone.norm{i}`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..layers import Conv2dNHWC, check_drop_masks, drop_path, gelu


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.dwconv = Conv2dNHWC(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        # LayerScale exists only with a positive init value, as in the JAX copy
        self.register_parameter("gamma", nn.Parameter(torch.empty(dim)) if layer_scale_init_value > 0 else None)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`keep`: None, or the (B,) drop-path keep mask of the residual branch."""
        y = self.pwconv2(gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        if self.gamma is not None:
            y = self.gamma * y
        return x + drop_path(y, self.drop_path_rate, keep)


class ConvNeXt(nn.Module):
    """Returns {"res2".."res5"} channels-last feature maps. `drop_path_rate`
    is the last block's stochastic-depth rate (training only; `forward`
    applies it when given keep masks)."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3), dims: Sequence[int] = (96, 192, 384, 768),
                 layer_scale_init_value: float = 1e-6, drop_path_rate: float = 0.0):
        super().__init__()
        self.dims = tuple(dims)
        rates = iter(float(r) for r in np.linspace(0.0, drop_path_rate, sum(depths)))
        layers = [nn.Sequential(Conv2dNHWC(3, dims[0], 4, stride=4), nn.LayerNorm(dims[0], eps=1e-6))]
        layers += [nn.Sequential(nn.LayerNorm(dims[i - 1], eps=1e-6), Conv2dNHWC(dims[i - 1], dims[i], 2, stride=2))
                   for i in range(1, len(dims))]
        self.downsample_layers = nn.ModuleList(layers)
        self.stages = nn.ModuleList(
            nn.Sequential(*(ConvNeXtBlock(dims[i], layer_scale_init_value, next(rates)) for _ in range(depths[i])))
            for i in range(len(dims))
        )
        for i, d in enumerate(dims):
            self.add_module(f"norm{i}", nn.LayerNorm(d, eps=1e-6))

    @property
    def out_channels(self) -> Dict[str, int]:
        return {f"res{i + 2}": d for i, d in enumerate(self.dims)}

    def forward(self, x: torch.Tensor, drop_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3), H and W multiples of 32. drop_masks: None (no
        stochastic depth), or (sum(depths), B) keep masks, block by block."""
        check_drop_masks(drop_masks, sum(len(s) for s in self.stages))
        outs = {}
        k = 0
        for i, (down, stage) in enumerate(zip(self.downsample_layers, self.stages)):
            x = down(x)
            for blk in stage:
                x = blk(x, None if drop_masks is None else drop_masks[k])
                k += 1
            outs[f"res{i + 2}"] = getattr(self, f"norm{i}")(x)
        return outs
