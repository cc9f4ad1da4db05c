"""DiNAT backbone, dilated neighborhood attention (port of
`uni_encoder_tpu/models/backbones/dinat.py`, after the reference's D2DiNAT).

A ConvTokenizer (two 3x3/2 convs + LayerNorm, stride 4), four levels of NAT
layers (LayerNorm, neighborhood attention with a per-block dilation from the
config, LayerNorm, MLP with GELU, each residual), a ConvDownsampler (3x3/2
conv without bias + LayerNorm) after each level but the last, and one
LayerNorm per output; emits {res2..res5}. LayerNorms use eps 1e-5. Feature
maps are channels-last (B, H, W, C).

The attention reads q, k and v in place from the qkv projection's
(B, H, W, 3, heads, dh) output: `ops.neighborhood_attention_2d_qkv`, which
runs the CUDA kernel K4 on the card (one launch per NAT layer) and, when
autograd needs it, the backward kernel K5, which writes the gradient of
that whole output at once; on the CPU the plain version and its autograd.

Stochastic depth (training only): block rates on a linspace from 0 to
`drop_path_rate` over all blocks; the caller draws two keep masks per block
(the attention branch, then the MLP branch) and passes them to `forward`
(the first block's rate is 0, so it ignores its masks).

Parameter names follow the reference d2 state dict:
`backbone.patch_embed.proj.{0,1}`, `backbone.patch_embed.norm`,
`backbone.levels.{i}.blocks.{j}.{norm1, attn.qkv, attn.rpb, attn.proj,
norm2, mlp.fc1, mlp.fc2}`, `backbone.levels.{i}.downsample.{reduction,
norm}`, `backbone.norm{i}`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...ops.neighborhood_attention import neighborhood_attention_2d_qkv
from ..layers import Conv2dNHWC, check_drop_masks, drop_path, gelu


class NeighborhoodAttention2D(nn.Module):
    def __init__(self, dim: int, num_heads: int, kernel_size: int = 7, dilation: int = 1, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.rpb = nn.Parameter(torch.empty(num_heads, 2 * kernel_size - 1, 2 * kernel_size - 1))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        dh = C // self.num_heads
        qkv = self.qkv(x).view(B, H, W, 3, self.num_heads, dh)
        out = neighborhood_attention_2d_qkv(qkv, self.rpb, self.kernel_size, self.dilation, scale=dh ** -0.5)
        return self.proj(out.reshape(B, H, W, C))


class NATMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class NATLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, kernel_size: int = 7, dilation: int = 1, mlp_ratio: float = 3.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = NeighborhoodAttention2D(dim, num_heads, kernel_size, dilation)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = NATMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`keep`: None, or (2, B) drop-path keep masks for the attention and
        the MLP branch."""
        keep_attn, keep_mlp = (None, None) if keep is None else keep
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path_rate, keep_attn)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path_rate, keep_mlp)


class ConvTokenizer(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.proj = nn.Sequential(Conv2dNHWC(3, embed_dim // 2, 3, stride=2, padding=1),
                                  Conv2dNHWC(embed_dim // 2, embed_dim, 3, stride=2, padding=1))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x))


class ConvDownsampler(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = Conv2dNHWC(dim, 2 * dim, 3, stride=2, padding=1, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.reduction(x))


class NATLevel(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, kernel_size: int, dilations: Sequence[int],
                 mlp_ratio: float, downsample: bool, drop_path_rates: Sequence[float]):
        super().__init__()
        self.blocks = nn.ModuleList(NATLayer(dim, num_heads, kernel_size, dilations[j], mlp_ratio, drop_path_rates[j])
                                    for j in range(depth))
        self.downsample = ConvDownsampler(dim) if downsample else None


class DiNAT(nn.Module):
    """Returns {"res2".."res5"} channels-last feature maps. `dilations[i][j]`
    is block j's dilation in level i; `drop_path_rate` the last block's
    stochastic-depth rate (training only; `forward` applies it when given
    keep masks)."""

    def __init__(self, embed_dim: int, depths: Sequence[int], num_heads: Sequence[int],
                 dilations: Sequence[Sequence[int]], kernel_size: int = 7, mlp_ratio: float = 3.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        n = len(depths)
        if [len(d) for d in dilations] != list(depths):
            raise ValueError(f"dilations {dilations} do not match depths {depths}")
        self.patch_embed = ConvTokenizer(embed_dim)
        rates = [float(r) for r in np.linspace(0.0, drop_path_rate, sum(depths))]
        first = np.cumsum([0, *depths])
        self.levels = nn.ModuleList(
            NATLevel(embed_dim * 2 ** i, depths[i], num_heads[i], kernel_size, dilations[i], mlp_ratio, i < n - 1,
                     rates[first[i]:first[i + 1]])
            for i in range(n)
        )
        for i in range(n):
            self.add_module(f"norm{i}", nn.LayerNorm(embed_dim * 2 ** i, eps=1e-5))

    @property
    def out_channels(self) -> Dict[str, int]:
        return {f"res{i + 2}": self.embed_dim * 2 ** i for i in range(len(self.levels))}

    def forward(self, x: torch.Tensor, drop_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3), H and W multiples of 32. drop_masks: None (no
        stochastic depth), or (sum(depths), 2, B) keep masks, block by block."""
        check_drop_masks(drop_masks, sum(len(level.blocks) for level in self.levels))
        x = self.patch_embed(x)
        outs = {}
        k = 0
        for i, level in enumerate(self.levels):
            for blk in level.blocks:
                x = blk(x, None if drop_masks is None else drop_masks[k])
                k += 1
            outs[f"res{i + 2}"] = getattr(self, f"norm{i}")(x)
            if level.downsample is not None:
                x = level.downsample(x)
        return outs
