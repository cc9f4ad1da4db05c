"""Swin Transformer backbone (port of `uni_encoder_tpu/models/backbones/swin.py`).

Patch-embed 4x4 conv -> 4 stages of W-MSA/SW-MSA blocks with relative
position bias, cyclic shift and pad/unpad to the window, patch-merging
downsample; emits {res2: C, res3: 2C, res4: 4C, res5: 8C} with one LayerNorm
per output. In training, stochastic depth drops each block's two residual
branches with rates on a linspace from 0 to `drop_path_rate` over all blocks;
the caller draws the keep masks and passes them to `forward`. Feature maps
are channels-last (B, H, W, C) throughout, as in the JAX copy: every op of a
block except the patch-embed conv acts on the last dim.

Parameter names follow the reference d2 state dict:
`backbone.patch_embed.{proj,norm}`, `backbone.layers.{i}.blocks.{j}.{norm1,
attn.qkv, attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1,
mlp.fc2}`, `backbone.layers.{i}.downsample.{norm,reduction}`,
`backbone.norm{i}`.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import drop_path, gelu


@functools.lru_cache(maxsize=32)
def _relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(N, N) index into the (2wh-1)*(2ww-1) bias table (reference swin.py:110-121)."""
    coords_h = np.arange(wh)
    coords_w = np.arange(ww)
    coords = np.stack(np.meshgrid(coords_h, coords_w, indexing="ij"))  # 2, wh, ww
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)  # N, N


@functools.lru_cache(maxsize=128)
def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """Additive (nW, N, N) mask with 0 / -100 entries (reference swin.py:413-440)."""
    img_mask = np.zeros((hp, wp), np.float32)
    h_slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    w_slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for h in h_slices:
        for w in w_slices:
            img_mask[h, w] = cnt
            cnt += 1
    mw = img_mask.reshape(hp // window, window, wp // window, window)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_constant(fn, *args, device: torch.device) -> torch.Tensor:
    """`fn(*args)` (a cached numpy constant) as a tensor kept on `device`:
    a normal tensor even when first asked for under inference_mode, so that
    a training step may use it after a served request."""
    with torch.inference_mode(False):
        return torch.from_numpy(fn(*args)).to(device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window*window, C). H, W must divide by window."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_reverse(windows: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // window) * (W // window))
    x = windows.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.window = window
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) * (2 * window - 1), num_heads)
        )

    def rel_bias(self) -> torch.Tensor:
        N = self.window * self.window
        table = self.relative_position_bias_table
        idx = _device_constant(_relative_position_index, self.window, self.window, device=table.device)
        return table[idx.reshape(-1)].view(N, N, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, attn_mask) -> torch.Tensor:
        # x: (B_, N, C); attn_mask: None or (nW, N, N) additive fp32, B_ = B*nW
        B_, N, C = x.shape
        H = self.num_heads
        Dh = C // H
        qkv = self.qkv(x).view(B_, N, 3, H, Dh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * Dh ** -0.5, qkv[1], qkv[2]
        # dtype-following logits, as the JAX copy; adding the fp32 shift mask
        # promotes to fp32, as jnp's promotion does
        attn = torch.matmul(q, k.transpose(-2, -1)) + self.rel_bias()[None]
        if attn_mask is not None:
            nW = attn_mask.shape[0]
            attn = attn.view(B_ // nW, nW, H, N, N) + attn_mask[None, :, None]
            attn = attn.view(B_, H, N, N)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class SwinMLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0):
        super().__init__()
        self.window = window
        self.shift = shift
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = SwinMLP(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`keep`: None, or (2, B) drop-path keep masks for the attention and
        MLP branches."""
        B, H, W, C = x.shape
        ws = self.window
        pad_b = (ws - H % ws) % ws
        pad_r = (ws - W % ws) % ws
        Hp, Wp = H + pad_b, W + pad_r

        shortcut = x
        x = self.norm1(x)
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        if self.shift > 0:
            x = torch.roll(x, shifts=(-self.shift, -self.shift), dims=(1, 2))
            mask = _device_constant(_shift_attn_mask, Hp, Wp, ws, self.shift, device=x.device)
        else:
            mask = None

        xw = self.attn(window_partition(x, ws), mask)
        x = window_reverse(xw, ws, Hp, Wp)

        if self.shift > 0:
            x = torch.roll(x, shifts=(self.shift, self.shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W]
        keep_attn, keep_mlp = (None, None) if keep is None else keep
        x = shortcut + drop_path(x, self.drop_path_rate, keep_attn)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path_rate, keep_mlp)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x0 = x[:, 0::2, 0::2]
        x1 = x[:, 1::2, 0::2]
        x2 = x[:, 0::2, 1::2]
        x3 = x[:, 1::2, 1::2]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], dim=-1)))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window: int, mlp_ratio: float,
                 qkv_bias: bool, downsample: bool, drop_path_rates: Sequence[float]):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, 0 if j % 2 == 0 else window // 2, mlp_ratio, qkv_bias,
                      drop_path_rates[j])
            for j in range(depth)
        )
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_norm: bool):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, kernel_size=4, stride=4)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5) if patch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (B, H, W, 3) -> (B, H/4, W/4, C)
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x) if self.norm is not None else x


class SwinTransformer(nn.Module):
    """Returns {"res2".."res5"} channels-last (B, H, W, C) feature maps.

    `drop_path_rate` is the last block's stochastic-depth rate (training
    only; `forward` applies it when given keep masks)."""

    def __init__(
        self,
        embed_dim: int = 96,
        depths: Sequence[int] = (2, 2, 6, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window: int = 7,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        patch_norm: bool = True,
        drop_path_rate: float = 0.0,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed(embed_dim, patch_norm)
        n = len(depths)
        # the per-block rates, a linspace over all blocks (reference swin.py)
        self.drop_path_rates = [float(r) for r in np.linspace(0.0, drop_path_rate, sum(depths))]
        first = np.cumsum((0,) + tuple(depths))
        self.layers = nn.ModuleList(
            SwinStage(embed_dim * 2 ** i, depths[i], num_heads[i], window, mlp_ratio, qkv_bias, i < n - 1,
                      self.drop_path_rates[first[i]:first[i + 1]])
            for i in range(n)
        )
        for i in range(n):
            self.add_module(f"norm{i}", nn.LayerNorm(embed_dim * 2 ** i, eps=1e-5))

    @property
    def out_channels(self) -> Dict[str, int]:
        return {f"res{i + 2}": self.embed_dim * 2 ** i for i in range(len(self.layers))}

    def forward(self, x: torch.Tensor, drop_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3), H and W multiples of 32 (size_divisibility).
        drop_masks: None (no stochastic depth), or (sum(depths), 2, B) keep
        masks of 0s and 1s, one per block and residual branch."""
        x = self.patch_embed(x)
        outs = {}
        k = 0  # block index over all stages
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, None if drop_masks is None else drop_masks[k])
                k += 1
            outs[f"res{i + 2}"] = getattr(self, f"norm{i}")(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
