"""Shared building blocks (port of `uni_encoder_tpu/models/layers.py`).

Module and parameter names follow the reference's d2 state dict, so a
reference checkpoint loads with `load_state_dict(strict=True)`:

  * `MultiheadAttention`: `in_proj_weight` (3E, E), `in_proj_bias`,
    `out_proj.{weight,bias}` (torch nn.MultiheadAttention packing);
  * `MLP`: `layers.{i}.{weight,bias}`;
  * `FrozenBatchNorm`: `weight`, `bias`, `running_mean`, `running_var`.

Convolutions of the sequence path take and give NHWC tensors
(`Conv2dNHWC`, `reflect_conv`), as the JAX package's do; `GroupNorm32`
normalizes an NHWC tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # torch nn.GELU default = exact erf formulation (the JAX copy passes
    # approximate=False for the same reason)
    return F.gelu(x, approximate="none")


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention semantics, batch-first (B, L, E), no dropout.

    `attn_mask` may be a bool mask (Lq, Lk) or (B, 1|H, Lq, Lk) in which
    True = DISALLOWED (the JAX package's convention; note that
    `F.scaled_dot_product_attention` uses the opposite one), or a float
    additive mask of the same shapes. Logits follow the activation dtype and
    the softmax is the max-subtracted form, as in the JAX copy, so a fully
    masked row gives NaN on both sides.
    """

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        E, H = self.embed_dim, self.num_heads
        Dh = E // H
        B, Lq, _ = query.shape
        Lk = key.shape[1]
        w, b = self.in_proj_weight, self.in_proj_bias
        q = F.linear(query, w[:E], b[:E]).view(B, Lq, H, Dh).transpose(1, 2)
        k = F.linear(key, w[E : 2 * E], b[E : 2 * E]).view(B, Lk, H, Dh).transpose(1, 2)
        v = F.linear(value, w[2 * E :], b[2 * E :]).view(B, Lk, H, Dh).transpose(1, 2)

        logits = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(Dh)
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                logits = logits.masked_fill(attn_mask, float("-inf"))
            else:
                logits = logits + attn_mask
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Lq, E)
        return self.out_proj(out)


class MLP(nn.Module):
    """DETR-style MLP: relu between layers, last layer linear.

    Weights are cast to the input's dtype, so the task MLP can run over raw
    float32 token ids in a bf16 model, as the JAX copy's dtype promotion does.
    """

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims_in, dims_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))
            if i < n - 1:
                x = relu(x)
        return x


class Conv2dNorm(nn.Conv2d):
    """d2 `Conv2d` with a `norm` child (keys `<name>.weight`, `<name>.norm.*`)."""

    def __init__(self, *args, norm: nn.Module, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class Conv2dNHWC(nn.Conv2d):
    """`nn.Conv2d` over NHWC tensors, with NHWC output.

    The permute of a contiguous NHWC tensor is a channels-last NCHW tensor,
    so cuDNN runs a channels-last convolution with no copy, and its
    channels-last output permutes back to a contiguous NHWC tensor.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def reflect_conv(in_channels: int, out_channels: int, kernel_size: int = 3, bias: bool = True) -> Conv2dNHWC:
    """The JAX package's `Conv(padding=kernel_size // 2, padding_mode="reflect")`
    over NHWC: the input reflect-padded (the edge row not repeated, as
    `jnp.pad(mode="reflect")`), then a valid convolution."""
    return Conv2dNHWC(in_channels, out_channels, kernel_size, padding=kernel_size // 2, padding_mode="reflect",
                      bias=bias)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm over the last axis of an NHWC tensor, 32 groups, eps 1e-5,
    affine (torch's defaults; the JAX package's `GroupNorm32`)."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__(num_groups, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """BatchNorm over the last axis of an NHWC tensor, eps 1e-5 (the JAX
    package's `FrozenBatchNorm`): `x * inv + (bias - mean * inv)` with
    `inv = rsqrt(var + eps) * weight`.

    In eval mode `mean` and `var` are the stored statistics. In train mode
    (`module.train()`) they are the batch's, over every axis but the last:
    the mean and `E[x^2] - mean^2`, with gradients through both; the stored
    statistics then move by momentum 0.9 towards the batch mean and the
    unbiased batch variance, in place, as the JAX copy's `batch_stats`
    update does. In a process group (`parallel/mesh.py`) the batch is the
    global one (SyncBN, as the JAX copy under a sharded jit): the sums of x
    and x^2 are summed over the ranks, the gradient flowing back through
    that sum, and every rank makes the same update.

    Like d2's `FrozenBatchNorm2d`, its state dict is exactly `weight`,
    `bias`, `running_mean` and `running_var`: no `num_batches_tracked`,
    which the JAX checkpoint reader drops.

    With `use_running_average=True` (the JAX copy's default, which the
    ResNet backbone keeps in training) the stored statistics are used in
    both modes and never move; `weight` and `bias` still get gradients.
    """

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5, use_running_average: bool = False):
        super().__init__()
        self.eps = eps
        self.use_running_average = use_running_average
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and not self.use_running_average:
            axes = tuple(range(x.ndim - 1))
            n = x.numel() // x.shape[-1] * mesh.world()  # every rank holds as many rows
            sums = mesh.all_reduce_sum(torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes)]))
            mean, mean_sq = (sums / n).chunk(2)
            var = mean_sq - mean * mean
            with torch.no_grad():
                unbiased = var * n / max(n - 1, 1)
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return x * inv + (self.bias - mean * inv)


def drop_path(x: torch.Tensor, rate: float, keep_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Stochastic depth (timm DropPath, the JAX package's `drop_path`):
    `x / (1 - rate) * keep_mask`, with `keep_mask` (B,) of 0s and 1s drawn by
    the caller (Bernoulli with probability 1 - rate). Identity when the rate
    is 0 or no mask is given."""
    if keep_mask is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return x / keep * keep_mask.to(x.dtype).reshape((x.shape[0],) + (1,) * (x.ndim - 1))


def check_drop_masks(drop_masks: Optional[torch.Tensor], n_blocks: int) -> None:
    """A backbone's keep masks are None or one entry per block."""
    if drop_masks is not None and len(drop_masks) != n_blocks:
        raise ValueError(f"drop-path keep masks for {len(drop_masks)} blocks, the backbone has {n_blocks}")


def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter, and every BatchNorm statistic, from `generator`.

    Matrices and conv kernels get N(0, 1/fan_in), norm scales 1 + N(0, 0.01),
    everything else (biases, embeddings, bias tables) N(0, 0.01). BatchNorm
    running means get N(0, 0.01) and running variances 1 + 0.1 |N(0, 1)|.
    The numbers are drawn on the CPU, so a seed gives the same weights on
    every device.
    """
    norm_types = (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm)
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                shape = tuple(p.shape)
                noise = torch.randn(shape, generator=generator, dtype=torch.float32)
                if isinstance(mod, norm_types) and name == "weight":
                    val = 1.0 + 0.1 * noise
                elif p.ndim >= 2 and name.endswith("weight") and not isinstance(mod, nn.Embedding):
                    fan_in = math.prod(shape[1:])
                    val = noise / math.sqrt(fan_in)
                else:
                    val = 0.1 * noise
                p.copy_(val.to(p.dtype))
            if isinstance(mod, FrozenBatchNorm):
                shape = tuple(mod.running_mean.shape)
                mean = 0.1 * torch.randn(shape, generator=generator, dtype=torch.float32)
                var = 1.0 + 0.1 * torch.randn(shape, generator=generator, dtype=torch.float32).abs()
                mod.running_mean.copy_(mean.to(mod.running_mean.dtype))
                mod.running_var.copy_(var.to(mod.running_var.dtype))
