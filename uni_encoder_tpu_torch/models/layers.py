"""Shared building blocks (port of `uni_encoder_tpu/models/layers.py`).

Module and parameter names follow the reference's d2 state dict, so a
reference checkpoint loads with `load_state_dict(strict=True)`:

  * `MultiheadAttention`: `in_proj_weight` (3E, E), `in_proj_bias`,
    `out_proj.{weight,bias}` (torch nn.MultiheadAttention packing);
  * `MLP`: `layers.{i}.{weight,bias}`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # torch nn.GELU default = exact erf formulation (the JAX copy passes
    # approximate=False for the same reason)
    return F.gelu(x, approximate="none")


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention semantics, batch-first (B, L, E), inference.

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


def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from `generator` with fan-in-scaled values.

    Matrices and conv kernels get N(0, 1/fan_in), norm scales 1 + N(0, 0.01),
    everything else (biases, embeddings, bias tables) N(0, 0.01). The
    numbers are drawn on the CPU, so a seed gives the same weights on every
    device.
    """
    norm_types = (nn.LayerNorm, nn.GroupNorm)
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
