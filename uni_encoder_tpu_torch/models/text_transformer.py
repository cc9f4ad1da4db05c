"""CLIP-style causal text encoder for the query-text contrastive branch
(port of `uni_encoder_tpu/models/text_transformer.py`: `TextTransformer`,
`ResidualAttentionBlock`, `TextProjector`, and `ContextDecoder`, which no
config selects).

Token embedding plus learned positions, pre-norm residual attention blocks
with a causal -inf mask and a QuickGELU MLP, a final LayerNorm, and the
features at the end-of-text token (the argmax of the token ids). Training
only, as in the reference.

`ContextDecoder` contextualizes text embeddings with projected visual
features: pre-norm layers of self attention, cross attention to the visual
memory (separate q / k / v projections, no bias) and an exact-GELU MLP.

Parameter names follow the reference OneFormer state dict (OpenAI CLIP's
text tower): `token_embedding.weight`, `positional_embedding`,
`transformer.resblocks.{i}.{ln_1, attn, ln_2, mlp.c_fc, mlp.c_proj}`,
`ln_final`; the projector's `layers.{i}`. `ContextDecoder`'s follow the
reference's (text_transformer.py:32-149, DenseCLIP's): `memory_proj.{0,1,2}`
(LayerNorm, Linear, LayerNorm), `text_proj.{0,1}`, `decoder.{i}.{norm1,
norm2, norm3, self_attn, cross_attn, mlp.0, mlp.3}` with each attention's
`q_proj`, `k_proj`, `v_proj`, `proj`, and `out_proj.{0,1}`.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import MLP, MultiheadAttention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _ResidualMLP(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.c_fc = nn.Linear(d_model, 4 * d_model)
        self.c_proj = nn.Linear(4 * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d_model, eps=1e-5)
        self.attn = MultiheadAttention(d_model, n_head)
        self.ln_2 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp = _ResidualMLP(d_model)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        y = self.ln_1(x)
        x = x + self.attn(y, y, y, attn_mask=causal_mask)
        return x + self.mlp(self.ln_2(x))


class _Blocks(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))


class TextTransformer(nn.Module):
    def __init__(self, context_length: int = 77, width: int = 256, layers: int = 6, vocab_size: int = 49408):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = _Blocks(width, layers, max(1, width // 64))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        """text: (B, L) int token ids -> (B, width) end-of-text features."""
        B, L = text.shape
        x = self.token_embedding(text) + self.positional_embedding[None, :L]
        causal = torch.triu(torch.full((L, L), float("-inf"), device=x.device), diagonal=1)
        for block in self.transformer.resblocks:
            x = block(x, causal)
        x = self.ln_final(x)
        return x[torch.arange(B, device=x.device), text.argmax(dim=-1)]


class TextProjector(MLP):
    """The `proj_num_layers`-layer MLP from the text width to `hidden_dim`."""

    def __init__(self, width: int, hidden_dim: int = 256, num_layers: int = 2):
        super().__init__(width, hidden_dim, hidden_dim, num_layers)


class _SeparateQKVAttention(nn.Module):
    """Attention with separate q / k / v projections (no bias) and an output
    projection; (B, N, dim) queries over (B, M, dim) keys and values."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim, bias=False)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        B, N, C = q.shape
        M, H = k.shape[1], self.num_heads
        q = self.q_proj(q).reshape(B, N, H, C // H).transpose(1, 2)
        k = self.k_proj(k).reshape(B, M, H, C // H).transpose(1, 2)
        v = self.v_proj(v).reshape(B, M, H, C // H).transpose(1, 2)
        attn = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) * (C // H) ** -0.5, dim=-1)
        return self.proj(torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C))


class _ContextDecoderLayer(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.self_attn = _SeparateQKVAttention(width, heads)
        self.cross_attn = _SeparateQKVAttention(width, heads)
        self.norm1 = nn.LayerNorm(width, eps=1e-5)
        self.norm2 = nn.LayerNorm(width, eps=1e-5)
        self.norm3 = nn.LayerNorm(width, eps=1e-5)
        # the reference's Sequential(Linear, GELU, Dropout, Linear); exact GELU
        self.mlp = nn.Sequential(nn.Linear(width, 4 * width), nn.GELU(approximate="none"), nn.Identity(),
                                 nn.Linear(4 * width, width))

    def forward(self, x: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        x = x + self.self_attn(y, y, y)
        x = x + self.cross_attn(self.norm2(x), mem, mem)
        return x + self.mlp(self.norm3(x))


class ContextDecoder(nn.Module):
    """text (B, N, visual_dim), visual (B, M, visual_dim) -> (B, N,
    visual_dim). Training only in the reference (its prompt context is None
    at inference)."""

    def __init__(self, transformer_width: int = 256, transformer_heads: int = 4, transformer_layers: int = 6,
                 visual_dim: int = 1024):
        super().__init__()
        W = transformer_width
        self.memory_proj = nn.Sequential(nn.LayerNorm(visual_dim, eps=1e-5), nn.Linear(visual_dim, W),
                                         nn.LayerNorm(W, eps=1e-5))
        self.text_proj = nn.Sequential(nn.LayerNorm(visual_dim, eps=1e-5), nn.Linear(visual_dim, W))
        self.decoder = nn.ModuleList(_ContextDecoderLayer(W, transformer_heads) for _ in range(transformer_layers))
        self.out_proj = nn.Sequential(nn.LayerNorm(W, eps=1e-5), nn.Linear(W, visual_dim))

    def forward(self, text: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        mem = self.memory_proj(visual)
        x = self.text_proj(text)
        for layer in self.decoder:
            x = layer(x, mem)
        return self.out_proj(x)
