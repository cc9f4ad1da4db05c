"""CLIP-style causal text encoder for the query-text contrastive branch
(port of `uni_encoder_tpu/models/text_transformer.py`: `TextTransformer`,
`ResidualAttentionBlock`, `TextProjector`).

Token embedding plus learned positions, pre-norm residual attention blocks
with a causal -inf mask and a QuickGELU MLP, a final LayerNorm, and the
features at the end-of-text token (the argmax of the token ids). Training
only, as in the reference. `ContextDecoder` is not ported.

Parameter names follow the reference OneFormer state dict (OpenAI CLIP's
text tower): `token_embedding.weight`, `positional_embedding`,
`transformer.resblocks.{i}.{ln_1, attn, ln_2, mlp.c_fc, mlp.c_proj}`,
`ln_final`; the projector's `layers.{i}`.
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
