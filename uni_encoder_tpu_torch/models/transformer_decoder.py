"""Task-conditioned multi-scale masked query decoder (port of
`uni_encoder_tpu/models/transformer_decoder.py`).

  * Q queries; the last is the task token; the other Q-1 are seeded by a
    2-layer DETR decoder ("class transformer") whose memory is the sine PE of
    the mask features and whose key pos-embed is the 1x1-projected mask
    features (the reference's src/pos swap, reproduced as the JAX copy does).
  * dec_layers rounds of masked cross-attention -> self-attention -> FFN
    cycling over the feature levels; each round's attention mask comes from
    the previous round's masks computed at the level's resolution from
    mask features pre-resized to that level (bilinear resize and the mask
    product commute), thresholded at sigmoid < 0.5, with fully masked rows
    un-masked.
  * Serving keeps only the last round's predictions. With `is_train`, the
    predictions after the seed and after every round are all made (deep
    supervision): `aux_outputs` holds all but the last, and
    `contrastive_logits` the seeded queries (B, Q, C).

Parameter names follow the reference d2 state dict under
`sem_seg_head.predictor.`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import position_embedding_sine, resize_hw
from .layers import MLP, MultiheadAttention, relu


class DETRDecoderLayer(nn.Module):
    """Post-norm DETR decoder layer."""

    def __init__(self, d_model: int, nheads: int, dim_feedforward: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nheads)
        self.multihead_attn = MultiheadAttention(d_model, nheads)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, pos, query_pos):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory))
        return self.norm3(tgt + self.linear2(relu(self.linear1(tgt))))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nheads: int):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d_model, nheads)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, memory_mask, pos, query_pos):
        return self.norm(tgt + self.multihead_attn(tgt + query_pos, memory + pos, memory, attn_mask=memory_mask))


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, nheads: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nheads)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        return self.norm(tgt + self.self_attn(q, q, tgt))


class FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(relu(self.linear1(tgt))))


class _ClassDecoder(nn.Module):
    def __init__(self, d_model: int, nheads: int, dim_feedforward: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(DETRDecoderLayer(d_model, nheads, dim_feedforward) for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=1e-5)


class _ClassTransformer(nn.Module):
    def __init__(self, d_model: int, nheads: int, dim_feedforward: int, num_layers: int):
        super().__init__()
        self.decoder = _ClassDecoder(d_model, nheads, dim_feedforward, num_layers)


class OneFormerQueryDecoder(nn.Module):
    def __init__(
        self,
        num_classes: int = 19,
        hidden_dim: int = 256,
        num_queries: int = 150,
        nheads: int = 8,
        dim_feedforward: int = 2048,
        dec_layers: int = 9,  # cfg DEC_LAYERS - 1
        class_dec_layers: int = 2,
        mask_dim: int = 256,
        num_feature_levels: int = 3,
        use_task_norm: bool = True,
        is_train: bool = False,
    ):
        super().__init__()
        C = hidden_dim
        self.is_train = is_train
        self.hidden_dim = C
        self.num_queries = num_queries
        self.num_feature_levels = num_feature_levels
        self.use_task_norm = use_task_norm
        self.query_embed = nn.Embedding(num_queries, C)
        self.level_embed = nn.Embedding(num_feature_levels, C)
        self.class_input_proj = nn.Conv2d(mask_dim, C, kernel_size=1)
        self.decoder_norm = nn.LayerNorm(C, eps=1e-5)
        self.class_embed = nn.Linear(C, num_classes + 1)
        self.mask_embed = MLP(C, C, mask_dim, 3)
        self.class_transformer = _ClassTransformer(C, nheads, dim_feedforward, class_dec_layers)
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(C, nheads) for _ in range(dec_layers)
        )
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(C, nheads) for _ in range(dec_layers)
        )
        self.transformer_ffn_layers = nn.ModuleList(FFNLayer(C, dim_feedforward) for _ in range(dec_layers))

    def forward(
        self,
        multi_scale_features: Sequence[torch.Tensor],  # low-res -> high-res, (B, C, h, w)
        mask_features: torch.Tensor,  # (B, mask_dim, H4, W4)
        task_embedding: torch.Tensor,  # (B, hidden_dim)
    ):
        C = self.hidden_dim
        Q = self.num_queries
        B, _, mh, mw = mask_features.shape
        L = self.num_feature_levels
        if len(multi_scale_features) != L:
            raise ValueError(f"expected {L} feature levels, got {len(multi_scale_features)}")
        dev = mask_features.device

        srcs, poss, sizes = [], [], []
        for i in range(L):
            x = multi_scale_features[i]
            h, w = x.shape[2], x.shape[3]
            sizes.append((h, w))
            poss.append(position_embedding_sine(h, w, C // 2, device=dev).reshape(1, h * w, C).to(x.dtype))
            srcs.append(x.flatten(2).transpose(1, 2) + self.level_embed.weight[i][None, None])

        # ---- seed queries with the class transformer
        tasks = task_embedding[:, None, :]
        if self.use_task_norm:
            tasks = self.decoder_norm(tasks)
        pe_mask = position_embedding_sine(mh, mw, C // 2, device=dev).reshape(1, mh * mw, C)
        pe_mask = pe_mask.expand(B, -1, -1).to(mask_features.dtype)
        proj_mask = self.class_input_proj(mask_features).flatten(2).transpose(1, 2)

        query_embed = self.query_embed.weight
        tgt = tasks.expand(B, Q - 1, C)
        cls_query_pos = query_embed[None, : Q - 1].expand(B, -1, -1)
        for layer in self.class_transformer.decoder.layers:
            # the class transformer's memory is the PE map; the projected
            # features ride along as the key pos-embed (reference quirk)
            tgt = layer(tgt, pe_mask, proj_mask, cls_query_pos)
        out_t = self.class_transformer.decoder.norm(tgt)

        output = torch.cat([out_t, tasks], dim=1)  # (B, Q, C)
        initial_queries = output  # the contrastive features are the seeded queries
        query_pos = query_embed[None].expand(B, -1, -1)

        mask_feats_at_level = [
            resize_hw(mask_features, sizes[i], dims=(2, 3), mode="bilinear", align_corners=False).flatten(2)
            for i in range(L)
        ]  # (B, mask_dim, h*w)
        mask_feats_full = mask_features.flatten(2)

        def attn_mask_for(output, level):
            emb = self.mask_embed(self.decoder_norm(output))  # (B, Q, mask_dim)
            logits_lvl = torch.matmul(emb, mask_feats_at_level[level])
            masked = torch.sigmoid(logits_lvl) < 0.5  # True = not allowed
            masked = masked & ~masked.all(dim=-1, keepdim=True)  # un-mask fully masked rows
            return masked[:, None], emb

        def predict(output, emb):
            return (self.class_embed(self.decoder_norm(output)),
                    torch.matmul(emb, mask_feats_full).view(B, Q, mh, mw))  # (B, Q, H4, W4)

        predictions = []
        attn_mask, emb = attn_mask_for(output, 0)
        if self.is_train:
            predictions.append(predict(output, emb))
        n_rounds = len(self.transformer_cross_attention_layers)
        for i in range(n_rounds):
            lvl = i % L
            output = self.transformer_cross_attention_layers[i](output, srcs[lvl], attn_mask, poss[lvl], query_pos)
            output = self.transformer_self_attention_layers[i](output, query_pos)
            output = self.transformer_ffn_layers[i](output)
            attn_mask, emb = attn_mask_for(output, (i + 1) % L)
            if self.is_train:
                predictions.append(predict(output, emb))

        logits, masks = predictions[-1] if self.is_train else predict(output, emb)
        out = {"pred_logits": logits, "pred_masks": masks}
        if self.is_train:
            out["aux_outputs"] = [{"pred_logits": c, "pred_masks": m} for c, m in predictions[:-1]]
            out["contrastive_logits"] = initial_queries
        return out
