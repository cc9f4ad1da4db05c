"""UniEncoder meta-architecture, segmentation path (port of
`uni_encoder_tpu/models/oneformer.py`).

One shared Swin backbone feeds the MSDeformAttn pixel decoder and the
task-conditioned query decoder. The task string is tokenized on the host; the
model feeds the (B, 77) token ids, as floats, through the 2-layer task MLP,
reproducing the reference's quirk of embedding raw token ids.

Module names follow the reference d2 state dict (`backbone.*`,
`sem_seg_head.pixel_decoder.*`, `sem_seg_head.predictor.*`, `task_mlp.*`), so
a reference checkpoint loads with `load_state_dict(strict=True)`. The
sequence path (pose, motion and depth decoders, `forward_sequence`) is not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from .backbones.swin import SwinTransformer
from .layers import MLP, random_init_
from .pixel_decoders.msdeformattn import MSDeformAttnPixelDecoder
from .transformer_decoder import OneFormerQueryDecoder


# length of the tokenized task prompt (config.InputConfig.task_seq_len)
TASK_SEQ_LEN = 77


class SemSegHead(nn.Module):
    def __init__(self, pixel_decoder: nn.Module, predictor: nn.Module):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor


def build_backbone(cfg: ModelConfig) -> SwinTransformer:
    if cfg.backbone.name != "swin":
        raise NotImplementedError(f"backbone {cfg.backbone.name!r} is not ported yet (swin is)")
    c = cfg.backbone.swin
    return SwinTransformer(
        embed_dim=c.embed_dim,
        depths=c.depths,
        num_heads=c.num_heads,
        window=c.window_size,
        mlp_ratio=c.mlp_ratio,
        qkv_bias=c.qkv_bias,
        patch_norm=c.patch_norm,
    )


class UniEncoder(nn.Module):
    """Segmentation serving model.

    Built with random weights drawn from `seed` (a reference checkpoint, or
    weights carried across from the JAX package with
    `engine.convert.state_dict_from_jax`, load on top with
    `load_state_dict(strict=True)`). `device=None` means the GPU and raises
    when none is visible.
    """

    def __init__(self, cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h = cfg.sem_seg_head
        if h.pixel_decoder_name != "MSDeformAttnPixelDecoder":
            raise NotImplementedError(f"pixel decoder {h.pixel_decoder_name!r} is not ported yet")
        of = cfg.one_former
        with torch.device("meta"):
            self.backbone = build_backbone(cfg)
            pixel_decoder = MSDeformAttnPixelDecoder(
                in_channels=self.backbone.out_channels,
                conv_dim=h.convs_dim,
                mask_dim=h.mask_dim,
                transformer_layers=h.transformer_enc_layers,
                n_heads=of.nheads,
                transformer_in_features=h.deformable_transformer_encoder_in_features,
            )
            predictor = OneFormerQueryDecoder(
                num_classes=h.num_classes,
                hidden_dim=of.hidden_dim,
                num_queries=of.num_object_queries,
                nheads=of.nheads,
                dim_feedforward=of.dim_feedforward,
                dec_layers=of.dec_layers - 1,
                class_dec_layers=of.class_dec_layers,
                mask_dim=h.mask_dim,
                use_task_norm=of.use_task_norm,
            )
            self.sem_seg_head = SemSegHead(pixel_decoder, predictor)
            # task MLP consumes raw token ids as floats (reference quirk)
            self.task_mlp = MLP(TASK_SEQ_LEN, of.hidden_dim, of.hidden_dim, 2)
        self.to_empty(device=device)
        random_init_(self, torch.Generator(device="cpu").manual_seed(seed))
        self.to(dtype)
        self.eval()

    @property
    def pixel_decoder(self) -> MSDeformAttnPixelDecoder:
        return self.sem_seg_head.pixel_decoder

    @property
    def predictor(self) -> OneFormerQueryDecoder:
        return self.sem_seg_head.predictor

    @torch.no_grad()
    def forward_segmentation(self, images: torch.Tensor, task_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: (B, H, W, 3) normalized; task_tokens: (B, 77) int.

        Returns pred_logits (B, Q, K+1) and pred_masks (B, Q, H/4, W/4)."""
        task = self.task_mlp(task_tokens.to(torch.float32))
        # dtype-following: the raw-token fp32 input would otherwise promote
        # the whole query-decoder chain to fp32 under a bf16 model
        task = task.to(images.dtype)
        features = self.backbone(images)
        mask_features, _, multi_scale = self.pixel_decoder(features)
        return self.predictor(multi_scale, mask_features, task)

    def forward(self, images: torch.Tensor, task_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.forward_segmentation(images, task_tokens)
