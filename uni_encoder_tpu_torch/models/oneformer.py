"""UniEncoder meta-architecture (port of `uni_encoder_tpu/models/oneformer.py`).

One shared Swin backbone feeds (a) the MSDeformAttn pixel decoder and the
task-conditioned query decoder for segmentation items, and (b) the two-frame
pose / motion / depth decoders for sequence items. The task string is
tokenized on the host; the model feeds the (B, 77) token ids, as floats,
through the 2-layer task MLP, reproducing the reference's quirk of embedding
raw token ids. A sequence item's two frames go through the backbone as one
2B batch.

Module names follow the reference d2 state dict (`backbone.*`,
`sem_seg_head.{pixel_decoder,predictor,depth_decoder}.*`, `task_mlp.*`,
`pose_decoder.*`, `motion_decoder.*`, `motion_mask.*`), so a state dict in
those names loads with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..geometry import transformation_from_parameters
from .backbones.swin import SwinTransformer
from .layers import MLP, random_init_
from .motion_decoder import MotionDecoderV2
from .pixel_decoders.msdeformattn import MSDeformAttnPixelDecoder
from .pixel_decoders.transdssl import TransDSSL
from .pose_decoder import ResNetLikePoseDecoder
from .transformer_decoder import OneFormerQueryDecoder


# length of the tokenized task prompt (config.InputConfig.task_seq_len)
TASK_SEQ_LEN = 77


class SemSegHead(nn.Module):
    def __init__(self, pixel_decoder: nn.Module, predictor: nn.Module, depth_decoder: nn.Module):
        super().__init__()
        self.pixel_decoder = pixel_decoder
        self.predictor = predictor
        self.depth_decoder = depth_decoder


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
    """The serving model: `forward_segmentation` and `forward_sequence`.

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
        if h.depth_decoder_name != "TransDSSL":
            raise NotImplementedError(f"depth decoder {h.depth_decoder_name!r} is not ported yet")
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
            depth_decoder = TransDSSL(self.backbone.out_channels, features=h.convs_dim,
                                      n_scales=cfg.num_depth_scales)
            self.sem_seg_head = SemSegHead(pixel_decoder, predictor, depth_decoder)
            # task MLP consumes raw token ids as floats (reference quirk)
            self.task_mlp = MLP(TASK_SEQ_LEN, of.hidden_dim, of.hidden_dim, 2)
            # the pose and motion decoders see both frames' features side by side
            pair = {k: 2 * c for k, c in self.backbone.out_channels.items()}
            self.pose_decoder = ResNetLikePoseDecoder(pair)
            self.motion_decoder = MotionDecoderV2(pair, out_dim=3, n_scales=cfg.num_depth_scales)
            self.motion_mask = MotionDecoderV2(pair, out_dim=1, n_scales=cfg.num_depth_scales)
        self.to_empty(device=device)
        # segmentation modules first, so that the weights a seed gives them do
        # not depend on the sequence modules
        generator = torch.Generator(device="cpu").manual_seed(seed)
        for module in (self.backbone, pixel_decoder, predictor, self.task_mlp,
                       depth_decoder, self.pose_decoder, self.motion_decoder, self.motion_mask):
            random_init_(module, generator)
        self.to(dtype)
        self.eval()

    @property
    def pixel_decoder(self) -> MSDeformAttnPixelDecoder:
        return self.sem_seg_head.pixel_decoder

    @property
    def predictor(self) -> OneFormerQueryDecoder:
        return self.sem_seg_head.predictor

    @property
    def depth_decoder(self) -> TransDSSL:
        return self.sem_seg_head.depth_decoder

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

    @torch.no_grad()
    def forward_sequence(self, images: torch.Tensor, prev_images: torch.Tensor) -> Dict:
        """images, prev_images: (B, H, W, 3) normalized current / previous frame.

        Returns disp and motion_mask (B, H, W, 1), complete_flow (B, H, W, 3),
        axisangle and translation (B, 1, 3), cam_T_cam (B, 4, 4), and the
        per-scale dicts disps / complete_flows keyed ("disp", s) /
        ("complete_flow", s)."""
        B = images.shape[0]
        feats = self.backbone(torch.cat([images, prev_images], dim=0))
        f_cur = {k: v[:B] for k, v in feats.items()}
        f_motion = {k: torch.cat([v[B:], v[:B]], dim=-1) for k, v in feats.items()}  # (prev || cur)

        axisangle, translation = self.pose_decoder(f_motion)
        aa0, t0 = axisangle[:, 0], translation[:, 0]  # frame-pair slot 0
        cam_T_cam = transformation_from_parameters(aa0, t0, invert=True)
        ego = torch.cat([t0, aa0], dim=-1).reshape(B, 1, 1, 6)

        full_res = torch.cat([prev_images, images], dim=-1)  # (B, H, W, 6)
        flow = self.motion_decoder(full_res, f_motion, ego)
        prob = self.motion_mask(full_res, f_motion, ego)
        disps = self.depth_decoder(f_cur)
        return {
            "disp": disps[("disp", 0)],
            "disps": disps,
            "motion_mask": prob[("motion_mask", 0)],
            "motion_prob": prob[("motion_prob", 0)],
            "complete_flow": flow[("complete_flow", 0)],
            "complete_flows": flow,
            "axisangle": aa0,
            "translation": t0,
            "cam_T_cam": cam_T_cam,
        }

    def forward(self, images: torch.Tensor, task_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.forward_segmentation(images, task_tokens)
