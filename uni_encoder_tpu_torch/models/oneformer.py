"""UniEncoder meta-architecture (port of `uni_encoder_tpu/models/oneformer.py`).

One shared Swin backbone feeds (a) the MSDeformAttn pixel decoder and the
task-conditioned query decoder for segmentation items, and (b) the two-frame
pose / motion / depth decoders for sequence items. The task string is
tokenized on the host; the model feeds the (B, 77) token ids, as floats,
through the 2-layer task MLP, reproducing the reference's quirk of embedding
raw token ids. A sequence item's two frames go through the backbone as one
2B batch.

Built with `cfg.is_train`, the model is in train mode: the query decoder
emits its deep-supervision predictions and the seeded queries, BatchNorm
uses and updates batch statistics, the Swin backbone takes stochastic-depth
keep masks, `forward_sequence_train` serves the three-frame training window,
and the model holds the text encoder of the contrastive loss
(`text_encoder`, `text_projector`, `prompt_ctx`, `logit_scale`, named after
the reference OneFormer's attributes; `encode_text`). The forwards record
autograd state whenever grad mode is on: serving callers hold their own
`torch.inference_mode()`.

Module names follow the reference d2 state dict (`backbone.*`,
`sem_seg_head.{pixel_decoder,predictor,depth_decoder}.*`, `task_mlp.*`,
`pose_decoder.*`, `motion_decoder.*`, `motion_mask.*`), so a state dict in
those names loads with `load_state_dict(strict=True)`.
"""

from __future__ import annotations

import math
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
from .text_transformer import TextProjector, TextTransformer
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
        drop_path_rate=c.drop_path_rate,
    )


class UniEncoder(nn.Module):
    """The model: `forward_segmentation` and `forward_sequence` (serving), and
    with `cfg.is_train` also `forward_sequence_train` and `encode_text`.

    Built with random weights drawn from `seed` (a reference checkpoint, or
    weights carried across from the JAX package with
    `engine.convert.state_dict_from_jax`, load on top with
    `load_state_dict(strict=True)`). `device=None` means the GPU and raises
    when none is visible.
    """

    def __init__(self, cfg: ModelConfig, device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0, task_seq_len: int = TASK_SEQ_LEN):
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
                is_train=cfg.is_train,
            )
            depth_decoder = TransDSSL(self.backbone.out_channels, features=h.convs_dim,
                                      n_scales=cfg.num_depth_scales)
            self.sem_seg_head = SemSegHead(pixel_decoder, predictor, depth_decoder)
            # task MLP consumes raw token ids as floats (reference quirk)
            self.task_mlp = MLP(task_seq_len, of.hidden_dim, of.hidden_dim, 2)
            # the pose and motion decoders see both frames' features side by side
            pair = {k: 2 * c for k, c in self.backbone.out_channels.items()}
            self.pose_decoder = ResNetLikePoseDecoder(pair)
            self.motion_decoder = MotionDecoderV2(pair, out_dim=3, n_scales=cfg.num_depth_scales)
            self.motion_mask = MotionDecoderV2(pair, out_dim=1, n_scales=cfg.num_depth_scales)
            text_modules = ()
            if cfg.is_train:
                te = cfg.text_encoder
                self.text_encoder = TextTransformer(te.context_length, te.width, te.num_layers, te.vocab_size)
                self.text_projector = TextProjector(te.width, of.hidden_dim, te.proj_num_layers)
                self.prompt_ctx = nn.Embedding(te.n_ctx, of.hidden_dim)
                self.logit_scale = nn.Parameter(torch.empty(()))
                text_modules = (self.text_encoder, self.text_projector, self.prompt_ctx)
        self.to_empty(device=device)
        # segmentation modules first, so that the weights a seed gives them do
        # not depend on the sequence or text modules
        generator = torch.Generator(device="cpu").manual_seed(seed)
        for module in (self.backbone, pixel_decoder, predictor, self.task_mlp,
                       depth_decoder, self.pose_decoder, self.motion_decoder, self.motion_mask) + text_modules:
            random_init_(module, generator)
        if cfg.is_train:
            with torch.no_grad():
                self.logit_scale.fill_(math.log(1.0 / 0.07))  # the JAX copy's initial value
        self.to(dtype)
        self.train(cfg.is_train)

    @property
    def pixel_decoder(self) -> MSDeformAttnPixelDecoder:
        return self.sem_seg_head.pixel_decoder

    @property
    def predictor(self) -> OneFormerQueryDecoder:
        return self.sem_seg_head.predictor

    @property
    def depth_decoder(self) -> TransDSSL:
        return self.sem_seg_head.depth_decoder

    def forward_segmentation(self, images: torch.Tensor, task_tokens: torch.Tensor,
                             drop_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """images: (B, H, W, 3) normalized; task_tokens: (B, 77) int;
        drop_masks: the backbone's stochastic-depth keep masks (training).

        Returns pred_logits (B, Q, K+1) and pred_masks (B, Q, H/4, W/4), and
        with `is_train` aux_outputs (the earlier prediction sets) and
        contrastive_logits (B, Q, C)."""
        task = self.task_mlp(task_tokens.to(torch.float32))
        # dtype-following: the raw-token fp32 input would otherwise promote
        # the whole query-decoder chain to fp32 under a bf16 model
        task = task.to(images.dtype)
        features = self.backbone(images, drop_masks)
        mask_features, _, multi_scale = self.pixel_decoder(features)
        return self.predictor(multi_scale, mask_features, task)

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
        ego = torch.cat([t0, aa0], dim=-1).detach().reshape(B, 1, 1, 6)

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

    def forward_sequence_train(self, images: torch.Tensor, prev_images: torch.Tensor, next_images: torch.Tensor,
                               drop_masks: Optional[torch.Tensor] = None) -> Dict:
        """The training window: center, previous and next frames (B, H, W, 3)
        through the backbone as one 3B batch; depth at every scale for the
        center frame, and pose, complete flow and motion mask for both
        neighbour pairs (frame ids -1 and +1), which run through the pose and
        motion decoders as one 2B batch. The pose decoder's two slots map to
        the two neighbours; the ego vector that seeds the motion decoders
        passes no gradient back.

        Returns disps {s: (B, h_s, w_s, 1)}, cam_T_cam {f: (B, 4, 4)}, and
        complete_flow, motion_mask, motion_prob {(f, s): ...}."""
        B = images.shape[0]
        feats = self.backbone(torch.cat([images, prev_images, next_images], dim=0), drop_masks)
        f_cur = {k: v[:B] for k, v in feats.items()}
        neighbours = ((-1, {k: v[B:2 * B] for k, v in feats.items()}, prev_images, 0),
                      (1, {k: v[2 * B:] for k, v in feats.items()}, next_images, 1))

        disps = self.depth_decoder(f_cur)
        n_scales = self.cfg.num_depth_scales
        outputs = {"disps": {s: disps[("disp", s)] for s in range(n_scales)},
                   "cam_T_cam": {}, "complete_flow": {}, "motion_mask": {}, "motion_prob": {}}

        fm2 = {k: torch.cat([torch.cat([fo[k], f_cur[k]], dim=-1) for _, fo, _, _ in neighbours], dim=0)
               for k in f_cur}
        axisangle, translation = self.pose_decoder(fm2)  # (2B, 2, 1, 3) each
        aa_parts, t_parts = [], []
        for i, (frame_id, _, _, slot) in enumerate(neighbours):
            aa = axisangle[i * B:(i + 1) * B, slot]
            t = translation[i * B:(i + 1) * B, slot]
            outputs["cam_T_cam"][frame_id] = transformation_from_parameters(aa, t, invert=frame_id < 0)
            aa_parts.append(aa)
            t_parts.append(t)
        ego2 = torch.cat([torch.cat(t_parts), torch.cat(aa_parts)], dim=-1).detach().reshape(2 * B, 1, 1, 6)

        full_res2 = torch.cat([torch.cat([img, images], dim=-1) for _, _, img, _ in neighbours], dim=0)
        flow = self.motion_decoder(full_res2, fm2, ego2)
        prob = self.motion_mask(full_res2, fm2, ego2)
        for i, (frame_id, _, _, _) in enumerate(neighbours):
            rows = slice(i * B, (i + 1) * B)
            for s in range(n_scales):
                outputs["complete_flow"][(frame_id, s)] = flow[("complete_flow", s)][rows]
                outputs["motion_mask"][(frame_id, s)] = prob[("motion_mask", s)][rows]
                outputs["motion_prob"][(frame_id, s)] = prob[("motion_prob", s)][rows]
        return outputs

    def encode_text(self, text: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-query token lists (B, N, L) -> texts (B, N + n_ctx, hidden_dim)
        with the learned prompt context appended, and logit_scale (the JAX
        trainer's `_TextEncoder`). A (B, L) input is one text per image and
        gets no context."""
        if text.ndim == 3:
            B, n, L = text.shape
            x = self.text_projector(self.text_encoder(text.reshape(B * n, L))).reshape(B, n, -1)
            ctx = self.prompt_ctx.weight
            x = torch.cat([x, ctx[None].expand(B, -1, -1)], dim=1)
        else:
            x = self.text_projector(self.text_encoder(text))
        return {"texts": x, "logit_scale": self.logit_scale}

    def forward(self, images: torch.Tensor, task_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.forward_segmentation(images, task_tokens)
