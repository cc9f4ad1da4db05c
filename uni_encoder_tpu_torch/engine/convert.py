"""Carry weights across from the JAX package.

`state_dict_from_jax` turns a JAX-package flax parameter tree and its
`batch_stats` (numpy or jax arrays) into this package's d2-named state dict:
the inverse of the JAX checkpoint converter's rules
(`uni_encoder_tpu/engine/checkpoint.py`: `convert_swin`, `convert_resnet`,
`convert_convnext`, `convert_dinat`, `convert_msdeform_pixel_decoder`, `convert_query_decoder`,
`convert_task_mlp`, `convert_transdssl`, `convert_pose_decoder`,
`convert_motion_decoder`). This module keeps its own copy of those tables.

The training state's `text_params` (the JAX trainer's `_TextEncoder`) have
no rule in the JAX converter: the reference ships no text-encoder weights.
The port names those modules after the reference OneFormer's attributes, and
this module's `_text_encoder` records the table:

  text_encoder/token_embedding/embedding  -> text_encoder.token_embedding.weight
  text_encoder/positional_embedding       -> text_encoder.positional_embedding
  text_encoder/resblock_{i}/{ln_1, attn, ln_2}
                              -> text_encoder.transformer.resblocks.{i}.{ln_1, attn, ln_2}
  text_encoder/resblock_{i}/{c_fc, c_proj}
                              -> text_encoder.transformer.resblocks.{i}.mlp.{c_fc, c_proj}
  text_encoder/ln_final                   -> text_encoder.ln_final
  text_projector/proj/layers_{i}          -> text_projector.layers.{i}
  prompt_ctx                              -> prompt_ctx.weight
  logit_scale                             -> logit_scale

The JAX converter has no rules either for the decoders no shipped config
selects, nor for the modules no config selects; this module's tables place
them (flax scope -> the port's keys; `{P}` is `sem_seg_head.pixel_decoder.`
or `sem_seg_head.depth_decoder.`, the flax scope `pixel_decoder` or
`depth_decoder`):

  FPN family (`_fpn_trunk`, d2's BasePixelDecoder names):
    trunk/layer_{k}_conv, layer_{k}_gn      -> {P}layer_{k}, {P}layer_{k}.norm
    trunk/adapter_{k}_conv, adapter_{k}_gn  -> {P}adapter_{k}, {P}adapter_{k}.norm
    trunk/input_proj                        -> {P}input_proj
    trunk/encoder_layer_{l}/{self_attn, linear1, linear2, norm1, norm2}
                                            -> {P}transformer.encoder.layers.{l}.{same}
    mask_features                           -> {P}mask_features
  DepthMSDeformAttnPixelDecoder: the deformable trunk's table (`_msdeform_trunk`)
  disparity heads (`_disp_heads`, flax names):
    low_disp_{i}_{conv0, gn0, conv1, gn1, out} -> {P}low_disp_{i}.{same}
  DCMNet (`_dcmnet`, flax names; a ConvModule's `conv` and `bn`):
    {psp_{i}, bottleneck, lateral_{i}, fpn_{i}, fpn_bottleneck_{s}}/{conv, bn}
                                            -> {P}{same}.{conv, bn}
    last_layer_{s}                          -> {P}last_layer_{s}
  MonodepthDecoder (`_monodepth`): upconv_{i}_{j}, dispconv_{s} -> {P}{same}
  MotionDecoderV1 at `motion_decoder` / `motion_mask` (`_motion_decoder_v1`):
    res_trans_conv, conv{ii}_{0,1}, redu{ii} -> {motion_decoder, motion_mask}.{same}
  Monodepth2PoseModel at `pose_decoder` (`_monodepth2_pose`):
    encoder/*                               -> pose_decoder.encoder.* (the ResNet's table)
    decoder/{squeeze, pose_0, pose_1, pose_2} -> pose_decoder.decoder.{same}
  ContextDecoder at `context_decoder` (`_context_decoder`, the reference's names):
    memory_norm1, memory_proj, memory_norm2 -> context_decoder.memory_proj.{0, 1, 2}
    text_norm, text_proj                    -> context_decoder.text_proj.{0, 1}
    layer{i}_norm{k}                        -> context_decoder.decoder.{i}.norm{k}
    layer{i}_{self_attn, cross_attn}/{q_proj, k_proj, v_proj, proj}
                                            -> context_decoder.decoder.{i}.{same}.{same}
    layer{i}_mlp_fc1, layer{i}_mlp_fc2      -> context_decoder.decoder.{i}.mlp.{0, 3}
    out_norm, out_proj                      -> context_decoder.out_proj.{0, 1}

Each decoder is told apart by its flax names (`_decoder`), a MotionDecoderV1
by the absence of `layer0`, the pose model by its `encoder`.

Layouts:

  * Dense kernel (in, out)      -> `.weight` = kernel.T
  * Conv kernel HWIO            -> `.weight` OIHW
  * LayerNorm/GroupNorm/BatchNorm `scale` -> `.weight`
  * BatchNorm `batch_stats` `mean` / `var` -> `.running_mean` / `.running_var`
  * MHA `in_proj` / `out_proj_kernel` -> `in_proj_weight` / `out_proj.weight`, transposed

The backbone is told apart by its flax names, and depths and layer counts
are read off the tree. A parameter or statistic
that no rule places raises.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]

_INVERSE = {
    "ident": lambda v: v,
    "linear": lambda v: v.T,
    "conv": lambda v: v.transpose(3, 2, 0, 1),  # HWIO -> OIHW
}


class _Table:
    """(d2 source key, flax collection, flax path, layout kind) records,
    built with the same rule vocabulary as the JAX converter."""

    def __init__(self):
        self.records: List[Tuple[str, str, Path, str]] = []

    def raw(self, src: str, dst: Path, kind: str = "ident", collection: str = "params"):
        self.records.append((src, collection, dst, kind))

    def linear(self, src: str, dst: Path, bias: bool = True, collection: str = "params"):
        self.raw(src + ".weight", dst + ("kernel",), "linear", collection)
        if bias:
            self.raw(src + ".bias", dst + ("bias",), collection=collection)

    def conv(self, src: str, dst: Path, bias: bool = True):
        self.raw(src + ".weight", dst + ("kernel",), "conv")
        if bias:
            self.raw(src + ".bias", dst + ("bias",))

    def norm(self, src: str, dst: Path, collection: str = "params"):
        self.raw(src + ".weight", dst + ("scale",), collection=collection)
        self.raw(src + ".bias", dst + ("bias",), collection=collection)

    def bn(self, src: str, dst: Path):
        self.norm(src, dst)
        self.raw(src + ".running_mean", dst + ("mean",), collection="batch_stats")
        self.raw(src + ".running_var", dst + ("var",), collection="batch_stats")

    def mha(self, src: str, dst: Path, collection: str = "params"):
        self.raw(src + ".in_proj_weight", dst + ("in_proj",), "linear", collection)
        self.raw(src + ".in_proj_bias", dst + ("in_proj_bias",), collection=collection)
        self.raw(src + ".out_proj.weight", dst + ("out_proj_kernel",), "linear", collection)
        self.raw(src + ".out_proj.bias", dst + ("out_proj_bias",), collection=collection)


def _swin(t: _Table, depths) -> None:
    b = "backbone."
    t.conv(b + "patch_embed.proj", ("backbone", "patch_embed_proj"))
    t.norm(b + "patch_embed.norm", ("backbone", "patch_embed_norm"))
    for i, depth in enumerate(depths):
        for j in range(depth):
            src = f"{b}layers.{i}.blocks.{j}."
            dst = ("backbone", f"layers_{i}_blocks_{j}")
            t.norm(src + "norm1", dst + ("norm1",))
            t.norm(src + "norm2", dst + ("norm2",))
            t.raw(src + "attn.qkv.weight", dst + ("attn", "qkv_kernel"), "linear")
            t.raw(src + "attn.qkv.bias", dst + ("attn", "qkv_bias"))
            t.raw(src + "attn.proj.weight", dst + ("attn", "proj_kernel"), "linear")
            t.raw(src + "attn.proj.bias", dst + ("attn", "proj_bias"))
            t.raw(src + "attn.relative_position_bias_table", dst + ("attn", "relative_position_bias_table"))
            t.linear(src + "mlp.fc1", dst + ("mlp_fc1",))
            t.linear(src + "mlp.fc2", dst + ("mlp_fc2",))
        if i < len(depths) - 1:
            t.norm(f"{b}layers.{i}.downsample.norm", ("backbone", f"layers_{i}_downsample", "norm"))
            t.linear(f"{b}layers.{i}.downsample.reduction", ("backbone", f"layers_{i}_downsample", "reduction"),
                     bias=False)
        t.norm(f"{b}norm{i}", ("backbone", f"out_norm{i}"))


def _resnet(t: _Table, depths, bottleneck: bool, b: str = "backbone.", top: Path = ("backbone",)) -> None:
    """Every block gets shortcut records; only the blocks that project hold
    one, and a record whose flax leaf is absent places nothing."""
    t.conv(b + "stem.conv1", top + ("stem_conv1",), bias=False)
    t.bn(b + "stem.conv1.norm", top + ("stem_bn1",))
    for i, depth in enumerate(depths):
        for j in range(depth):
            src, dst = f"{b}res{i + 2}.{j}.", top + (f"res{i + 2}_block{j}",)
            for k in range(1, (3 if bottleneck else 2) + 1):
                t.conv(src + f"conv{k}", dst + (f"conv{k}",), bias=False)
                t.bn(src + f"conv{k}.norm", dst + (f"bn{k}",))
            t.conv(src + "shortcut", dst + ("shortcut_conv",), bias=False)
            t.bn(src + "shortcut.norm", dst + ("shortcut_bn",))


def _convnext(t: _Table, depths) -> None:
    b = "backbone."
    t.conv(b + "downsample_layers.0.0", ("backbone", "stem_conv"))
    t.norm(b + "downsample_layers.0.1", ("backbone", "stem_norm"))
    for i in range(1, len(depths)):
        t.norm(b + f"downsample_layers.{i}.0", ("backbone", f"downsample_{i}_norm"))
        t.conv(b + f"downsample_layers.{i}.1", ("backbone", f"downsample_{i}_conv"))
    for i, depth in enumerate(depths):
        for j in range(depth):
            src, dst = f"{b}stages.{i}.{j}.", ("backbone", f"stages_{i}_blocks_{j}")
            t.conv(src + "dwconv", dst + ("dwconv",))
            t.norm(src + "norm", dst + ("norm",))
            t.linear(src + "pwconv1", dst + ("pwconv1",))
            t.linear(src + "pwconv2", dst + ("pwconv2",))
            t.raw(src + "gamma", dst + ("gamma",))
        t.norm(f"{b}norm{i}", ("backbone", f"out_norm{i}"))


def _dinat(t: _Table, depths) -> None:
    b = "backbone."
    t.conv(b + "patch_embed.proj.0", ("backbone", "tokenizer_conv0"))
    t.conv(b + "patch_embed.proj.1", ("backbone", "tokenizer_conv1"))
    t.norm(b + "patch_embed.norm", ("backbone", "tokenizer_norm"))
    for i, depth in enumerate(depths):
        for j in range(depth):
            src, dst = f"{b}levels.{i}.blocks.{j}.", ("backbone", f"levels_{i}_blocks_{j}")
            t.norm(src + "norm1", dst + ("norm1",))
            t.norm(src + "norm2", dst + ("norm2",))
            t.linear(src + "attn.qkv", dst + ("attn", "qkv"))
            t.raw(src + "attn.rpb", dst + ("attn", "rpb"))
            t.linear(src + "attn.proj", dst + ("attn", "proj"))
            t.linear(src + "mlp.fc1", dst + ("mlp_fc1",))
            t.linear(src + "mlp.fc2", dst + ("mlp_fc2",))
        if i < len(depths) - 1:
            t.conv(f"{b}levels.{i}.downsample.reduction", ("backbone", f"downsample_{i}_reduction"), bias=False)
            t.norm(f"{b}levels.{i}.downsample.norm", ("backbone", f"downsample_{i}_norm"))
        t.norm(f"{b}norm{i}", ("backbone", f"out_norm{i}"))


def _backbone(t: _Table, flat: Dict[Path, np.ndarray]) -> None:
    """The backbone's table, told apart by its flax names: `stem_conv1`
    (ResNet), `stages_*` (ConvNeXt), `levels_*` (DiNAT), else Swin's
    `layers_*`; depths are read off the block names."""
    names = {p[1] for p in flat if p[0] == "backbone"}

    def depths(fmt: str, n_stages: int):
        return [_count(names, fmt.format(i=i)) for i in range(n_stages)]

    if "stem_conv1" in names:
        bottleneck = any(p[:1] == ("backbone",) and p[2:3] == ("conv3",) for p in flat)
        _resnet(t, depths(r"res{i}_block(\d+)", 6)[2:], bottleneck)
    elif any(n.startswith("stages_") for n in names):
        _convnext(t, depths(r"stages_{i}_blocks_(\d+)", _count(names, r"out_norm(\d+)")))
    elif any(n.startswith("levels_") for n in names):
        _dinat(t, depths(r"levels_{i}_blocks_(\d+)", _count(names, r"out_norm(\d+)")))
    else:
        _swin(t, depths(r"layers_{i}_blocks_(\d+)", _count(names, r"out_norm(\d+)")))


def _msdeform_trunk(t: _Table, prefix: str, trunk: Path, layers: int, levels: int) -> None:
    for i in range(levels):
        t.conv(prefix + f"input_proj.{i}.0", trunk + (f"input_proj_{i}_conv",))
        t.norm(prefix + f"input_proj.{i}.1", trunk + (f"input_proj_{i}_gn",))
    t.raw(prefix + "transformer.level_embed", trunk + ("level_embed",))
    for l in range(layers):
        src = prefix + f"transformer.encoder.layers.{l}."
        dst = trunk + (f"encoder_layer_{l}",)
        for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            t.linear(src + f"self_attn.{name}", dst + ("self_attn", name))
        t.norm(src + "norm1", dst + ("norm1",))
        t.norm(src + "norm2", dst + ("norm2",))
        t.linear(src + "linear1", dst + ("linear1",))
        t.linear(src + "linear2", dst + ("linear2",))
    t.conv(prefix + "adapter_1", trunk + ("adapter_1_conv",), bias=False)
    t.norm(prefix + "adapter_1.norm", trunk + ("adapter_1_gn",))
    t.conv(prefix + "layer_1", trunk + ("layer_1_conv",), bias=False)
    t.norm(prefix + "layer_1.norm", trunk + ("layer_1_gn",))


def _fpn_trunk(t: _Table, prefix: str, trunk: Path, levels: int, layers: int) -> None:
    """d2's BasePixelDecoder names: `layer_{n}` for the lowest-res level,
    `adapter_{k}` / `layer_{k}` below it; the transformer variant's
    `input_proj` and post-norm `transformer.encoder.layers.{l}`."""
    for k in range(1, levels + 1):
        if k < levels:
            t.conv(prefix + f"adapter_{k}", trunk + (f"adapter_{k}_conv",), bias=False)
            t.norm(prefix + f"adapter_{k}.norm", trunk + (f"adapter_{k}_gn",))
        t.conv(prefix + f"layer_{k}", trunk + (f"layer_{k}_conv",), bias=False)
        t.norm(prefix + f"layer_{k}.norm", trunk + (f"layer_{k}_gn",))
    t.conv(prefix + "input_proj", trunk + ("input_proj",))
    for l in range(layers):
        src, dst = prefix + f"transformer.encoder.layers.{l}.", trunk + (f"encoder_layer_{l}",)
        t.mha(src + "self_attn", dst + ("self_attn",))
        t.linear(src + "linear1", dst + ("linear1",))
        t.linear(src + "linear2", dst + ("linear2",))
        t.norm(src + "norm1", dst + ("norm1",))
        t.norm(src + "norm2", dst + ("norm2",))


def _disp_heads(t: _Table, prefix: str, top: Path, n: int) -> None:
    for i in range(n):
        src = f"{prefix}low_disp_{i}."
        for k in range(2):
            t.conv(src + f"conv{k}", top + (f"low_disp_{i}_conv{k}",))
            t.norm(src + f"gn{k}", top + (f"low_disp_{i}_gn{k}",))
        t.conv(src + "out", top + (f"low_disp_{i}_out",))


def _conv_module(t: _Table, src: str, dst: Path) -> None:
    t.conv(src + ".conv", dst + ("conv",), bias=False)
    t.bn(src + ".bn", dst + ("bn",))


def _dcmnet(t: _Table, prefix: str, top: Path, pools: int, levels: int) -> None:
    for i in range(pools):
        _conv_module(t, prefix + f"psp_{i}", top + (f"psp_{i}",))
    _conv_module(t, prefix + "bottleneck", top + ("bottleneck",))
    for i in range(levels - 1):
        _conv_module(t, prefix + f"lateral_{i}", top + (f"lateral_{i}",))
        _conv_module(t, prefix + f"fpn_{i}", top + (f"fpn_{i}",))
    for scale in range(4):
        _conv_module(t, prefix + f"fpn_bottleneck_{scale}", top + (f"fpn_bottleneck_{scale}",))
        t.conv(prefix + f"last_layer_{scale}", top + (f"last_layer_{scale}",))


def _monodepth(t: _Table, prefix: str, top: Path) -> None:
    for i in range(5):
        for j in range(2):
            t.conv(prefix + f"upconv_{i}_{j}", top + (f"upconv_{i}_{j}",))
        t.conv(prefix + f"dispconv_{i}", top + (f"dispconv_{i}",))


def _decoder(t: _Table, flat: Dict[Path, np.ndarray], top: str, prefix: str) -> None:
    """The table of the pixel or depth decoder at flax scope `top`, told
    apart by its flax names: TransDSSL's `layer1_rn`, DCMNet's `psp_*`,
    MonodepthDecoder's `upconv_*`; a `trunk` with `input_proj_0_conv` is the
    deformable one, any other the FPN's; `mask_features` or `low_disp_*`
    heads on either."""
    names = {p[1] for p in flat if p[0] == top}
    trunk_names = {p[2] for p in flat if p[:2] == (top, "trunk")}
    root, trunk = (top,), (top, "trunk")
    if "layer1_rn" in names:
        _transdssl(t)
    elif any(n.startswith("psp_") for n in names):
        _dcmnet(t, prefix, root, _count(names, r"psp_(\d+)"), _count(names, r"lateral_(\d+)") + 1)
    elif any(n.startswith("upconv_") for n in names):
        _monodepth(t, prefix, root)
    elif "input_proj_0_conv" in trunk_names:
        _msdeform_trunk(t, prefix, trunk, layers=_count(trunk_names, r"encoder_layer_(\d+)"),
                        levels=_count(trunk_names, r"input_proj_(\d+)_conv"))
    else:
        _fpn_trunk(t, prefix, trunk, levels=_count(trunk_names, r"layer_(\d+)_conv") - 1,
                   layers=_count(trunk_names, r"encoder_layer_(\d+)"))
    t.conv(prefix + "mask_features", root + ("mask_features",))
    _disp_heads(t, prefix, root, _count(names, r"low_disp_(\d+)_out"))


def _query_decoder(t: _Table, dec_layers: int, class_dec_layers: int, mask_embed_layers: int) -> None:
    p = "sem_seg_head.predictor."
    d = ("predictor",)
    t.raw(p + "query_embed.weight", d + ("query_embed",))
    t.raw(p + "level_embed.weight", d + ("level_embed",))
    t.conv(p + "class_input_proj", d + ("class_input_proj",))
    t.norm(p + "decoder_norm", d + ("decoder_norm",))
    t.linear(p + "class_embed", d + ("class_embed",))
    for i in range(mask_embed_layers):
        t.linear(p + f"mask_embed.layers.{i}", d + ("mask_embed", f"layers_{i}"))
    for i in range(class_dec_layers):
        src = p + f"class_transformer.decoder.layers.{i}."
        dst = d + (f"class_dec_{i}",)
        t.mha(src + "self_attn", dst + ("self_attn",))
        t.mha(src + "multihead_attn", dst + ("multihead_attn",))
        for name in ("linear1", "linear2"):
            t.linear(src + name, dst + (name,))
        for name in ("norm1", "norm2", "norm3"):
            t.norm(src + name, dst + (name,))
    t.norm(p + "class_transformer.decoder.norm", d + ("class_transformer_norm",))
    for i in range(dec_layers):
        t.mha(p + f"transformer_cross_attention_layers.{i}.multihead_attn", d + (f"cross_attn_{i}", "multihead_attn"))
        t.norm(p + f"transformer_cross_attention_layers.{i}.norm", d + (f"cross_attn_{i}", "norm"))
        t.mha(p + f"transformer_self_attention_layers.{i}.self_attn", d + (f"self_attn_{i}", "self_attn"))
        t.norm(p + f"transformer_self_attention_layers.{i}.norm", d + (f"self_attn_{i}", "norm"))
        t.linear(p + f"transformer_ffn_layers.{i}.linear1", d + (f"ffn_{i}", "linear1"))
        t.linear(p + f"transformer_ffn_layers.{i}.linear2", d + (f"ffn_{i}", "linear2"))
        t.norm(p + f"transformer_ffn_layers.{i}.norm", d + (f"ffn_{i}", "norm"))


def _task_mlp(t: _Table) -> None:
    for i in range(2):
        t.linear(f"task_mlp.layers.{i}", ("task_mlp", f"layers_{i}"))


def _transdssl(t: _Table) -> None:
    p = "sem_seg_head.depth_decoder.layers."
    d = ("depth_decoder",)
    for k in range(1, 5):
        t.conv(p + f"layer{k}_rn", d + (f"layer{k}_rn",), bias=False)
    for k in range(5):
        src, dst = p + f"refinenet{k}.", d + (f"refinenet{k}",)
        for unit in ("resConfUnit1", "resConfUnit2"):
            t.conv(src + f"{unit}.conv1", dst + (unit, "conv1"))
            t.conv(src + f"{unit}.conv2", dst + (unit, "conv2"))
        t.conv(src + "en_atten", dst + ("en_atten",))
        t.conv(src + "out_conv", dst + ("out_conv",))
    for head in ("output_conv4", "output_conv3", "output_conv2", "output_conv"):
        t.conv(p + head + ".0", d + (f"{head}_0",))
        t.conv(p + head + ".1", d + (f"{head}_1",))


def _residual_stage(t: _Table, src: str, dst: Path) -> None:
    """Sequential(1x1 projection, two blocks): a block's `left.{0,1,3,4}`
    are conv, BN, conv, BN, and `shortcut.{0,1}` conv, BN."""
    t.conv(src + ".0", dst + ("proj",))
    for j in range(2):
        b, bd = f"{src}.{j + 1}.", dst + (f"block{j}",)
        t.conv(b + "left.0", bd + ("conv1",), bias=False)
        t.bn(b + "left.1", bd + ("bn1",))
        t.conv(b + "left.3", bd + ("conv2",), bias=False)
        t.bn(b + "left.4", bd + ("bn2",))
        t.conv(b + "shortcut.0", bd + ("shortcut_conv",), bias=False)
        t.bn(b + "shortcut.1", bd + ("shortcut_bn",))


def _pose_decoder(t: _Table) -> None:
    for k in range(1, 5):
        _residual_stage(t, f"pose_decoder.layer{k}", ("pose_decoder", f"layer{k}"))
    t.conv("pose_decoder.squeeze", ("pose_decoder", "squeeze"))
    for i in range(3):
        t.conv(f"pose_decoder.convs.pose_{i}", ("pose_decoder", f"pose_{i}"))


def _motion_decoder(t: _Table, which: str) -> None:
    _residual_stage(t, which + ".layer0", (which, "layer0"))
    for s in range(6):
        t.conv(f"{which}.conv{s}.0", (which, f"conv{s}_0"))
        t.conv(f"{which}.conv{s}.1", (which, f"conv{s}_1"))
        t.conv(f"{which}.squeeze{s}", (which, f"squeeze{s}"))
    t.conv(which + ".res_trans_conv", (which, "res_trans_conv"))


def _motion_decoder_v1(t: _Table, which: str, stages: int) -> None:
    t.conv(which + ".res_trans_conv", (which, "res_trans_conv"))
    for ii in range(stages):
        t.conv(f"{which}.conv{ii}_0", (which, f"conv{ii}_0"))
        t.conv(f"{which}.conv{ii}_1", (which, f"conv{ii}_1"))
        t.conv(f"{which}.redu{ii}", (which, f"redu{ii}"))


def _monodepth2_pose(t: _Table, flat: Dict[Path, np.ndarray]) -> None:
    names = {p[2] for p in flat if p[:2] == ("pose_decoder", "encoder")}
    bottleneck = any(p[:2] == ("pose_decoder", "encoder") and p[3:4] == ("conv3",) for p in flat)
    depths = [_count(names, rf"res{i}_block(\d+)") for i in range(2, 6)]
    _resnet(t, depths, bottleneck, "pose_decoder.encoder.", ("pose_decoder", "encoder"))
    for name in ("squeeze", "pose_0", "pose_1", "pose_2"):
        t.conv(f"pose_decoder.decoder.{name}", ("pose_decoder", "decoder", name))


def _context_decoder(t: _Table, layers: int) -> None:
    p, d = "context_decoder.", ("context_decoder",)
    t.norm(p + "memory_proj.0", d + ("memory_norm1",))
    t.linear(p + "memory_proj.1", d + ("memory_proj",))
    t.norm(p + "memory_proj.2", d + ("memory_norm2",))
    t.norm(p + "text_proj.0", d + ("text_norm",))
    t.linear(p + "text_proj.1", d + ("text_proj",))
    for i in range(layers):
        src, dst = f"{p}decoder.{i}.", d
        for k in (1, 2, 3):
            t.norm(src + f"norm{k}", dst + (f"layer{i}_norm{k}",))
        for attn in ("self_attn", "cross_attn"):
            for proj in ("q_proj", "k_proj", "v_proj"):
                t.linear(src + f"{attn}.{proj}", dst + (f"layer{i}_{attn}", proj), bias=False)
            t.linear(src + f"{attn}.proj", dst + (f"layer{i}_{attn}", "proj"))
        t.linear(src + "mlp.0", dst + (f"layer{i}_mlp_fc1",))
        t.linear(src + "mlp.3", dst + (f"layer{i}_mlp_fc2",))
    t.norm(p + "out_proj.0", d + ("out_norm",))
    t.linear(p + "out_proj.1", d + ("out_proj",))


def _text_encoder(t: _Table, layers: int, proj_layers: int) -> None:
    c, d = "text_params", ("text_encoder",)
    t.raw("text_encoder.token_embedding.weight", d + ("token_embedding", "embedding"), collection=c)
    t.raw("text_encoder.positional_embedding", d + ("positional_embedding",), collection=c)
    for i in range(layers):
        src, dst = f"text_encoder.transformer.resblocks.{i}.", d + (f"resblock_{i}",)
        t.norm(src + "ln_1", dst + ("ln_1",), collection=c)
        t.mha(src + "attn", dst + ("attn",), collection=c)
        t.norm(src + "ln_2", dst + ("ln_2",), collection=c)
        t.linear(src + "mlp.c_fc", dst + ("c_fc",), collection=c)
        t.linear(src + "mlp.c_proj", dst + ("c_proj",), collection=c)
    t.norm("text_encoder.ln_final", d + ("ln_final",), collection=c)
    for i in range(proj_layers):
        t.linear(f"text_projector.layers.{i}", ("text_projector", "proj", f"layers_{i}"), collection=c)
    t.raw("prompt_ctx.weight", ("prompt_ctx",), collection=c)
    t.raw("logit_scale", ("logit_scale",), collection=c)


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out: Dict[Path, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _count(names, pattern: str) -> int:
    """1 + the largest integer captured by `pattern` over `names` (0 if none)."""
    found = [int(m.group(1)) for n in names for m in [re.fullmatch(pattern, n)] if m]
    return max(found) + 1 if found else 0


def _tables_for(flat: Dict[Path, np.ndarray], text: Optional[Dict[Path, np.ndarray]] = None) -> _Table:
    """The rule table sized from the depths and layer counts in the trees."""
    names = {p[:2] for p in flat}
    predictor = [n for top, n in names if top == "predictor"]
    mask_embed = [p[2] for p in flat if p[:2] == ("predictor", "mask_embed")]
    t = _Table()
    _backbone(t, flat)
    _decoder(t, flat, "pixel_decoder", "sem_seg_head.pixel_decoder.")
    _decoder(t, flat, "depth_decoder", "sem_seg_head.depth_decoder.")
    _query_decoder(t, dec_layers=_count(predictor, r"cross_attn_(\d+)"),
                   class_dec_layers=_count(predictor, r"class_dec_(\d+)"),
                   mask_embed_layers=_count(mask_embed, r"layers_(\d+)"))
    _task_mlp(t)
    if ("pose_decoder", "encoder") in names:
        _monodepth2_pose(t, flat)
    else:
        _pose_decoder(t)
    for which in ("motion_decoder", "motion_mask"):
        if (which, "layer0") in names:
            _motion_decoder(t, which)
        else:
            _motion_decoder_v1(t, which, _count([n for top, n in names if top == which], r"redu(\d+)"))
    _context_decoder(t, _count([n for top, n in names if top == "context_decoder"], r"layer(\d+)_norm1"))
    if text:
        _text_encoder(t, layers=_count([p[1] for p in text if p[0] == "text_encoder"], r"resblock_(\d+)"),
                      proj_layers=_count([p[2] for p in text if p[:2] == ("text_projector", "proj")],
                                         r"layers_(\d+)"))
    return t


def param_paths(params: Mapping, text_params: Optional[Mapping] = None) -> Dict[str, Tuple[str, Path, str]]:
    """d2 name -> (flax collection, flax path, layout kind) of every
    trainable leaf of the given trees."""
    trees = {"params": _flatten(params), "text_params": _flatten(text_params or {})}
    return {src: (col, dst, kind) for src, col, dst, kind in _tables_for(trees["params"], trees["text_params"]).records
            if dst in trees.get(col, {})}


def state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None,
                        text_params: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's flax params and batch_stats, and the training
    state's text_params, as this package's d2-named state dict (with
    text_params, it loads strictly into a UniEncoder built with is_train)."""
    trees = {"params": _flatten(params), "batch_stats": _flatten(batch_stats or {}),
             "text_params": _flatten(text_params or {})}
    out: Dict[str, torch.Tensor] = {}
    placed = {name: set() for name in trees}
    for src, collection, dst, kind in _tables_for(trees["params"], trees["text_params"]).records:
        leaf = trees[collection].get(dst)
        if leaf is not None:
            out[src] = torch.from_numpy(np.array(_INVERSE[kind](leaf), order="C"))  # a writable copy, 0-d kept
            placed[collection].add(dst)
    for name, flat in trees.items():
        unplaced = sorted(set(flat) - placed[name])
        if unplaced:
            raise KeyError(f"{len(unplaced)} {name} leaves with no place in the port, e.g. {unplaced[:8]}")
    return out
