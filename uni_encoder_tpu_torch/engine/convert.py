"""Carry weights across from the JAX package.

`state_dict_from_jax` turns a JAX-package flax parameter tree and its
`batch_stats` (numpy or jax arrays) into this package's d2-named state dict:
the inverse of the JAX checkpoint converter's rules
(`uni_encoder_tpu/engine/checkpoint.py`: `convert_swin`,
`convert_msdeform_pixel_decoder`, `convert_query_decoder`,
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

Layouts:

  * Dense kernel (in, out)      -> `.weight` = kernel.T
  * Conv kernel HWIO            -> `.weight` OIHW
  * LayerNorm/GroupNorm/BatchNorm `scale` -> `.weight`
  * BatchNorm `batch_stats` `mean` / `var` -> `.running_mean` / `.running_var`
  * MHA `in_proj` / `out_proj_kernel` -> `in_proj_weight` / `out_proj.weight`, transposed

Depths and layer counts are read off the tree. A parameter or statistic
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


def _msdeform_pixel_decoder(t: _Table, layers: int, levels: int) -> None:
    prefix, dst0 = "sem_seg_head.pixel_decoder.", "pixel_decoder"
    trunk = (dst0, "trunk")
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
    t.conv(prefix + "mask_features", (dst0, "mask_features"))


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
    backbone = [n for top, n in names if top == "backbone"]
    trunk = [p[2] for p in flat if p[:2] == ("pixel_decoder", "trunk")]
    predictor = [n for top, n in names if top == "predictor"]
    mask_embed = [p[2] for p in flat if p[:2] == ("predictor", "mask_embed")]
    n_stages = _count(backbone, r"out_norm(\d+)")
    depths = [_count([n for n in backbone if n.startswith(f"layers_{i}_blocks_")], rf"layers_{i}_blocks_(\d+)")
              for i in range(n_stages)]
    t = _Table()
    _swin(t, depths)
    _msdeform_pixel_decoder(t, layers=_count(trunk, r"encoder_layer_(\d+)"),
                            levels=_count(trunk, r"input_proj_(\d+)_conv"))
    _query_decoder(t, dec_layers=_count(predictor, r"cross_attn_(\d+)"),
                   class_dec_layers=_count(predictor, r"class_dec_(\d+)"),
                   mask_embed_layers=_count(mask_embed, r"layers_(\d+)"))
    _task_mlp(t)
    _transdssl(t)
    _pose_decoder(t)
    _motion_decoder(t, "motion_decoder")
    _motion_decoder(t, "motion_mask")
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
