"""Carry weights across from the JAX package.

`state_dict_from_jax` turns a JAX-package flax parameter tree (numpy or jax
arrays) into this package's d2-named state dict: the inverse of the JAX
checkpoint converter's rules (`uni_encoder_tpu/engine/checkpoint.py`:
`convert_swin`, `convert_msdeform_pixel_decoder`, `convert_query_decoder`,
`convert_task_mlp`). This module keeps its own copy of those tables:

  * Dense kernel (in, out)      -> `.weight` = kernel.T
  * Conv kernel HWIO            -> `.weight` OIHW
  * LayerNorm/GroupNorm `scale` -> `.weight`
  * MHA `in_proj` / `out_proj_kernel` -> `in_proj_weight` / `out_proj.weight`, transposed

Depths and layer counts are read off the tree. A leaf that no rule places
raises, except under the sequence-path subtrees, which are not ported yet
and are skipped with a warning.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# top-level subtrees of the sequence path (pose/motion/depth), not ported yet
NOT_PORTED = ("depth_decoder", "pose_decoder", "motion_decoder", "motion_mask")

Path = Tuple[str, ...]

_INVERSE = {
    "ident": lambda v: v,
    "linear": lambda v: v.T,
    "conv": lambda v: v.transpose(3, 2, 0, 1),  # HWIO -> OIHW
}


class _Table:
    """(d2 source key, flax path, layout kind) records, built with the same
    rule vocabulary as the JAX converter."""

    def __init__(self):
        self.records: List[Tuple[str, Path, str]] = []

    def raw(self, src: str, dst: Path, kind: str = "ident"):
        self.records.append((src, dst, kind))

    def linear(self, src: str, dst: Path, bias: bool = True):
        self.raw(src + ".weight", dst + ("kernel",), "linear")
        if bias:
            self.raw(src + ".bias", dst + ("bias",))

    def conv(self, src: str, dst: Path, bias: bool = True):
        self.raw(src + ".weight", dst + ("kernel",), "conv")
        if bias:
            self.raw(src + ".bias", dst + ("bias",))

    def norm(self, src: str, dst: Path):
        self.raw(src + ".weight", dst + ("scale",))
        self.raw(src + ".bias", dst + ("bias",))

    def mha(self, src: str, dst: Path):
        self.raw(src + ".in_proj_weight", dst + ("in_proj",), "linear")
        self.raw(src + ".in_proj_bias", dst + ("in_proj_bias",))
        self.raw(src + ".out_proj.weight", dst + ("out_proj_kernel",), "linear")
        self.raw(src + ".out_proj.bias", dst + ("out_proj_bias",))


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


def _tables_for(flat: Dict[Path, np.ndarray]) -> _Table:
    """The rule table sized from the depths and layer counts in the tree."""
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
    return t


def state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's flax params as this package's d2-named state dict."""
    flat = _flatten(params)
    stats = _flatten(batch_stats or {})
    skipped = sorted({p[0] for p in list(flat) + list(stats) if p[0] in NOT_PORTED})
    flat = {p: v for p, v in flat.items() if p[0] not in NOT_PORTED}
    stray_stats = sorted(p for p in stats if p[0] not in NOT_PORTED)
    if stray_stats:
        raise KeyError(f"batch_stats leaves with no place in the port: {stray_stats[:8]}")

    out: Dict[str, torch.Tensor] = {}
    placed = set()
    for src, dst, kind in _tables_for(flat).records:
        if dst in flat:
            out[src] = torch.from_numpy(np.ascontiguousarray(_INVERSE[kind](flat[dst])))
            placed.add(dst)
    unplaced = sorted(set(flat) - placed)
    if unplaced:
        raise KeyError(f"{len(unplaced)} parameter leaves with no place in the port, e.g. {unplaced[:8]}")
    if skipped:
        warnings.warn(f"not ported yet, skipped: {', '.join(skipped)}")
    return out
