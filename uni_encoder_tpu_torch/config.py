"""Typed configuration tree + YAML loader (the port's own copy of
`uni_encoder_tpu/config.py`, kept field-for-field identical so one config
drives both packages).

Functional equivalent of the reference's detectron2 CfgNode add-ons
(model/config.py: add_common_config / add_uni_encoder_config /
add_swin_config / add_dinat_config / add_convnext_config /
add_resnet_posenet_config) and the `_BASE_` YAML inheritance used by
configs/**/*.yaml. Differences by design:

  * frozen dataclasses (hashable, safe to share between modules);
  * `_base_` inheritance + dotted-path CLI overrides (`a.b.c=value`);
  * no `!!python/object/apply:eval` — computed lists are written out;
  * no PyYAML: config files are read by `parse_block_yaml` and
    `a.b.c=value` overrides by `parse_override`, which read the YAML the
    configs use and raise on the rest (the GPU machine has no PyYAML).
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


# --------------------------------------------------------------------------- model


@dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    patch_norm: bool = True
    drop_path_rate: float = 0.3  # training-only
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 18
    stem_out_channels: int = 64
    res2_out_channels: int = 64
    norm: str = "BN"
    out_features: Tuple[str, ...] = ("stem", "res2", "res3", "res4", "res5")


@dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    drop_path_rate: float = 0.4  # reference config.py:250 (training-only)
    layer_scale_init_value: float = 1e-6
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")


@dataclass(frozen=True)
class DiNATConfig:
    embed_dim: int = 64
    depths: Tuple[int, ...] = (3, 4, 18, 5)
    num_heads: Tuple[int, ...] = (2, 4, 8, 16)
    kernel_size: int = 7
    dilations: Tuple[Tuple[int, ...], ...] = (
        (1, 8, 1),
        (1, 4, 1, 4),
        (1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2),
        (1, 1, 1, 1, 1),
    )
    mlp_ratio: float = 3.0
    drop_path_rate: float = 0.2  # reference config.py:229 (training-only)
    out_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")


@dataclass(frozen=True)
class BackboneConfig:
    name: str = "swin"  # swin | resnet | convnext | dinat
    swin: SwinConfig = field(default_factory=SwinConfig)
    resnet: ResNetConfig = field(default_factory=ResNetConfig)
    convnext: ConvNeXtConfig = field(default_factory=ConvNeXtConfig)
    dinat: DiNATConfig = field(default_factory=DiNATConfig)


@dataclass(frozen=True)
class SemSegHeadConfig:
    num_classes: int = 19
    ignore_value: int = 255
    convs_dim: int = 256
    mask_dim: int = 256
    norm: str = "GN"
    pixel_decoder_name: str = "MSDeformAttnPixelDecoder"
    depth_decoder_name: str = "TransDSSL"
    in_features: Tuple[str, ...] = ("res2", "res3", "res4", "res5")
    deformable_transformer_encoder_in_features: Tuple[str, ...] = ("res3", "res4", "res5")
    common_stride: int = 4
    transformer_enc_layers: int = 6


@dataclass(frozen=True)
class OneFormerConfig:
    hidden_dim: int = 256
    num_object_queries: int = 150
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 10  # reference semantics: effective masked-attn rounds = dec_layers - 1
    class_dec_layers: int = 2
    enc_layers: int = 0
    pre_norm: bool = False
    use_task_norm: bool = True
    enforce_input_proj: bool = False
    size_divisibility: int = 32
    dropout: float = 0.1
    # training loss weights (parity with reference config; criterion is ours)
    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    contrastive_weight: float = 0.5
    contrastive_temperature: float = 0.07
    no_object_weight: float = 0.1
    deep_supervision: bool = True
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75


@dataclass(frozen=True)
class TextEncoderConfig:
    # reference MODEL.TEXT_ENCODER (config.py / Base yaml: WIDTH 256,
    # CONTEXT_LENGTH 77, NUM_LAYERS 6, VOCAB_SIZE 49408, PROJ_NUM_LAYERS 2)
    width: int = 256
    context_length: int = 77
    num_layers: int = 6
    vocab_size: int = 49408
    proj_num_layers: int = 2
    n_ctx: int = 16


@dataclass(frozen=True)
class TestConfig:
    semantic_on: bool = True
    instance_on: bool = True
    panoptic_on: bool = True
    depth_on: bool = True
    detection_on: bool = False
    object_mask_threshold: float = 0.8
    overlap_threshold: float = 0.8
    task: str = "panoptic"  # panoptic | semantic | instance
    detections_per_image: int = 150
    sem_seg_postprocessing_before_inference: bool = True
    # test-time augmentation (reference TEST.AUG)
    aug_enabled: bool = False
    aug_min_sizes: Tuple[int, ...] = (512, 768, 1024, 1280, 1536, 1792)
    aug_max_size: int = 4096
    aug_flip: bool = True


@dataclass(frozen=True)
class ModelConfig:
    meta_architecture: str = "UniEncoder"
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    sem_seg_head: SemSegHeadConfig = field(default_factory=SemSegHeadConfig)
    one_former: OneFormerConfig = field(default_factory=OneFormerConfig)
    text_encoder: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    test: TestConfig = field(default_factory=TestConfig)
    pixel_mean: Tuple[float, ...] = (123.675, 116.280, 103.530)
    pixel_std: Tuple[float, ...] = (58.395, 57.120, 57.375)
    weights: str = ""
    is_train: bool = False
    is_demo: bool = False
    # compute dtype for the jitted forward ("float32" | "bfloat16")
    dtype: str = "float32"
    # disparity-pyramid scale count for the sequence (depth/motion) path.
    # The reference trains with 4 (monodepth_loss.py num_scales); the
    # multichip dryrun's micro config uses 2 to shrink the traced step graph
    # while keeping the identical loss/decoder structure.
    num_depth_scales: int = 4

    def __post_init__(self):
        # the disparity decoders (TransDSSL / monodepth2 / DCMNet) emit at
        # most scales 0..3; fail at the config instead of with a KeyError
        # deep inside forward_sequence_train / an empty-stack monodepth loss
        if not 1 <= self.num_depth_scales <= 4:
            raise ValueError(
                f"num_depth_scales must be in 1..4, got {self.num_depth_scales}"
            )


# --------------------------------------------------------------------------- input / data

# the production cityscapes multi-scale train recipe: short side sampled from
# 0.5x..2.0x of 1024 in 0.1 steps (reference model/config.py:110-113
# INPUT.SEG_MIN_SIZE_TRAIN). Single source of truth — SegmentationTrainMapper
# imports this for its keyword default.
SEG_MIN_SIZES_TRAIN: Tuple[int, ...] = tuple(int(x * 0.1 * 1024) for x in range(5, 21))


@dataclass(frozen=True)
class InputConfig:
    task_seq_len: int = 77
    max_seq_len: int = 77
    seg_min_size_test: int = 1024
    seg_max_size_test: int = 2048
    depth_min_size_test: int = 192
    depth_max_size_test: int = 512
    format: str = "RGB"
    # train-time sizes (reference model/config.py:110-128 —
    # INPUT.SEG_MIN_SIZE_TRAIN / INPUT.SEG_CROP.SIZE / INPUT.DEPTH_CROP.SIZE;
    # defaults follow the production cityscapes recipe)
    seg_crop_train: Tuple[int, int] = (512, 1024)
    seg_min_size_train: Tuple[int, ...] = SEG_MIN_SIZES_TRAIN
    seg_max_size_train: int = 4096
    depth_hw_train: Tuple[int, int] = (192, 512)


@dataclass(frozen=True)
class DatasetsConfig:
    train: Tuple[str, ...] = ("cityscapes_fine_panoptic_train",)
    seg_test_panoptic: Tuple[str, ...] = ("cityscapes_fine_panoptic_val",)
    seg_test_instance: Tuple[str, ...] = ("cityscapes_fine_instance_seg_val",)
    seg_test_semantic: Tuple[str, ...] = ("cityscapes_fine_sem_seg_val",)
    depth_test: Tuple[str, ...] = ("cityscapes_crop_test",)


@dataclass(frozen=True)
class SolverConfig:
    ims_per_batch: int = 16
    base_lr: float = 1e-4
    max_iter: int = 90000
    weight_decay: float = 0.05
    backbone_multiplier: float = 0.1
    clip_gradients_value: float = 0.01
    amp: bool = True


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    input: InputConfig = field(default_factory=InputConfig)
    datasets: DatasetsConfig = field(default_factory=DatasetsConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)


# --------------------------------------------------------------------------- loading


def _coerce(value: Any, typ: Any) -> Any:
    import typing

    origin = typing.get_origin(typ)
    if is_dataclass(typ) and isinstance(value, dict):
        return _from_dict(typ, value)
    if origin in (tuple, Tuple) and isinstance(value, (list, tuple)):
        args = typing.get_args(typ)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        return tuple(_coerce(v, t) for v, t in zip(value, args))
    if typ is float and isinstance(value, int):
        return float(value)
    return value


def _from_dict(cls, data: Dict[str, Any]):
    import typing

    hints = typing.get_type_hints(cls)
    names = {f.name for f in fields(cls)}
    kwargs = {}
    for k, v in data.items():
        key = k.lower()
        if key not in names:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        kwargs[key] = _coerce(v, hints[key])
    return cls(**kwargs)


def _merge(base: Dict, overrides: Dict) -> Dict:
    out = dict(base)
    for k, v in overrides.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_tree(path: str) -> Dict[str, Any]:
    """The mapping of a config file (`parse_block_yaml`), with its `_base_`
    file's tree merged under it."""
    p = Path(path)
    with open(p) as f:
        data = parse_block_yaml(f.read(), str(p))
    base = data.pop("_base_", None)
    if base:
        parent = load_yaml_tree(str((p.parent / base).resolve()))
        data = _merge(parent, data)
    return data


# PyYAML's implicit resolvers (YAML 1.1) for the scalars an override holds.
_YAML_WORDS = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
    **dict.fromkeys(("", "~", "null", "Null", "NULL"), None),
}
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?")
_YAML_SPECIAL_FLOAT = {
    **dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"), float("inf")),
    **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), float("-inf")),
    **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan")),
}
# Plain scalars that PyYAML reads as something this parser does not build:
# other integer bases, sexagesimal numbers, timestamps, merge / value keys.
_YAML_UNSUPPORTED = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|="
)


def parse_override(text: str) -> Any:
    """The value of a `a.b.c=value` override, as `yaml.safe_load(text)`
    gives it, without PyYAML (absent on the GPU machine). It reads a plain
    or quoted scalar and a flow sequence `[x, y]` of such values; PyYAML's
    YAML 1.1 rules decide booleans (also yes/no/on/off), null, integers and
    floats (`1e-4` has no dot, so it stays a string, as in PyYAML). Anything
    else (a flow mapping, anchors, tags, escapes, other integer bases,
    timestamps) raises ValueError rather than being read differently."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow sequence in override {text!r}")
        items, depth, quote, start = [], 0, None, 1
        for i, ch in enumerate(text[1:-1], 1):
            if quote:
                quote = None if ch == quote else quote
            elif ch in "'\"":
                quote = ch
            elif ch in "[]":
                depth += 1 if ch == "[" else -1
            elif ch == "," and depth == 0:
                items.append(text[start:i])
                start = i + 1
        items.append(text[start:-1])
        if items[-1].strip() == "":  # `[]` and a trailing comma
            items.pop()
        if any(x.strip() == "" for x in items):
            raise ValueError(f"empty item in override {text!r}")
        return [parse_override(x) for x in items]
    if text[:1] in ("'", '"'):
        inner = text[1:-1]
        if len(text) < 2 or text[-1] != text[0] or text[0] in inner or "\\" in inner:
            raise ValueError(f"unsupported quoted string in override {text!r}")
        return inner
    if (text[:1] and text[:1] in "{}]&*!|>%@`#,") or text[:2] in ("- ", "? ", ": ") \
            or text in ("-", "?") or text.endswith(":") or ": " in text or " #" in text \
            or "\t" in text or _YAML_UNSUPPORTED.fullmatch(text):
        raise ValueError(f"override {text!r} is not a YAML scalar or flow sequence this parser reads")
    if text in _YAML_WORDS:
        return _YAML_WORDS[text]
    if _YAML_INT.fullmatch(text):
        return int(text.replace("_", ""))
    if _YAML_FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if text in _YAML_SPECIAL_FLOAT:
        return _YAML_SPECIAL_FLOAT[text]
    return text


_YAML_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?: +(.*))?")


def _strip_comment(line: str) -> str:
    """`line` without its comment: a `#` at the start or after a space,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i]
    return line


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def parse_block_yaml(text: str, source: str = "<string>") -> Dict[str, Any]:
    """The mapping a config file holds, as `yaml.safe_load` reads it, without
    PyYAML (absent on the GPU machine). It reads the block subset that
    configs/*.yaml use: mappings nested by indentation, with identifier
    keys; block lists of values (`- [1, 20, 1]`), indented under their key
    or level with it; values that `parse_override` reads (plain and quoted
    scalars by YAML 1.1's rules, flow lists, nested too); `#` comments. An
    empty value is None and an empty file {}. Anything else raises
    ValueError rather than being read differently: anchors and aliases,
    tags, flow mappings, block scalars (`|`, `>`) and plain scalars over
    several lines, mappings inside list items, tabs, document markers,
    duplicate keys."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise ValueError(f"{source}:{no}: tab character (indent with spaces)")
        body = _strip_comment(raw).rstrip()
        content = body.lstrip(" ")
        if not content:
            continue
        if content in ("---", "...") or content.startswith("%"):
            raise ValueError(f"{source}:{no}: document markers and directives are not read: {content!r}")
        lines.append((len(body) - len(content), content, no))
    if not lines:
        return {}

    def fail(i: int, why: str):
        indent, content, no = lines[i]
        raise ValueError(f"{source}:{no}: {why}: {content!r}")

    def value(i: int, text: str):
        try:
            return parse_override(text)
        except ValueError as e:
            fail(i, str(e))

    def block(i: int, indent: int):
        return sequence(i, indent) if _is_item(lines[i][1]) else mapping(i, indent)

    def mapping(i: int, indent: int):
        out: Dict[str, Any] = {}
        while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
            m = _YAML_KEY.fullmatch(lines[i][1])
            if not m:
                fail(i, "expected `key: value` or `key:` with an identifier key")
            key, rest = m.group(1), m.group(2)
            if key in out:
                fail(i, f"duplicate key {key!r}")
            if rest:
                out[key] = value(i, rest)
                i += 1
                if i < len(lines) and lines[i][0] > indent:
                    fail(i, "a value continued on the next line, or a block under a key that has a value")
            elif i + 1 < len(lines) and (lines[i + 1][0] > indent or
                                         (lines[i + 1][0] == indent and _is_item(lines[i + 1][1]))):
                out[key], i = block(i + 1, lines[i + 1][0])
            else:
                out[key] = None
                i += 1
        if i < len(lines) and lines[i][0] > indent:
            fail(i, "indentation that matches no enclosing block")
        return out, i

    def sequence(i: int, indent: int):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            rest = lines[i][1][1:].strip()
            if not rest or _YAML_KEY.fullmatch(rest):
                fail(i, "a list item must be a value on its line")
            out.append(value(i, rest))
            i += 1
            if i < len(lines) and lines[i][0] > indent:
                fail(i, "a list item continued on the next line")
        return out, i

    if _is_item(lines[0][1]):
        fail(0, "the top level of a config must be a mapping")
    tree, i = mapping(0, lines[0][0])
    if i < len(lines):
        fail(i, "indentation that matches no enclosing block")
    return tree


def _set_dotted(tree: Dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = parse_override(value) if isinstance(value, str) else value


def load_config(path: Optional[str] = None, overrides: Optional[list] = None) -> Config:
    """Load a Config from YAML (with `_base_` inheritance) + `a.b.c=v` overrides."""
    tree: Dict[str, Any] = load_yaml_tree(path) if path else {}
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        _set_dotted(tree, key.strip(), val.strip())
    return _from_dict(Config, tree)


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
