"""The port's config overrides against PyYAML and the JAX package.

The port parses `a.b.c=value` overrides without PyYAML (`config.parse_override`);
each value must come out as `yaml.safe_load` gives it, anything the parser
does not read must raise, and `load_config` must build the same Config as
the JAX package's on the same file and overrides.
"""

import math
import os

import pytest
import torch
import yaml

from uni_encoder_tpu_torch.config import load_config, parse_override, to_dict

torch.set_num_threads(1)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

# Values an override may hold, with PyYAML's reading of each.
SUPPORTED = [
    "1", "-3", "+4", "0", "-0", "1_000", "09",
    "1.5", "1.", "-.5", "+.5", ".5", "1_2.3_4", "1.5e+3",
    "1.5e3", "1e-4", "1e4",  # no dot or no sign: strings in YAML 1.1
    ".inf", "-.inf", "+.INF", ".nan",
    "true", "True", "TRUE", "false", "yes", "No", "on", "OFF",
    "null", "Null", "~", "",
    "abc", "a b", "a-b", "-abc", "a:b", "x/y.pkl", "http://host/w.pkl", "float32", "1.0.0", "v1.2",
    "(1, 2)", "'q'", '"q"', "'1'", '"true"', "''",
    "[]", "[1, 2]", "[ 1 ,2 ]", "[1, 2,]", "[0.5, 0.75, 1.0]", "[true, off, ~]",
    "[a, [b, c], 'd,e']", "[cityscapes_fine_sem_seg_val]", "[[1, 8, 1], [1, 4, 1, 4]]",
]

# Values PyYAML reads as something the port's parser does not build.
UNSUPPORTED = [
    "{a: 1}", "{}", "[{a: 1}]", "a: b", "a:", "- a", "-", "? a", "|", ">",
    "0x10", "012", "00", "0b1", "1:30", "2001-12-14",
    "&a x", "*a", "!!str 1", "'it''s'", '"a\\nb"', "'a", "a #c", "<<", "=",
    "[1,,2]", "[1, 2",
]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("text", SUPPORTED)
def test_parse_override_matches_yaml(text):
    assert _same(parse_override(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_parse_override_raises_where_it_would_differ(text):
    with pytest.raises(ValueError):
        parse_override(text)


OVERRIDE_SETS = [
    [],
    ["model.test.task=semantic", "model.test.aug_enabled=true", "model.dtype=bfloat16"],
    ["model.test.aug_min_sizes=[512, 1024]", "model.test.aug_flip=off", "solver.base_lr=0.0002"],
    ["solver.base_lr=1e-4", "solver.amp=no", "model.weights=/w/model_final.pkl"],
    ["datasets.depth_test=[kitti_test]", "datasets.seg_test_semantic=[]", "input.seg_min_size_test=512"],
    ["model.backbone.dinat.dilations=[[1, 8, 1], [1, 4, 1, 4]]", "model.pixel_mean=[1, 2.5, 3]"],
]


@pytest.mark.parametrize("config", [None, "cityscapes_swin_unified.yaml", "kitti_swin_unified.yaml"])
@pytest.mark.parametrize("overrides", OVERRIDE_SETS, ids=range(len(OVERRIDE_SETS)))
def test_load_config_matches_jax(config, overrides):
    from uni_encoder_tpu.config import load_config as jax_load_config
    from uni_encoder_tpu.config import to_dict as jax_to_dict

    path = os.path.join(CONFIGS, config) if config else None
    got = to_dict(load_config(path, overrides))
    assert _same_tree(got, jax_to_dict(jax_load_config(path, overrides)))


def _same_tree(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    return _same(a, b)


def test_load_config_refuses_a_flow_mapping():
    with pytest.raises(ValueError):
        load_config(None, ["model.test={task: semantic}"])
