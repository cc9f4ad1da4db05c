"""The port's config reading against PyYAML and the JAX package.

The port reads config files (`config.parse_block_yaml`) and `a.b.c=value`
overrides (`config.parse_override`) without PyYAML; each must come out as
`yaml.safe_load` gives it, anything the readers do not read must raise, and
`load_config` must build the same Config as the JAX package's on the same
file and overrides, also with PyYAML unimportable.
"""

import math
import os
import sys

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


# ------------------------------------------------- config files without PyYAML
CONFIG_FILES = sorted(f for f in os.listdir(CONFIGS) if f.endswith(".yaml"))

# Block YAML the reader takes, with PyYAML's reading of each.
BLOCK_SUPPORTED = [
    "", "# only a comment\n", "a: 1\n",
    "a:\n  b: [1, 2]\n  c:\n  - x\n  - [1, [2, 3]]\nd: 'q # r'  # c\n",
    "a:\n- 1\n- 2\nb: ~\n",
    "a:\n    b: 1\n    c:\n        d: yes\ne: 1.5e+3\n",
    "a: http://x/y#z\n", "a:\n  -   [1]\n", "a: -1\nb: .5\nc: 1e-4\n", "x:\n# c\n  y: 1\n",
    "a:\n  b:\nc: 2\n", "a: 'x: y'\n", "_base_: other.yaml\nsolver:\n  amp: false\n",
]

# Block YAML PyYAML reads but the reader refuses.
BLOCK_UNSUPPORTED = [
    "a: &x 1\n", "a: *x\n", "a: {b: 1}\n", "a: |\n  x\n", "a: >\n  x\n", "a: b\n  c\n", "a:\n\tb: 1\n",
    "- 1\n", "a:\n  - b: 1\n", "---\na: 1\n", "a: 1\na: 2\n", "'a': 1\n", "a: !!str 1\n",
    "a:\n  b: 1\n c: 2\n", "a: [1,\n  2]\n", "? a\n", "a:b\n", "a: 'x\n  y'\n", "a:\n  -\n    - 1\n",
    "%YAML 1.1\na: 1\n", "1: a\n",
]


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_block_yaml_reads_every_config_as_pyyaml(name):
    from uni_encoder_tpu_torch.config import parse_block_yaml

    with open(os.path.join(CONFIGS, name)) as f:
        text = f.read()
    assert _same_tree(parse_block_yaml(text, name), yaml.safe_load(text))


@pytest.mark.parametrize("text", BLOCK_SUPPORTED)
def test_block_yaml_matches_pyyaml(text):
    from uni_encoder_tpu_torch.config import parse_block_yaml

    assert _same_tree(parse_block_yaml(text), yaml.safe_load(text) or {})


@pytest.mark.parametrize("text", BLOCK_UNSUPPORTED)
def test_block_yaml_refuses_what_it_does_not_read(text):
    from uni_encoder_tpu_torch.config import parse_block_yaml

    with pytest.raises(ValueError):
        parse_block_yaml(text)


@pytest.mark.parametrize("name", CONFIG_FILES)
def test_load_config_matches_jax_with_pyyaml_blocked(name, monkeypatch):
    from uni_encoder_tpu.config import load_config as jax_load_config
    from uni_encoder_tpu.config import to_dict as jax_to_dict

    path = os.path.join(CONFIGS, name)
    want = jax_to_dict(jax_load_config(path, ["solver.base_lr=0.0002"]))
    monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` raises from here on
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    assert _same_tree(to_dict(load_config(path, ["solver.base_lr=0.0002"])), want)
