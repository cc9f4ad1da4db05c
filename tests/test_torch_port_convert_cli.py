"""The port's checkpoint-conversion command line
(`tools/convert_checkpoint_torch.py`) against the JAX package's
(`tools/convert_checkpoint.py`), on the CPU at the scaled profile
(tests/_torch_port_common.py).

The same two d2 `.pkl` files (later wins; one key the model does not own;
one conv given with 3 input channels, which `--duplicate-conv` widens to
6) go through both tools. The JAX tool writes orbax, read back on the CPU
and carried to d2 names by `engine/convert.py::state_dict_from_jax`; the
port's tool writes a port checkpoint. The two states are equal, both
print the same unconverted keys, and the port model built from the
port's checkpoint by `evaluate_torch.build_model` matches the JAX model on
the orbax variables at SEG_ATOL / SEQ_ATOL (rtol 1e-3 / 1e-4).
"""

import contextlib
import functools
import importlib.util
import io
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import _torch_port_common as common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUPLICATED = "motion_decoder.res_trans_conv.weight"  # (3, 6, 1, 1) in the model, given (3, 3, 1, 1)
# keys neither tool places: the text encoder (training only; the JAX converter has no rule for it)
NOT_OWNED = {"text_encoder.transformer.resblocks.0.attn.in_proj_weight": (12, 4),
             "text_encoder.positional_embedding": (77, 4)}
HW = (64, 128)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Both tools on the same inputs: {"port": state, "jax": state,
    "variables": orbax variables, "printed": (port, jax) stdout, ...}."""
    from uni_encoder_tpu.engine import checkpoint as jckpt
    from uni_encoder_tpu_torch.engine import checkpoint as ckpt
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("convert")
    state = common.random_d2_state(common.port_model(), seed=41)
    state["sem_seg_head.predictor.class_embed.weight"] *= 8.0
    rng = np.random.RandomState(41)
    narrow = rng.randn(3, 3, 1, 1).astype(np.float32)
    keys = sorted(state)
    first = {k: state[k] for k in keys[: len(keys) // 2 + 10]}  # overlaps the second file by 10 keys
    first.update({k: np.zeros_like(state[k]) for k in keys[len(keys) // 2: len(keys) // 2 + 10]})  # stale: overridden
    second = {k: state[k] for k in keys[len(keys) // 2:]}
    second[DUPLICATED] = narrow
    second.update({k: rng.randn(*s).astype(np.float32) for k, s in NOT_OWNED.items()})
    inputs = []
    for i, part in enumerate((first, second)):
        inputs.append(str(d / f"part{i}.pkl"))
        with open(inputs[-1], "wb") as f:
            pickle.dump({"model": part}, f)
    expected = dict(state)
    expected[DUPLICATED] = np.concatenate([narrow, narrow], axis=1) / 2.0

    # the JAX tool, its converter rules at the scaled depths
    tool = _load_tool("convert_checkpoint")
    jout = str(d / "orbax")
    patches = {"convert_swin": dict(depths=common.DEPTHS), "convert_msdeform_pixel_decoder": dict(layers=common.ENC_LAYERS),
               "convert_query_decoder": dict(dec_layers=common.DEC_LAYERS - 1)}
    saved = {name: getattr(jckpt, name) for name in patches}
    argv = sys.argv
    jprinted = io.StringIO()
    try:
        for name, kw in patches.items():
            setattr(jckpt, name, functools.partial(saved[name], **kw))
        sys.argv = ["convert_checkpoint.py", *inputs, "-o", jout, "--duplicate-conv", DUPLICATED]
        with contextlib.redirect_stdout(jprinted):
            tool.main()
    finally:
        sys.argv = argv
        for name, fn in saved.items():
            setattr(jckpt, name, fn)
    variables = jckpt.load_checkpoint(jout)

    # the port's tool
    port = _load_tool("convert_checkpoint_torch")
    pout = str(d / "port")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        path = port.main([*inputs, "-o", pout, "--duplicate-conv", DUPLICATED,
                          "--config", common.scaled_yaml(d / "s.yaml"), "--device", "cpu"])
    return {"port": ckpt.load_checkpoint(pout)["model"], "path": path, "dir": pout, "config": str(d / "s.yaml"),
            "jax": state_dict_from_jax(variables["params"], variables["batch_stats"]), "variables": variables,
            "expected": expected, "printed": (printed.getvalue(), jprinted.getvalue())}


def test_convert_cli_state_equals_jax_tools(converted):
    port, jax_state, expected = converted["port"], converted["jax"], converted["expected"]
    assert sorted(port) == sorted(jax_state) == sorted(expected)
    for k, v in jax_state.items():
        assert port[k].dtype == torch.float32, k
        np.testing.assert_array_equal(port[k].numpy(), v.numpy(), err_msg=k)
        np.testing.assert_array_equal(port[k].numpy(), expected[k], err_msg=k)
    assert converted["path"] == os.path.join(converted["dir"], "step_0.pt")


def test_convert_cli_prints_what_the_jax_tool_prints(converted):
    """The unconverted keys (the JAX tool's list) and the parameter count."""
    printed, jprinted = converted["printed"]
    warn = [line for line in printed.splitlines() if not line.startswith("converted")]
    assert warn == [line for line in jprinted.splitlines() if not line.startswith("converted")]
    assert warn == [f"WARNING: {len(NOT_OWNED)} source keys not converted:", *(f"  {k}" for k in sorted(NOT_OWNED))]
    n = sum(v.numel() for k, v in converted["port"].items() if not k.endswith(("running_mean", "running_var")))
    assert printed.splitlines()[-1] == f"converted {n / 1e6:.2f} M params -> {converted['dir']}"
    assert jprinted.splitlines()[-1].startswith(f"converted {n / 1e6:.2f} M params -> ")


def test_converted_checkpoint_forward_matches_jax(converted):
    import jax
    import jax.numpy as jnp

    import evaluate_torch
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    model, report = evaluate_torch.build_model(load_config(converted["config"]), converted["dir"], "cpu")
    assert report.unused == []
    rng = np.random.RandomState(42)
    img = rng.randn(1, *HW, 3).astype(np.float32)
    cur, prev = ((rng.randn(1, *HW, 3) * 0.5).astype(np.float32) for _ in range(2))
    tokens = np.asarray([tokenize_task("The task is panoptic")], np.int32)
    jmodel = J(common.make_cfg(JC))
    variables = converted["variables"]
    seg = jax.jit(jmodel.apply)(variables, jnp.asarray(img), jnp.asarray(tokens))
    seq = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, method=J.forward_sequence))(
        variables, jnp.asarray(cur), jnp.asarray(prev))
    with torch.inference_mode():
        pseg = model.forward_segmentation(common.t(img), common.t(tokens))
        pseq = model.forward_sequence(common.t(cur), common.t(prev))
    for k in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(pseg[k].numpy(), np.asarray(seg[k]), atol=common.SEG_ATOL, rtol=1e-3, err_msg=k)
    for k in ("disp", "motion_mask", "complete_flow", "cam_T_cam"):
        np.testing.assert_allclose(pseq[k].numpy(), np.asarray(seq[k]), atol=common.SEQ_ATOL, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("fault", ["missing_key", "shape_mismatch"])
def test_convert_cli_raises_on_missing_key_or_shape_mismatch(fault, tmp_path):
    tool = _load_tool("convert_checkpoint_torch")
    state = common.random_d2_state(common.port_model(), seed=43)
    if fault == "missing_key":
        del state["backbone.patch_embed.proj.weight"]
    else:
        state["sem_seg_head.predictor.class_embed.weight"] = np.zeros((3, 3), np.float32)
    src = tmp_path / "model.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, str(src))
    with pytest.raises(KeyError if fault == "missing_key" else ValueError,
                       match="backbone.patch_embed.proj.weight" if fault == "missing_key" else "class_embed"):
        tool.main([str(src), "-o", str(tmp_path / "out"), "--config", common.scaled_yaml(tmp_path / "s.yaml"),
                   "--device", "cpu"])
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("backbone", ["swin", "resnet", "convnext", "dinat"])
def test_convert_cli_backbone_selects_the_shipped_config(backbone):
    """`--backbone` reads the shipped config of that backbone (the JAX tool's
    choices); the port builds its full-width structure (no weights drawn)."""
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    tool = _load_tool("convert_checkpoint_torch")
    cfg = load_config(os.path.join(REPO, tool.BACKBONE_CONFIGS[backbone]))
    assert cfg.model.backbone.name == backbone
    keys = UniEncoder(cfg.model, device="meta").state_dict()
    assert any(k.startswith("backbone.") for k in keys)


def test_convert_cli_needs_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    tool = _load_tool("convert_checkpoint_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([str(tmp_path / "missing.pkl"), "-o", str(tmp_path / "out")])
