"""A checkpoint of the JAX trainer reaches the port: the JAX package's
`save_checkpoint` writes a scaled model's params, batch_stats and
text_params as `train.py` does (orbax, `step_7/` and `last_checkpoint`);
`tools/orbax_to_numpy.py` turns the directory into one `.npz`;
`tools/convert_checkpoint_torch.py` turns that into a port checkpoint; and
`evaluate_torch.build_model` loads it, its forwards equal to JAX's `apply`
on the same variables (SEG_ATOL / rtol 1e-3, SEQ_ATOL / rtol 1e-4), the
text encoder left unused. The same checkpoint loads with strict=True into a
model built for training (`is_train`), text encoder included. The port's
`load_checkpoint` refuses the orbax directory with a message naming the two
commands.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 128)
TEXT_KEYS = ("text_encoder.", "text_projector.", "prompt_ctx.", "logit_scale")


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
def trained(tmp_path_factory):
    """The orbax directory, the .npz, the port checkpoint and the variables."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.engine import checkpoint as jckpt
    from uni_encoder_tpu.training.train_step import _TextEncoder

    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("orbax")
    state = common.random_d2_state(common.port_model(), seed=51)
    state["sem_seg_head.predictor.class_embed.weight"] *= 8.0
    variables = common.jax_variables(state)
    te = JC.TextEncoderConfig()
    enc = _TextEncoder(context_length=te.context_length, width=te.width, layers=te.num_layers,
                       vocab_size=te.vocab_size, hidden_dim=common.CONV_DIM, proj_num_layers=te.proj_num_layers,
                       n_ctx=te.n_ctx)
    text_params = jax.jit(enc.init)(jax.random.PRNGKey(5), jnp.ones((1, 2, te.context_length), jnp.int32))["params"]
    train_out = str(d / "train_out")
    os.makedirs(train_out)
    # train.py:174-179's call
    jckpt.save_checkpoint(train_out, {"params": variables["params"], "batch_stats": variables["batch_stats"],
                                      "text_params": text_params}, step=7)
    npz = _load_tool("orbax_to_numpy").main([train_out, "-o", str(d / "model.npz")])
    config = common.scaled_yaml(d / "s.yaml")
    port_dir = str(d / "port")
    _load_tool("convert_checkpoint_torch").main([npz, "-o", port_dir, "--config", config, "--device", "cpu"])
    return {"train_out": train_out, "npz": npz, "port_dir": port_dir, "config": config, "variables": variables,
            "text_params": jax.tree_util.tree_map(np.asarray, text_params)}


def test_npz_holds_every_leaf_keyed_by_collection_and_flax_path(trained):
    from uni_encoder_tpu_torch.engine.convert import _flatten

    with np.load(trained["npz"]) as arrays:
        files = set(arrays.files)
        for col, tree in (("params", trained["variables"]["params"]),
                          ("batch_stats", trained["variables"]["batch_stats"]),
                          ("text_params", trained["text_params"])):
            flat = _flatten(tree)
            assert {"/".join((col,) + p) for p in flat} <= files
            for p, v in flat.items():
                np.testing.assert_array_equal(arrays["/".join((col,) + p)], v)
        assert all(f.split("/")[0] in ("params", "batch_stats", "text_params") for f in files)


def test_trained_checkpoint_forward_matches_jax(trained):
    import evaluate_torch
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    model, report = evaluate_torch.build_model(load_config(trained["config"]), trained["port_dir"], "cpu")
    assert report.unused and all(k.startswith(TEXT_KEYS) for k in report.unused)
    rng = np.random.RandomState(52)
    img = rng.randn(1, *HW, 3).astype(np.float32)
    cur, prev = ((rng.randn(1, *HW, 3) * 0.5).astype(np.float32) for _ in range(2))
    tokens = np.asarray([tokenize_task("The task is semantic")], np.int32)
    jmodel, variables = J(common.make_cfg(JC)), trained["variables"]
    seg = jax.jit(jmodel.apply)(variables, jnp.asarray(img), jnp.asarray(tokens))
    seq = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, method=J.forward_sequence))(
        variables, jnp.asarray(cur), jnp.asarray(prev))
    with torch.inference_mode():
        pseg = model.forward_segmentation(t(img), t(tokens))
        pseq = model.forward_sequence(t(cur), t(prev))
    for k in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(pseg[k].numpy(), np.asarray(seg[k]), atol=common.SEG_ATOL, rtol=1e-3, err_msg=k)
    for k in ("disp", "motion_mask", "complete_flow", "cam_T_cam"):
        np.testing.assert_allclose(pseq[k].numpy(), np.asarray(seq[k]), atol=common.SEQ_ATOL, rtol=1e-4, err_msg=k)


def test_trained_checkpoint_loads_strictly_for_training(trained):
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine import checkpoint as ckpt
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    saved = ckpt.load_checkpoint(trained["port_dir"])["model"]
    model = UniEncoder(dataclasses.replace(common.make_cfg(TC), is_train=True), device="meta")
    model.load_state_dict(saved, strict=True, assign=True)
    text = state_dict_from_jax({}, text_params=trained["text_params"])
    assert sorted(k for k in saved if k.startswith(TEXT_KEYS)) == sorted(text)
    for k, v in text.items():
        assert torch.equal(saved[k], v), k


def test_port_refuses_the_orbax_directory_naming_both_commands(trained):
    from uni_encoder_tpu_torch.engine import checkpoint as ckpt

    with pytest.raises(FileNotFoundError) as err:
        ckpt.load_checkpoint(trained["train_out"])
    assert "tools/orbax_to_numpy.py" in str(err.value) and "tools/convert_checkpoint_torch.py" in str(err.value)
