"""Reference-checkpoint loading and the port's own checkpoints
(`uni_encoder_tpu_torch/engine/checkpoint.py`) against the JAX package's
`engine/checkpoint.py`, on the CPU at the scaled profile
(tests/_torch_port_common.py).

A random d2 state dict is written as a d2 `.pkl` (a pickled numpy dict
under "model") and as a torch `.pth`; the port loads each through
`load_reference_state` + `load_into`, the JAX package through its own
`load_reference_state` and the converter calls of `jax_variables`, and the
segmentation and sequence forwards agree at SEG_ATOL / SEQ_ATOL (rtol
1e-3 / 1e-4, tests/test_whole_model_parity.py:52).
"""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t
from uni_encoder_tpu.engine import checkpoint as jckpt
from uni_encoder_tpu_torch.engine import checkpoint as ckpt

SEG_HW = (64, 128)
SEQ_HW = (64, 128)
# keys a reference checkpoint holds that no port module owns
PLANTED = {"motion_decoder.layer1.0.weight": (8, 4, 1, 1), "motion_mask.layer4.1.left.1.running_var": (8,),
           "text_encoder.transformer.resblocks.0.attn.in_proj_weight": (12, 4)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The random d2 state (seed 13) with the planted keys, written as .pkl
    and .pth; the JAX forwards on the JAX package's load of the .pkl."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    torch.set_num_threads(1)
    state = common.random_d2_state(common.port_model(), seed=13)
    rng = np.random.RandomState(0)
    extra = {k: rng.randn(*shape).astype(np.float32) for k, shape in PLANTED.items()}
    d = tmp_path_factory.mktemp("ckpt")
    paths = {"pkl": str(d / "model_final.pkl"), "pth": str(d / "model_final.pth")}
    with open(paths["pkl"], "wb") as f:
        pickle.dump({"model": {**state, **extra}, "__author__": "test"}, f)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in {**state, **extra}.items()}}, paths["pth"])

    jstate = jckpt.load_reference_state(paths["pkl"])
    variables = common.jax_variables({k: v for k, v in jstate.items() if k not in PLANTED})
    jmodel = J(common.make_cfg(JC))
    img = rng.randn(1, *SEG_HW, 3).astype(np.float32)
    cur, prev = ((rng.randn(1, *SEQ_HW, 3) * 0.5).astype(np.float32) for _ in range(2))
    tokens = np.asarray([tokenize_task("The task is panoptic")], np.int32)
    seg = jax.jit(jmodel.apply)(variables, jnp.asarray(img), jnp.asarray(tokens))
    seq = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, method=J.forward_sequence))(
        variables, jnp.asarray(cur), jnp.asarray(prev))
    ref = {"seg": {k: np.asarray(seg[k]) for k in ("pred_logits", "pred_masks")},
           "seq": {k: np.asarray(seq[k]) for k in ("disp", "motion_mask", "complete_flow", "cam_T_cam")}}
    return {"paths": paths, "state": state, "inputs": (img, tokens, cur, prev), "ref": ref, "jstate": jstate}


@pytest.mark.parametrize("fmt", ["pkl", "pth"])
def test_reference_file_forwards_match_jax(files, fmt):
    state = ckpt.load_reference_state(files["paths"][fmt])
    assert sorted(state) == sorted(files["jstate"])
    for k, v in files["jstate"].items():
        np.testing.assert_array_equal(state[k], v, err_msg=k)
    model = common.port_model()
    report = ckpt.load_into(model, state)
    assert report.unused == sorted(PLANTED)
    assert report.loaded == sorted(files["state"])
    img, tokens, cur, prev = files["inputs"]
    with torch.inference_mode():
        seg = model.forward_segmentation(t(img), t(tokens))
        seq = model.forward_sequence(t(cur), t(prev))
    for k, ref in files["ref"]["seg"].items():
        np.testing.assert_allclose(seg[k].numpy(), ref, atol=common.SEG_ATOL, rtol=1e-3, err_msg=k)
    for k, ref in files["ref"]["seq"].items():
        np.testing.assert_allclose(seq[k].numpy(), ref, atol=common.SEQ_ATOL, rtol=1e-4, err_msg=k)


def test_load_into_raises_on_a_missing_key_and_names_it(files):
    state = dict(files["state"])
    del state["sem_seg_head.predictor.class_embed.bias"]
    with pytest.raises(KeyError, match="sem_seg_head.predictor.class_embed.bias"):
        ckpt.load_into(common.port_model(), state)


def test_load_into_raises_on_a_shape_mismatch(files):
    state = dict(files["state"])
    key = "backbone.patch_embed.proj.weight"
    state[key] = np.zeros((1,) + state[key].shape[1:], np.float32)
    with pytest.raises(ValueError, match="backbone.patch_embed.proj.weight"):
        ckpt.load_into(common.port_model(), state)


LEGACY = {
    "sem_seg_head.predictor.query_feat.weight": np.zeros(2),
    "sem_seg_head.predictor.static_query.weight": np.ones(2),
    "sem_seg_head.adapter_1.weight": np.zeros(2),
    "sem_seg_head.pixel_decoder.mask_features.weight": np.zeros(2),
    "sem_seg_head.depth_decoder.layers.layer1_rn.weight": np.zeros(2),
    "backbone.norm0.weight": np.zeros(2),
}


def test_legacy_key_migrations_match_jax():
    got, ref = ckpt.migrate_legacy_keys(LEGACY), jckpt.migrate_legacy_keys(LEGACY)
    assert list(got) == list(ref)
    assert "sem_seg_head.pixel_decoder.adapter_1.weight" in got
    assert not any("static_query" in k for k in got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_merge_states_and_duplicate_input_conv_match_jax():
    a = {"x": np.zeros(1), "y": np.zeros(1)}
    b = {"y": np.ones(1), "z": np.ones(1)}
    got, ref = ckpt.merge_states(a, b), jckpt.merge_states(a, b)
    assert list(got) == list(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)
    w = np.random.RandomState(0).randn(8, 3, 7, 7).astype(np.float32)
    got, ref = ckpt.duplicate_input_conv({"k": w}, "k")["k"], jckpt.duplicate_input_conv({"k": w}, "k")["k"]
    assert got.shape == (8, 6, 7, 7)
    np.testing.assert_array_equal(got, ref)


def test_port_checkpoint_round_trips(tmp_path, files):
    model = common.port_model(files["state"])
    opt = {"count": 3, "mu": [torch.arange(4.0)], "names": [["a"]]}
    path = ckpt.save_checkpoint(str(tmp_path), model, opt, step=3)
    assert os.path.basename(path) == "step_3.pt"
    loaded = ckpt.load_checkpoint(str(tmp_path))
    assert loaded["step"] == 3 and loaded["optimizer"]["count"] == 3
    torch.testing.assert_close(loaded["optimizer"]["mu"][0], torch.arange(4.0), atol=0, rtol=0)
    other = common.port_model()
    assert ckpt.load_into(other, loaded["model"]).unused == []
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert sorted(os.listdir(tmp_path)) == ["last_checkpoint", "step_3.pt"]  # no temporary file left


def test_pointer_is_published_after_the_file(tmp_path, monkeypatch):
    """A save that dies before its pointer is written leaves the previous
    checkpoint the one that loads; the pointer never names a file that is
    not wholly written."""
    model = torch.nn.Linear(2, 2)
    ckpt.save_checkpoint(str(tmp_path), model, step=1)
    written = []
    real = ckpt._write_durable

    def write_then_die(dst, write):
        written.append(os.path.basename(dst))
        if os.path.basename(dst) == ckpt.POINTER:
            raise OSError("disk full")
        real(dst, write)

    monkeypatch.setattr(ckpt, "_write_durable", write_then_die)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(str(tmp_path), model, step=2)
    assert written == ["step_2.pt", ckpt.POINTER]
    assert os.path.exists(tmp_path / "step_2.pt")
    assert ckpt.load_checkpoint(str(tmp_path))["step"] == 1


def test_load_checkpoint_refuses_a_directory_without_pointer(tmp_path):
    with pytest.raises(FileNotFoundError, match="orbax"):
        ckpt.load_checkpoint(str(tmp_path))
