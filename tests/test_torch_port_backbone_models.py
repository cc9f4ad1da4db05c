"""The whole port UniEncoder on the ResNet, ConvNeXt and DiNAT backbones
against the JAX package, on the CPU at the scaled profile
(tests/_torch_port_common.py): one random d2 state dict drives both, the JAX
side through its checkpoint converter. forward_segmentation at 224x448
(SEG_ATOL 5e-3 / rtol 1e-3) and forward_sequence at 128x256 (SEQ_ATOL 1e-5 /
rtol 1e-4), the tolerances of tests/test_torch_port_slice.py and
tests/test_torch_port_sequence.py. The scaled DiNAT's dilations put
sub-grids shorter than its kernel on both paths. Then the Predictor serves
each model from uint8 images.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t

SEQ = dict(atol=common.SEQ_ATOL, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["resnet", "convnext", "dinat"])
def pair(request):
    """The port model, the JAX model, its variables, and the backbone's name."""
    torch.set_num_threads(1)
    model, jmodel, variables, _ = common.model_pair(seed=17, backbone=request.param)
    return model, jmodel, variables, request.param


def test_forward_segmentation_matches_jax(pair):
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    model, jmodel, variables, name = pair
    rng = np.random.RandomState(1)
    img = rng.randn(1, common.H_IN, common.W_IN, 3).astype(np.float32)
    tokens = np.asarray([tokenize_task("The task is panoptic")], np.int32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img), jnp.asarray(tokens))
    with torch.inference_mode():  # as a serving caller holds it
        got = model.forward_segmentation(t(img), t(tokens))
    assert tuple(got["pred_masks"].shape) == (1, common.NQ, common.H_IN // 4, common.W_IN // 4)
    for k in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=common.SEG_ATOL, rtol=1e-3,
                                   err_msg=f"{name} {k}")


def test_forward_sequence_matches_jax(pair):
    from uni_encoder_tpu.models.oneformer import UniEncoder as J

    model, jmodel, variables, name = pair
    rng = np.random.RandomState(2)
    cur = (rng.randn(1, 128, 256, 3) * 0.5).astype(np.float32)
    prev = (rng.randn(1, 128, 256, 3) * 0.5).astype(np.float32)
    ref = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, method=J.forward_sequence))(
        variables, jnp.asarray(cur), jnp.asarray(prev))
    with torch.inference_mode():
        got = model.forward_sequence(t(cur), t(prev))
    assert sorted(got) == sorted(ref)
    for k in ("disp", "motion_mask", "motion_prob", "complete_flow", "axisangle", "translation", "cam_T_cam"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=f"{name} {k}", **SEQ)
    for group in ("disps", "complete_flows"):
        for k, v in ref[group].items():
            np.testing.assert_allclose(got[group][k].numpy(), np.asarray(v), err_msg=f"{name} {group} {k}", **SEQ)


def test_predictor_serves_the_model(pair):
    """The Predictor on the CPU, from uint8 images of a size that needs
    padding to /32: every output of the right shape and finite."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task
    from uni_encoder_tpu_torch.engine.predictor import Predictor

    model, _, _, name = pair
    pred = Predictor(dataclasses.replace(TC.Config(), model=common.make_cfg(TC, name)), model)
    pred.set_thing_ids(range(common.K // 2, common.K))
    rng = np.random.RandomState(3)
    seg = pred.infer_segmentation({"image": rng.randint(0, 256, (100, 180, 3), np.uint8),
                                   "task_tokens": np.asarray(tokenize_task("The task is panoptic"))})
    assert seg["sem_seg"].shape == (common.K, 100, 180) and np.isfinite(seg["sem_seg"]).all()
    assert seg["panoptic_seg"][0].shape == (100, 180)
    seq = pred.infer_sequence({"image": rng.randint(0, 256, (64, 128, 3), np.uint8),
                               "prev_image": rng.randint(0, 256, (64, 128, 3), np.uint8)})
    assert seq["disp_results"].shape == (64, 128) and seq["cam_T_cam"].shape == (4, 4)
    assert all(np.isfinite(v).all() for v in seq.values())
