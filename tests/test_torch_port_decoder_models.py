"""The whole port UniEncoder with the other decoders the JAX build_pixel_decoder
selects, against the JAX package on the CPU at the scaled profile
(tests/_torch_port_common.py) with overrides of the decoder names:

  (a) BasePixelDecoder + DCMNet,
  (b) TransformerEncoderPixelDecoder + DepthTransformerEncoderPixelDecoder,
  (c) MSDeformAttnPixelDecoder + DepthMSDeformAttnPixelDecoder.

The decoders and the query decoder are 64 wide (`convs_dim`, `mask_dim`,
`hidden_dim`; the depth heads' GroupNorm32 needs half of `convs_dim` to be
32). The weights come from one JAX init of both forwards
under jax.jit, carried across by `engine/convert.py::state_dict_from_jax`
and loaded with strict=True: forward_segmentation at SEG_ATOL / rtol 1e-3 and
forward_sequence at SEQ_ATOL / rtol 1e-4, as
tests/test_torch_port_backbone_models.py holds the backbones. Each depth
decoder's disp comes at its own stride, as in the JAX package, and the
Predictor hands it on so, as the JAX Predictor does. Also the
build_pixel_decoder's errors: an unknown name lists the known ones, and
MonodepthDecoder on the port's ResNet (stem at stride 4) raises where the
JAX model fails in a concatenate (a defect of the JAX package the port
names instead of copying).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t

MODELS = {"a": ("BasePixelDecoder", "DCMNet"),
          "b": ("TransformerEncoderPixelDecoder", "DepthTransformerEncoderPixelDecoder"),
          "c": ("MSDeformAttnPixelDecoder", "DepthMSDeformAttnPixelDecoder")}
DISP_STRIDE = {"a": 2, "b": 4, "c": 4}
SEG_HW, SEQ_HW = (128, 256), (64, 128)
WIDTH = 64  # convs_dim, mask_dim and the query decoder's hidden_dim


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def decoder_cfg(C, pixel, depth, backbone="swin"):
    cfg = common.make_cfg(C, backbone)
    return dataclasses.replace(
        cfg, one_former=dataclasses.replace(cfg.one_former, hidden_dim=WIDTH),
        sem_seg_head=dataclasses.replace(cfg.sem_seg_head, pixel_decoder_name=pixel, depth_decoder_name=depth,
                                         convs_dim=WIDTH, mask_dim=WIDTH))


def both_forwards(module, img, tok, cur, prev):
    return module.forward_segmentation(img, tok), module.forward_sequence(cur, prev)


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """The port model (weights from the JAX init), the JAX model, its
    variables and the model's letter."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    torch.set_num_threads(1)
    pixel, depth = MODELS[request.param]
    jmodel = J(decoder_cfg(JC, pixel, depth))
    img, tok = jnp.zeros((1, *SEG_HW, 3), jnp.float32), jnp.zeros((1, 77), jnp.int32)
    pair_img = jnp.zeros((1, *SEQ_HW, 3), jnp.float32)
    variables = jax.jit(lambda k, *xs: jmodel.init(k, *xs, method=both_forwards))(
        jax.random.PRNGKey(11), img, tok, pair_img, pair_img)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    # the class head scaled up so that queries clear the 0.8 keep threshold
    variables["params"]["predictor"]["class_embed"]["kernel"] = variables["params"]["predictor"]["class_embed"][
        "kernel"] * 8.0
    model = UniEncoder(decoder_cfg(TC, pixel, depth), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]), strict=True)
    return model, jmodel, variables, request.param


def test_decoder_model_segmentation_matches_jax(pair):
    from uni_encoder_tpu_torch.data.tokenizer import tokenize_task

    model, jmodel, variables, name = pair
    rng = np.random.RandomState(1)
    img = rng.randn(1, *SEG_HW, 3).astype(np.float32)
    tokens = np.asarray([tokenize_task("The task is panoptic")], np.int32)
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(img), jnp.asarray(tokens))
    with torch.inference_mode():
        got = model.forward_segmentation(t(img), t(tokens))
    assert tuple(got["pred_masks"].shape) == (1, common.NQ, SEG_HW[0] // 4, SEG_HW[1] // 4)
    for k in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=common.SEG_ATOL, rtol=1e-3,
                                   err_msg=f"({name}) {k}")


def test_decoder_model_sequence_matches_jax(pair):
    from uni_encoder_tpu.models.oneformer import UniEncoder as J

    model, jmodel, variables, name = pair
    rng = np.random.RandomState(2)
    cur, prev = ((rng.randn(1, *SEQ_HW, 3) * 0.5).astype(np.float32) for _ in range(2))
    ref = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, method=J.forward_sequence))(
        variables, jnp.asarray(cur), jnp.asarray(prev))
    with torch.inference_mode():
        got = model.forward_sequence(t(cur), t(prev))
    s = DISP_STRIDE[name]
    assert tuple(got["disp"].shape) == (1, SEQ_HW[0] // s, SEQ_HW[1] // s, 1)
    assert sorted(got) == sorted(ref)
    seq = dict(atol=common.SEQ_ATOL, rtol=1e-4)
    for k in ("disp", "motion_mask", "motion_prob", "complete_flow", "axisangle", "translation", "cam_T_cam"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=f"({name}) {k}", **seq)
    assert sorted(got["disps"]) == sorted(ref["disps"])
    for k, v in ref["disps"].items():
        np.testing.assert_allclose(got["disps"][k].numpy(), np.asarray(v), err_msg=f"({name}) {k}", **seq)


def test_decoder_model_predictor_sequence_matches_jax(pair):
    """The Predictor hands on disp at the depth decoder's own stride, as the
    JAX Predictor does."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.engine.predictor import Predictor as JPredictor
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine.predictor import Predictor

    model, _, variables, name = pair
    pixel, depth = MODELS[name]
    pred = Predictor(dataclasses.replace(TC.Config(), model=decoder_cfg(TC, pixel, depth)), model)
    jpred = JPredictor(dataclasses.replace(JC.Config(), model=decoder_cfg(JC, pixel, depth)), variables)
    rng = np.random.RandomState(3)
    item = {"image": rng.randint(0, 256, (*SEQ_HW, 3), np.uint8),
            "prev_image": rng.randint(0, 256, (*SEQ_HW, 3), np.uint8)}
    ref, got = jpred.infer_sequence(item), pred.infer_sequence(item)
    s = DISP_STRIDE[name]
    assert got["disp_results"].shape == (SEQ_HW[0] // s, SEQ_HW[1] // s)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], np.asarray(v), atol=common.SEQ_ATOL, rtol=1e-4, err_msg=f"({name}) {k}")


@pytest.mark.parametrize("slot", ["pixel_decoder_name", "depth_decoder_name"])
def test_unknown_decoder_name_lists_the_known_ones(slot):
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import DEPTH_DECODERS, SEGMENTATION_DECODERS, UniEncoder

    cfg = common.make_cfg(TC)
    cfg = dataclasses.replace(cfg, sem_seg_head=dataclasses.replace(cfg.sem_seg_head, **{slot: "FancyDecoder"}))
    with pytest.raises(ValueError, match="FancyDecoder") as err:
        UniEncoder(cfg, device="meta")
    known = DEPTH_DECODERS if slot == "depth_decoder_name" else SEGMENTATION_DECODERS
    assert all(name in str(err.value) for name in known)


def test_every_registered_decoder_builds():
    """Every name the JAX registry holds builds in its slot (the port's
    UniEncoder on meta; MonodepthDecoder has no backbone to build on)."""
    from uni_encoder_tpu.models import PIXEL_DECODERS
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import DEPTH_DECODERS, SEGMENTATION_DECODERS, UniEncoder

    assert sorted(PIXEL_DECODERS._map if hasattr(PIXEL_DECODERS, "_map") else PIXEL_DECODERS.keys()) == sorted(
        SEGMENTATION_DECODERS + DEPTH_DECODERS)
    for pixel in SEGMENTATION_DECODERS:
        for depth in DEPTH_DECODERS:
            if depth == "MonodepthDecoder":
                continue
            model = UniEncoder(decoder_cfg(TC, pixel, depth), device="meta")
            assert type(model.pixel_decoder).__name__ == pixel and type(model.depth_decoder).__name__ == depth


def test_monodepth_decoder_on_resnet_raises_where_jax_fails():
    """The JAX ResNet's stem comes after the max-pool, at stride 4, where
    monodepth2's decoder wants its first skip at stride 2: the JAX model
    fails in a concatenate of its forward, the port's build_pixel_decoder raises."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    with pytest.raises(ValueError, match="stride 2"):
        UniEncoder(decoder_cfg(TC, "MSDeformAttnPixelDecoder", "MonodepthDecoder", "resnet"), device="meta")
    jmodel = J(decoder_cfg(JC, "MSDeformAttnPixelDecoder", "MonodepthDecoder", "resnet"))
    x = jnp.zeros((1, 64, 128, 3), jnp.float32)
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(lambda k, a, b: jmodel.init(k, a, b, method=J.forward_sequence), jax.random.PRNGKey(0), x, x)
