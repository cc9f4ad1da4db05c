"""The modules no config selects, against the JAX package on the CPU, fp32:
MotionDecoderV1 on the pose-encoder pyramid of tests/test_model_forward.py
(both output kinds), Monodepth2PoseModel on a 6-channel frame pair and
ContextDecoder at small widths, each JAX-initialised (under jax.jit) and
carried across by `engine/convert.py::state_dict_from_jax` at the slot the
reference gives it (`motion_decoder`, `pose_decoder`, `context_decoder`),
loaded with strict=True; outputs within atol 1e-5, rtol 1e-4. Then
`utils/misc` against the JAX copy, and K1's phase layout: the port's plain
version with `phase_layout=True` against the JAX Pallas kernel in interpret
mode with the same flag (tests/test_fused_postprocess.py's tolerances), and
`deinterleave_phases_np` round-tripping the default maps.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_common import t

TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(port_module, variables, slot):
    """state_dict_from_jax of `variables` placed at flax scope `slot`, into
    `port_module` with strict=True."""
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    state = state_dict_from_jax({slot: variables["params"]}, {slot: variables.get("batch_stats", {})})
    assert all(k.startswith(slot + ".") for k in state), sorted(state)[:4]
    port_module.load_state_dict({k[len(slot) + 1:]: v for k, v in state.items()}, strict=True)


def _pyramid(H=32, W=64):
    """tests/test_model_forward.py:99-130's pyramid."""
    rng = np.random.RandomState(0)
    pyr = {"full_res_input": rng.randn(1, H, W, 8), "stem": rng.randn(1, H // 2, W // 2, 64),
           "res2": rng.randn(1, H // 4, W // 4, 64), "res3": rng.randn(1, H // 8, W // 8, 128),
           "res4": rng.randn(1, H // 16, W // 16, 256), "res5": rng.randn(1, H // 32, W // 32, 512)}
    return {k: v.astype(np.float32) for k, v in pyr.items()}, (rng.randn(1, 1, 1, 6) * 0.01).astype(np.float32)


@pytest.mark.parametrize("out_dim", [3, 1])
def test_motion_decoder_v1_matches_jax(out_dim):
    from uni_encoder_tpu.models.motion_decoder import MotionDecoderV1 as J
    from uni_encoder_tpu_torch.models.motion_decoder import MotionDecoderV1

    pyr, ego = _pyramid()
    jpyr = {k: jnp.asarray(v) for k, v in pyr.items()}
    jm = J(out_dim=out_dim)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(out_dim), jpyr, jnp.asarray(ego))
    ref = jax.jit(jm.apply)(variables, jpyr, jnp.asarray(ego))
    model = MotionDecoderV1({k: v.shape[-1] for k, v in pyr.items()}, out_dim=out_dim)
    _load(model, variables, "motion_decoder")
    with torch.inference_mode():
        got = model({k: t(v) for k, v in pyr.items()}, t(ego))
    keys = ("complete_flow",) if out_dim == 3 else ("motion_prob", "motion_mask")
    assert sorted(got) == sorted(ref) == sorted((k, s) for k in keys for s in range(4))
    for k, r in ref.items():
        assert tuple(got[k].shape) == (1, 32 >> k[1], 64 >> k[1], out_dim)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), err_msg=str(k), **TOL)


def test_monodepth2_pose_model_matches_jax():
    """The ResNet-18 encoder with a 6-channel stem, its BatchNorm on
    statistics carried from a non-trivial batch_stats."""
    from uni_encoder_tpu.models.monodepth2_pose import Monodepth2PoseModel as J
    from uni_encoder_tpu_torch.models.monodepth2_pose import Monodepth2PoseModel

    rng = np.random.RandomState(1)
    pair = rng.randn(2, 64, 128, 6).astype(np.float32)
    jm = J()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(pair))
    variables = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * np.abs(rng.randn(*v.shape)).astype(np.float32), variables["batch_stats"])}
    ref = jax.jit(jm.apply)(variables, jnp.asarray(pair))
    model = Monodepth2PoseModel().eval()
    _load(model, variables, "pose_decoder")
    with torch.inference_mode():
        got = model(t(pair))
    for g, r, name in zip(got, ref, ("axisangle", "translation")):
        assert tuple(g.shape) == (2, 2, 1, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_context_decoder_matches_jax():
    from uni_encoder_tpu.models.text_transformer import ContextDecoder as J
    from uni_encoder_tpu_torch.models.text_transformer import ContextDecoder

    rng = np.random.RandomState(2)
    kw = dict(transformer_width=32, transformer_heads=4, transformer_layers=2, visual_dim=48)
    text, visual = rng.randn(2, 5, 48).astype(np.float32), rng.randn(2, 12, 48).astype(np.float32)
    jm = J(**kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(text), jnp.asarray(visual))
    # random biases and norm affines: the JAX init's are zeros and ones
    variables = {"params": jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.randn(*v.shape).astype(np.float32), variables["params"])}
    ref = jax.jit(jm.apply)(variables, jnp.asarray(text), jnp.asarray(visual))
    model = ContextDecoder(**kw)
    _load(model, variables, "context_decoder")
    with torch.inference_mode():
        got = model(t(text), t(visual))
    assert tuple(got.shape) == (2, 5, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _boxes(rng, n):
    xy = rng.rand(n, 2).astype(np.float32) * 50
    wh = rng.rand(n, 2).astype(np.float32) * 30
    return np.concatenate([xy, xy + wh], axis=1)


def test_misc_matches_jax():
    from uni_encoder_tpu.utils import misc as J
    from uni_encoder_tpu_torch.utils import misc as P

    rng = np.random.RandomState(3)
    x = np.concatenate([rng.rand(20), [0.0, 1.0, -0.5, 1.5, 1e-7]]).astype(np.float32)
    np.testing.assert_allclose(P.inverse_sigmoid(t(x)).numpy(), np.asarray(J.inverse_sigmoid(jnp.asarray(x))),
                               atol=1e-5, rtol=1e-6)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    b[0] = b[0, [0, 1, 0, 1]]  # an empty box: union 0 against itself
    cxcywh = np.array(J.box_xyxy_to_cxcywh(jnp.asarray(a)))
    np.testing.assert_allclose(P.box_xyxy_to_cxcywh(t(a)).numpy(), cxcywh, atol=1e-5)
    np.testing.assert_allclose(P.box_cxcywh_to_xyxy(t(cxcywh)).numpy(),
                               np.asarray(J.box_cxcywh_to_xyxy(jnp.asarray(cxcywh))), atol=1e-5)
    for args in ((a, b), (b, b)):
        iou, union = P.box_iou(*map(t, args))
        jiou, junion = J.box_iou(*map(jnp.asarray, args))
        np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(union.numpy(), np.asarray(junion), atol=1e-4, rtol=1e-6)
        np.testing.assert_allclose(P.generalized_box_iou(*map(t, args)).numpy(),
                                   np.asarray(J.generalized_box_iou(*map(jnp.asarray, args))), atol=1e-6, rtol=1e-5)
    masks = rng.rand(4, 9, 13) > 0.8
    masks[2] = False
    np.testing.assert_array_equal(P.masks_to_boxes(t(masks)).numpy(), np.asarray(J.masks_to_boxes(jnp.asarray(masks))))
    for dim, h, w, cls in ((16, 3, 5, False), (32, 4, 4, True)):
        np.testing.assert_array_equal(P.get_2d_sincos_pos_embed(dim, h, w, cls), J.get_2d_sincos_pos_embed(dim, h, w, cls))


def _blobby(seed, Q, K, h, w):
    """tests/test_fused_postprocess.py's fixture."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.zeros((Q, h, w), np.float32)
    for q in range(Q):
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.uniform(2, 8)
        masks[q] = (r - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)) * rng.uniform(0.5, 2.0)
    return (rng.randn(Q, K + 1) * 3).astype(np.float32), masks


@pytest.mark.parametrize("seed", [0, 1])
def test_phase_layout_matches_jax_kernel_interpret(seed):
    from uni_encoder_tpu.inference.fused_postprocess import fused_multitask_inference as jfused
    from uni_encoder_tpu_torch.inference.fused_postprocess import (
        deinterleave_phases_np,
        fused_multitask_inference,
    )

    Q, K, h, w = 20, 7, 16, 32
    cls, masks = _blobby(seed, Q, K, h, w)
    thing = np.arange(K) >= K // 2
    kw = dict(object_mask_threshold=0.3, overlap_threshold=0.5, topk=Q)
    ref = jfused(jnp.asarray(cls), jnp.asarray(masks, jnp.bfloat16), jnp.asarray(thing), interpret=True,
                 phase_layout=True, **kw)
    got = fused_multitask_inference(t(cls), t(masks).to(torch.bfloat16), t(thing), phase_layout=True, **kw)
    flat = fused_multitask_inference(t(cls), t(masks).to(torch.bfloat16), t(thing), **kw)
    for k in ("sem_seg_argmax", "panoptic_seg"):
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.dtype == r.dtype == np.uint8 and g.shape == r.shape == (4, 4, h, w), k
        assert (g != r).mean() < 3e-3, (k, (g != r).mean())
        # the layout is a permute of the (H, W) map: the decode gives it back byte for byte
        np.testing.assert_array_equal(deinterleave_phases_np(g), flat[k].numpy(), err_msg=k)
    for k in ("seg_id", "label", "isthing", "is_new_segment", "labels", "query_indices"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(ref["boxes"]), atol=1.0)


def test_deinterleave_phases_round_trips_and_matches_jax():
    from uni_encoder_tpu.inference.fused_postprocess import deinterleave_phases_np as jdeinterleave
    from uni_encoder_tpu_torch.inference.fused_postprocess import deinterleave_phases_np, interleave_phases

    m = np.random.RandomState(4).randint(0, 256, (24, 40)).astype(np.uint8)
    phases = interleave_phases(t(m)).numpy()
    assert phases.shape == (4, 4, 6, 10)
    for jy, jx, k, l in ((1, 2, 3, 4), (3, 0, 5, 9), (0, 3, 0, 0)):
        assert phases[jy, jx, k, l] == m[4 * k + jy, 4 * l + jx]
    np.testing.assert_array_equal(deinterleave_phases_np(phases), m)
    np.testing.assert_array_equal(jdeinterleave(phases), m)
