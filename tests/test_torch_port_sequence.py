"""The port's sequence path against the JAX package, on the CPU in fp32 at
the scaled profile (tests/_torch_port_common.py): geometry, the pose /
motion / depth decoders and the whole forward_sequence.

Inputs and weights are made with numpy from seeds; one random d2 state dict
drives both packages. Tolerances: geometry atol/rtol 1e-6; the decoders and
forward_sequence SEQ_ATOL 1e-5 / rtol 1e-4 (tests/test_whole_model_parity.py:52).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t

GEO_ATOL = 1e-6
SEQ = dict(atol=common.SEQ_ATOL, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The port model, the JAX model and its variables on one random d2
    state dict."""
    torch.set_num_threads(1)
    return common.model_pair(seed=11)[:3]


def _sub(variables, name):
    """The variables of one top-level submodule."""
    return {col: tree[name] for col, tree in variables.items() if name in tree}


def _features(seed, channels, h, w):
    """res2..res5 NHWC features of the given widths at strides 1, 2, 4, 8
    from (h, w)."""
    rng = np.random.RandomState(seed)
    return {f"res{i + 2}": rng.randn(1, h >> i, w >> i, c).astype(np.float32)
            for i, c in enumerate(channels)}


def _assert_tree_close(got, ref, **tol):
    assert sorted(got, key=str) == sorted(ref, key=str)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=str(k), **tol)


# -------------------------------------------------------------------- geometry
def _geometry_case(name, G, xp):
    """Run geometry case `name` with module `G` on arrays made by `xp`
    (jnp.asarray or torch.from_numpy) from seeded numpy inputs."""
    rng = np.random.RandomState(5)
    f32 = lambda a: xp(np.ascontiguousarray(a, np.float32))  # noqa: E731
    if name == "disp_depth":
        disp = f32(rng.rand(2, 8, 9, 1))
        scaled, depth = G.disp_to_depth(disp)
        return {"scaled": scaled, "depth": depth, "back": G.depth_to_disp(depth)}
    if name == "rot_from_axisangle":
        return {"rot": G.rot_from_axisangle(f32(rng.randn(4, 1, 3) * 0.5))}
    if name == "transformation_from_parameters":
        aa, tr = f32(rng.randn(3, 1, 3) * 0.3), f32(rng.randn(3, 1, 3))
        return {"fwd": G.transformation_from_parameters(aa, tr),
                "inv": G.transformation_from_parameters(aa, tr, invert=True),
                "trans": G.get_translation_matrix(tr)}
    if name == "backproject_project":
        H, W = 6, 10
        K = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
        T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        T[:, :3, 3] = rng.randn(2, 3) * 0.1
        depth = f32(1 + 5 * rng.rand(2, H, W, 1))
        pts = G.backproject_depth(depth, f32(np.linalg.inv(K)), H, W)
        pix, ego = G.project_3d(pts, f32(K), f32(T), H, W)
        pix0, ego0 = G.project_3d(pts, f32(K), None, H, W)
        return {"coords": G.pix_coords_homogeneous(H, W, 2), "points": pts, "pix": pix, "ego": ego,
                "pix_no_T": pix0, "ego_no_T": ego0}
    if name == "smooth_loss":
        disp, img = f32(rng.rand(2, 12, 16, 1)), f32(rng.rand(2, 12, 16, 3))
        return {"plain": G.compute_smooth_loss(disp), "edge_aware": G.compute_smooth_loss(disp, img)}
    if name == "ssim":
        return {"ssim": G.ssim(f32(rng.rand(2, 11, 14, 3)), f32(rng.rand(2, 11, 14, 3)))}
    if name == "depth_errors":
        gt = 1 + 4 * rng.rand(500)
        return G.compute_depth_errors(f32(gt), f32(gt * (1 + 0.3 * rng.randn(500)).clip(0.5)))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["disp_depth", "rot_from_axisangle", "transformation_from_parameters",
                                  "backproject_project", "smooth_loss", "ssim", "depth_errors"])
def test_geometry_matches_jax(name):
    from uni_encoder_tpu import geometry as JG
    from uni_encoder_tpu_torch import geometry as TG

    ref = _geometry_case(name, JG, jnp.asarray)
    got = _geometry_case(name, TG, torch.from_numpy)
    _assert_tree_close(got, ref, atol=GEO_ATOL, rtol=GEO_ATOL)


# -------------------------------------------------------------------- decoders
def _pair_channels(model):
    return [2 * c for c in model.backbone.out_channels.values()]


def test_pose_decoder_matches_jax(pair):
    from uni_encoder_tpu.models.pose_decoder import ResNetLikePoseDecoder as J

    model, _, variables = pair
    feats = _features(1, _pair_channels(model), 24, 40)
    ref = jax.jit(J().apply)(_sub(variables, "pose_decoder"), {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        got = model.pose_decoder({k: t(v) for k, v in feats.items()})
    assert tuple(got[0].shape) == (1, 2, 1, 3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SEQ)


@pytest.mark.parametrize("which,out_dim", [("motion_decoder", 3), ("motion_mask", 1)])
def test_motion_decoder_matches_jax(pair, which, out_dim):
    """MotionDecoderV2 from a 1x1 ego-motion seed up to the full-res pair,
    every emitted scale."""
    from uni_encoder_tpu.models.motion_decoder import MotionDecoderV2 as J

    model, _, variables = pair
    feats = _features(2, _pair_channels(model), 16, 32)
    rng = np.random.RandomState(3)
    full_res = rng.randn(1, 64, 128, 6).astype(np.float32)
    ego = (rng.randn(1, 1, 1, 6) * 0.01).astype(np.float32)
    jmod = J(out_dim=out_dim)
    ref = jax.jit(jmod.apply)(_sub(variables, which), jnp.asarray(full_res),
                              {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(ego))
    with torch.no_grad():
        got = getattr(model, which)(t(full_res), {k: t(v) for k, v in feats.items()}, t(ego))
    assert len(got) == 4 * (2 if out_dim == 1 else 1)
    _assert_tree_close(got, ref, **SEQ)


def test_transdssl_matches_jax(pair):
    from uni_encoder_tpu.models.pixel_decoders.transdssl import TransDSSL as J

    model, _, variables = pair
    feats = _features(4, list(model.backbone.out_channels.values()), 16, 32)
    ref = jax.jit(J(features=common.CONV_DIM).apply)(_sub(variables, "depth_decoder"),
                                                     {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        got = model.depth_decoder({k: t(v) for k, v in feats.items()})
    assert tuple(got[("disp", 0)].shape) == (1, 64, 128, 1)  # 4x res2
    _assert_tree_close(got, ref, **SEQ)


def test_soft_att_depth_keeps_dtype():
    from uni_encoder_tpu_torch.models.pixel_decoders.transdssl import soft_att_depth

    x = torch.randn(1, 3, 4, 32, dtype=torch.bfloat16)
    out = soft_att_depth(x)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 3, 4, 1)
    ref = (torch.softmax(x.float(), -1) * torch.linspace(0.01, 1.0, 32)).sum(-1, keepdim=True)
    torch.testing.assert_close(out.float(), ref.to(torch.bfloat16).float(), atol=0, rtol=0)


# ------------------------------------------------------------ forward_sequence
def test_forward_sequence_matches_jax(pair):
    """The whole sequence forward at 128x256: one 2B backbone pass, pose,
    both motion decoders and TransDSSL, every output key."""
    from uni_encoder_tpu.models.oneformer import UniEncoder as J

    model, jmodel, variables = pair
    rng = np.random.RandomState(2)
    cur = (rng.randn(1, 128, 256, 3) * 0.5).astype(np.float32)
    prev = (rng.randn(1, 128, 256, 3) * 0.5).astype(np.float32)
    ref = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, method=J.forward_sequence))(
        variables, jnp.asarray(cur), jnp.asarray(prev))
    got = model.forward_sequence(t(cur), t(prev))
    assert sorted(got) == sorted(ref)
    for k in ("disp", "motion_mask", "motion_prob", "complete_flow", "axisangle", "translation", "cam_T_cam"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), err_msg=k, **SEQ)
    _assert_tree_close(got["disps"], ref["disps"], **SEQ)
    _assert_tree_close(got["complete_flows"], ref["complete_flows"], **SEQ)
    np.testing.assert_array_equal(got["cam_T_cam"][0, 3].numpy(), [0, 0, 0, 1])


def test_forward_sequence_needs_a_device_without_gpu(monkeypatch):
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine.predictor import Predictor
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UniEncoder(common.make_cfg(TC))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(dataclasses.replace(TC.Config(), model=common.make_cfg(TC)))
