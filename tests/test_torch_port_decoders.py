"""The decoders the JAX `build_pixel_decoder` selects besides the default pair,
each alone against the JAX package on the CPU, fp32, at scaled widths
(`convs_dim` 64): BasePixelDecoder, TransformerEncoderPixelDecoder,
DepthTransformerEncoderPixelDecoder, DepthMSDeformAttnPixelDecoder, DCMNet
and MonodepthDecoder. Each is initialised by JAX (under jax.jit), carried
across by `engine/convert.py::state_dict_from_jax` and loaded into the port's
module with strict=True; outputs within atol 1e-5, rtol 1e-4. Also the
pieces they are built of: DCMNet's adaptive average pool (torch's) against
the JAX copy's slices at sizes that do not divide, the reflect-padded conv
at pad 1 and GroupNorm32.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_common import t

TOL = dict(atol=1e-5, rtol=1e-4)
C = 64  # convs_dim
# res2..res5 widths at strides 4..32 of a 128x256 input (the scaled Swin's
# 32 x 2^i are narrower than GroupNorm's 32 groups need at res2 only)
WIDTHS = {"res2": 32, "res3": 64, "res4": 128, "res5": 256}
HW = (128, 256)
# monodepth2's pyramid, scaled: stem at stride 2, res2..res5 at 4..32
MONO_WIDTHS = {"stem": 16, "res2": 16, "res3": 32, "res4": 64, "res5": 128}
MONO_STRIDES = {"stem": 2, "res2": 4, "res3": 8, "res4": 16, "res5": 32}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _features(seed, widths, strides=None, hw=HW):
    rng = np.random.RandomState(seed)
    strides = strides or {f"res{i}": 2 ** i for i in range(2, 6)}
    return {k: rng.randn(1, hw[0] // strides[k], hw[1] // strides[k], c).astype(np.float32)
            for k, c in widths.items()}


def _carry(jmodule, port_module, feats, slot):
    """JAX init under jit -> state_dict_from_jax at `slot` -> the port module,
    strict. Returns the JAX outputs and the port's."""
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = jax.jit(jmodule.init)(jax.random.PRNGKey(3), jfeats)
    ref = jax.jit(jmodule.apply)(variables, jfeats)
    state = state_dict_from_jax({slot: variables["params"]}, {slot: variables.get("batch_stats", {})})
    prefix = f"sem_seg_head.{slot}."
    assert all(k.startswith(prefix) for k in state), sorted(state)[:4]
    port_module.load_state_dict({k[len(prefix):]: v for k, v in state.items()}, strict=True)
    with torch.inference_mode():
        got = port_module({k: t(v) for k, v in feats.items()})
    return ref, got


def _nchw(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", ["BasePixelDecoder", "TransformerEncoderPixelDecoder"])
def test_fpn_pixel_decoder_matches_jax(name):
    from uni_encoder_tpu.models.pixel_decoders import fpn as J
    from uni_encoder_tpu_torch.models.pixel_decoders import fpn as P

    feats = _features(0, WIDTHS)
    kw = dict(transformer_layers=2, nheads=4, dim_feedforward=128) if name != "BasePixelDecoder" else {}
    ref, got = _carry(getattr(J, name)(conv_dim=C, mask_dim=C, **kw),
                      getattr(P, name)(WIDTHS, conv_dim=C, mask_dim=C, **kw), feats, "pixel_decoder")
    (rmask, renc, rms), (gmask, genc, gms) = ref, got
    assert tuple(gmask.shape) == (1, C, HW[0] // 4, HW[1] // 4)
    np.testing.assert_allclose(_nchw(gmask), np.asarray(rmask), **TOL)
    assert len(gms) == len(rms) == 3
    for i, (g, r) in enumerate(zip(gms, rms)):
        np.testing.assert_allclose(_nchw(g), np.asarray(r), err_msg=f"level {i}", **TOL)
    if name == "BasePixelDecoder":
        assert genc is None and renc is None
    else:
        np.testing.assert_allclose(_nchw(genc), np.asarray(renc), **TOL)


def _assert_disps(ref, got, strides):
    assert sorted(got) == sorted(ref) == [("disp", s) for s in range(4)]
    for k, r in ref.items():
        s = strides[k[1]]
        assert tuple(got[k].shape) == (1, HW[0] // s, HW[1] // s, 1), (k, tuple(got[k].shape))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(r), err_msg=str(k), **TOL)


def test_depth_transformer_encoder_decoder_matches_jax():
    from uni_encoder_tpu.models.pixel_decoders.fpn import DepthTransformerEncoderPixelDecoder as J
    from uni_encoder_tpu_torch.models.pixel_decoders.fpn import DepthTransformerEncoderPixelDecoder as P

    kw = dict(conv_dim=C, transformer_layers=2, nheads=4, dim_feedforward=128)
    ref, got = _carry(J(**kw), P(WIDTHS, **kw), _features(1, WIDTHS), "depth_decoder")
    _assert_disps(ref, got, {s: 4 * 2 ** s for s in range(4)})


def test_depth_msdeformattn_decoder_matches_jax():
    """K2's plain version on the CPU (the deformable encoder's six layers
    cut to two)."""
    from uni_encoder_tpu.models.pixel_decoders.msdeformattn import DepthMSDeformAttnPixelDecoder as J
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import DepthMSDeformAttnPixelDecoder as P

    kw = dict(conv_dim=C, transformer_layers=2, n_heads=4)
    ref, got = _carry(J(**kw), P(WIDTHS, **kw), _features(2, WIDTHS), "depth_decoder")
    _assert_disps(ref, got, {s: 4 * 2 ** s for s in range(4)})


def test_dcmnet_matches_jax():
    """res5 is 4x8: the pools to 3 and 6 bins do not divide it."""
    from uni_encoder_tpu.models.pixel_decoders.dcmnet import DCMNet as J
    from uni_encoder_tpu_torch.models.pixel_decoders.dcmnet import DCMNet as P

    ref, got = _carry(J(channels=C), P(WIDTHS, channels=C), _features(3, WIDTHS), "depth_decoder")
    _assert_disps(ref, got, {s: 2 * 2 ** s for s in range(4)})


def test_monodepth_decoder_matches_jax():
    from uni_encoder_tpu.models.pixel_decoders.monodepth2 import MonodepthDecoder as J
    from uni_encoder_tpu_torch.models.pixel_decoders.monodepth2 import MonodepthDecoder as P

    ref, got = _carry(J(), P(MONO_WIDTHS), _features(4, MONO_WIDTHS, MONO_STRIDES), "depth_decoder")
    _assert_disps(ref, got, {s: 2 ** s for s in range(4)})


@pytest.mark.parametrize("hw,out", [((5, 7), 3), ((7, 5), 6), ((2, 4), 6), ((13, 9), 2), ((6, 6), 4), ((1, 3), 2)])
def test_adaptive_avg_pool_matches_jax_bins(hw, out):
    """torch's adaptive pool and the JAX copy's floor/ceil slices agree,
    also where the bins overlap or outnumber the rows."""
    from uni_encoder_tpu.models.pixel_decoders.dcmnet import adaptive_avg_pool as jpool
    from uni_encoder_tpu_torch.models.pixel_decoders.dcmnet import adaptive_avg_pool

    x = np.random.RandomState(hw[0] * 10 + out).randn(2, *hw, 5).astype(np.float32)
    got = adaptive_avg_pool(t(x), out)
    assert tuple(got.shape) == (2, out, out, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpool(jnp.asarray(x), out)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kernel", [3, 1])
def test_reflect_conv_matches_jax(kernel):
    """The reflect-padded NHWC conv (pad kernel // 2) against the JAX
    package's `Conv(padding_mode="reflect")`, on a map with an odd side."""
    from uni_encoder_tpu.models.layers import Conv
    from uni_encoder_tpu_torch.models.layers import reflect_conv

    x = np.random.RandomState(kernel).randn(2, 7, 10, 6).astype(np.float32)
    jconv = Conv(5, (kernel, kernel), padding=kernel // 2, padding_mode="reflect")
    variables = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": {"kernel": variables["params"]["kernel"],
                            "bias": jnp.asarray(np.random.RandomState(9).randn(5), jnp.float32)}}
    conv = reflect_conv(6, 5, kernel)
    with torch.no_grad():
        conv.weight.copy_(t(np.array(variables["params"]["kernel"]).transpose(3, 2, 0, 1)))
        conv.bias.copy_(t(np.array(variables["params"]["bias"])))
        got = conv(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jconv.apply(variables, jnp.asarray(x))), **TOL)


def test_group_norm32_matches_jax():
    from uni_encoder_tpu.models.layers import GroupNorm32 as J
    from uni_encoder_tpu_torch.models.layers import GroupNorm32

    rng = np.random.RandomState(5)
    x = (rng.randn(2, 6, 9, 64) * 3 + 1).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.randn(64)).astype(np.float32), (0.1 * rng.randn(64)).astype(np.float32)
    ref = J(64).apply({"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}, jnp.asarray(x))
    gn = GroupNorm32(64)
    assert gn.eps == 1e-5 and gn.num_groups == 32
    with torch.no_grad():
        gn.weight.copy_(t(scale))
        gn.bias.copy_(t(bias))
        got = gn(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
