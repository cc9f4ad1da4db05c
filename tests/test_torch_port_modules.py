"""Per-module parity of the PyTorch port (uni_encoder_tpu_torch) against the
JAX package, on the CPU in fp32, at the scaled profile.

Inputs and weights are made with numpy from seeds and fed to both sides.
Bound: atol 1e-4 unless a test states another (fp32 on both sides; the two
frameworks sum in different orders).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t

ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    # tier-1 runs several xdist workers on few cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    torch.set_num_threads(1)
    model = common.port_model()
    state = common.random_d2_state(model)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model, common.jax_params(state)


def test_position_embedding_sine_is_bit_identical():
    from uni_encoder_tpu.ops import position_embedding_sine as jpe
    from uni_encoder_tpu_torch.ops import position_embedding_sine as tpe

    for h, w, f in ((7, 14, 16), (28, 56, 128)):
        np.testing.assert_array_equal(tpe(h, w, f).numpy(), np.asarray(jpe(h, w, f)))


@pytest.mark.parametrize("mode,align_corners", [("bilinear", False), ("bilinear", True), ("nearest", False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interpolate(mode, align_corners, dtype):
    """Separable y-then-x resize, up and down. fp32 to 1e-6; bf16 bit-exact
    (both sides round after every bf16 op in the same order)."""
    from uni_encoder_tpu.ops import interpolate as jinterp
    from uni_encoder_tpu_torch.ops import interpolate as tinterp

    x = np.random.RandomState(0).randn(2, 9, 13, 5).astype(np.float32)
    for size in ((36, 52), (4, 6), (9, 27)):
        j = jinterp(jnp.asarray(x, dtype), size=size, mode=mode, align_corners=align_corners)
        p = tinterp(t(x).to(getattr(torch, dtype)), size=size, mode=mode, align_corners=align_corners)
        j = np.asarray(j.astype(jnp.float32))
        p = p.float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(p, j)
        else:
            np.testing.assert_allclose(p, j, atol=1e-6, rtol=1e-6)


def test_multihead_attention_bool_mask_with_fully_masked_row():
    """True = disallowed on both sides; a fully masked row is NaN on both
    (max-subtracted softmax of all -inf), compared as equal NaNs."""
    from uni_encoder_tpu.models.layers import MultiheadAttention as JMHA
    from uni_encoder_tpu_torch.models.layers import MultiheadAttention as TMHA

    E, H, B, Lq, Lk = 16, 4, 2, 5, 7
    rng = np.random.RandomState(3)
    mha = TMHA(E, H)
    params = {
        "in_proj": rng.randn(E, 3 * E).astype(np.float32) / 4,
        "in_proj_bias": rng.randn(3 * E).astype(np.float32) * 0.1,
        "out_proj_kernel": rng.randn(E, E).astype(np.float32) / 4,
        "out_proj_bias": rng.randn(E).astype(np.float32) * 0.1,
    }
    with torch.no_grad():
        mha.in_proj_weight.copy_(t(params["in_proj"].T))
        mha.in_proj_bias.copy_(t(params["in_proj_bias"]))
        mha.out_proj.weight.copy_(t(params["out_proj_kernel"].T))
        mha.out_proj.bias.copy_(t(params["out_proj_bias"]))
    q, k, v = (rng.randn(B, n, E).astype(np.float32) for n in (Lq, Lk, Lk))
    mask = rng.rand(B, 1, Lq, Lk) < 0.4
    mask[0, 0, 2] = True  # fully masked row
    mask[1, 0, :, 0] = False
    for m in (None, mask, mask[1, 0]):
        j = JMHA(E, H).apply({"params": params}, q, k, v, attn_mask=None if m is None else jnp.asarray(m))
        with torch.no_grad():
            p = mha(t(q), t(k), t(v), attn_mask=None if m is None else t(m))
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=ATOL, rtol=1e-4)
    assert np.isnan(p.numpy()).sum() == 0 and np.isnan(np.asarray(j)).sum() == 0
    assert np.isnan(np.asarray(JMHA(E, H).apply({"params": params}, q, k, v, attn_mask=jnp.asarray(mask)))[0, 2]).all()


def test_swin_shifted_block(weights):
    from uni_encoder_tpu.models.backbones.swin import SwinBlock as JBlock

    model, params = weights
    # 20 x 33 does not divide by the 7-token window: the pad/roll/unpad path
    x = np.random.RandomState(1).randn(1, 20, 33, common.EMBED).astype(np.float32)
    jblk = JBlock(dim=common.EMBED, num_heads=common.HEADS[0], window=7, shift=3)
    j = jax.jit(jblk.apply)({"params": params["backbone"]["layers_0_blocks_1"]}, jnp.asarray(x))
    blk = model.backbone.layers[0].blocks[1]
    assert blk.shift == 3
    with torch.no_grad():
        p = blk(t(x))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=ATOL, rtol=1e-4)


def test_swin_backbone(weights):
    from uni_encoder_tpu.models.backbones.swin import SwinTransformer as JSwin

    model, params = weights
    x = np.random.RandomState(2).randn(1, 64, 96, 3).astype(np.float32)
    jsw = JSwin(embed_dim=common.EMBED, depths=common.DEPTHS, num_heads=common.HEADS)
    j = jax.jit(jsw.apply)({"params": params["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        p = model.backbone(t(x))
    assert sorted(p) == sorted(j) == ["res2", "res3", "res4", "res5"]
    for name in j:
        np.testing.assert_allclose(p[name].numpy(), np.asarray(j[name]), atol=ATOL, rtol=1e-4, err_msg=name)


def _features(seed, h=56, w=112):
    """Random channels-last backbone features of the scaled profile."""
    rng = np.random.RandomState(seed)
    return {
        f"res{i + 2}": rng.randn(1, h >> i, w >> i, common.EMBED * 2 ** i).astype(np.float32)
        for i in range(4)
    }


def test_msdeform_attn_module(weights):
    """One deformable-attention block: offsets/softmax/absolute-coordinate
    algebra + the sampling op (its plain version on the CPU)."""
    from uni_encoder_tpu.models.pixel_decoders.msdeformattn import MSDeformAttnModule as JMod
    from uni_encoder_tpu.models.pixel_decoders.msdeformattn import _reference_points as jref
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import absolute_reference_points

    model, params = weights
    shapes = ((4, 7), (7, 14), (14, 28))
    N = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(4)
    query = rng.randn(1, N, common.CONV_DIM).astype(np.float32)
    value_src = rng.randn(1, N, common.CONV_DIM).astype(np.float32)
    jmod = JMod(d_model=common.CONV_DIM, n_levels=3, n_heads=common.NHEADS, n_points=4)
    j = jax.jit(jmod.apply, static_argnums=4)(
        {"params": params["pixel_decoder"]["trunk"]["encoder_layer_0"]["self_attn"]},
        jnp.asarray(query), jnp.asarray(jref(shapes)), jnp.asarray(value_src), shapes,
    )
    mod = model.pixel_decoder.transformer.encoder.layers[0].self_attn
    with torch.no_grad():
        p = mod(t(query), absolute_reference_points(shapes, "cpu"), t(value_src), shapes)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=ATOL, rtol=1e-4)


def test_pixel_decoder(weights):
    from uni_encoder_tpu.models.pixel_decoders.msdeformattn import MSDeformAttnPixelDecoder as JPD

    model, params = weights
    feats = _features(5)
    jpd = JPD(conv_dim=common.CONV_DIM, mask_dim=common.CONV_DIM, transformer_layers=common.ENC_LAYERS,
              n_heads=common.NHEADS)
    jmf, jlow, jms = jax.jit(jpd.apply)({"params": params["pixel_decoder"]}, {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        pmf, plow, pms = model.pixel_decoder({k: t(v) for k, v in feats.items()})
    nhwc = lambda x: x.permute(0, 2, 3, 1).numpy()  # noqa: E731
    np.testing.assert_allclose(nhwc(pmf), np.asarray(jmf), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(nhwc(plow), np.asarray(jlow), atol=ATOL, rtol=1e-4)
    assert len(pms) == len(jms) == 3
    for a, b in zip(pms, jms):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=ATOL, rtol=1e-4)


def test_query_decoder(weights):
    """Class transformer + 3 masked rounds. pred_masks are (Q, H4*W4) sums
    over 32 channels of O(1) terms: atol 1e-4 holds for the logits, the
    masks get 2e-4 for the longer reduction."""
    from uni_encoder_tpu.models.transformer_decoder import OneFormerQueryDecoder as JQD

    model, params = weights
    rng = np.random.RandomState(6)
    C = common.CONV_DIM
    ms = [rng.randn(1, h, w, C).astype(np.float32) for h, w in ((7, 14), (14, 28), (28, 56))]
    mf = rng.randn(1, 56, 112, C).astype(np.float32)
    task = rng.randn(1, C).astype(np.float32)
    jqd = JQD(num_classes=common.K, hidden_dim=C, num_queries=common.NQ, nheads=common.NHEADS,
              dim_feedforward=common.DFF, dec_layers=common.DEC_LAYERS - 1, class_dec_layers=2, mask_dim=C)
    j = jax.jit(jqd.apply)({"params": params["predictor"]}, [jnp.asarray(x) for x in ms], jnp.asarray(mf),
                           jnp.asarray(task))
    nchw = lambda x: t(x).permute(0, 3, 1, 2)  # noqa: E731
    with torch.no_grad():
        p = model.predictor([nchw(x) for x in ms], nchw(mf), t(task))
    assert tuple(p["pred_masks"].shape) == (1, common.NQ, 56, 112)
    np.testing.assert_allclose(p["pred_logits"].numpy(), np.asarray(j["pred_logits"]), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(p["pred_masks"].numpy(), np.asarray(j["pred_masks"]), atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_ms_deform_attn_plain_matches_jax(value_dtype):
    """The plain version of K2 against JAX ms_deform_attn and
    ms_deform_attn_corners, with out-of-range locations, atol/rtol 1e-5
    (tests/test_ms_deform_attn.py:51). The port takes absolute coordinates:
    loc * (W, H) - 0.5 per level, computed in fp32 as JAX does. With bf16
    values the output is compared after both sides round to bf16 once."""
    from uni_encoder_tpu.ops.ms_deform_attn import ms_deform_attn as jmsda
    from uni_encoder_tpu.ops.ms_deform_attn import ms_deform_attn_corners as jcorners
    from uni_encoder_tpu_torch.ops import ms_deform_attn

    rng = np.random.RandomState(11)
    B, M, D, Lq, P = 2, 4, 8, 37, 4
    shapes = ((6, 8), (3, 4), (2, 2))
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.randn(B, S, M, D).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(B, Lq, M, L, P, 2)).astype(np.float32)
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attn = attn / attn.reshape(B, Lq, M, -1).sum(-1)[..., None, None]
    wh = np.array([[w, h] for h, w in shapes], np.float32)  # (L, 2)
    loc_abs = (loc * wh[None, None, None, :, None, :] - np.float32(0.5)).astype(np.float32)

    jv = jnp.asarray(value, value_dtype)
    ref = np.asarray(jcorners(jv, shapes, jnp.asarray(loc), jnp.asarray(attn)).astype(jnp.float32))
    tv = t(value).to(getattr(torch, value_dtype))
    got = ms_deform_attn(tv, shapes, t(loc_abs), t(attn))
    assert got.dtype == tv.dtype and tuple(got.shape) == (B, Lq, M * D)
    if value_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
        j = np.asarray(jmsda(jv, shapes, jnp.asarray(loc), jnp.asarray(attn)))
        np.testing.assert_allclose(got.numpy(), j, atol=1e-5, rtol=1e-5)
    else:
        # both accumulate the same fp32 products and round once: at most one
        # bf16 ulp apart (2^-8 relative), from fp32 summation order
        np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-5, rtol=2 ** -8)
