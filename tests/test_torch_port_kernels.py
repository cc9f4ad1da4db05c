"""CPU evidence for the designs of the port's two CUDA kernels.

* K2, fused deformable sampling: its plain version (`sampling_inputs` +
  `ms_deform_attn_plain`, what the kernel computes from the raw Linear
  outputs) against the JAX `MSDeformAttnModule` in fp32, and bit-identical
  in bf16 to the unfused producer the module used before the fusion.
* K1, fused post-process: the semantic argmax with the product's operands
  rounded to TF32 (10-bit mantissa, round to nearest with ties away from
  zero, as cvt.rna.tf32.f32 does on the card) against the fp32 plain
  `semantic_inference` argmax.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from _torch_port_common import t


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C, M, L, P = 32, 4, 3, 4
SHAPES = ((4, 7), (7, 14), (14, 28))  # the scaled profile's three levels


def _msda_module(seed):
    """Random params of one deformable-attention block, as a flax tree and
    as the port's module."""
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import MSDeformAttnModule

    rng = np.random.RandomState(seed)
    params = {}
    for name, n_out, scale in (("value_proj", C, 1.0), ("sampling_offsets", M * L * P * 2, 2.0),
                               ("attention_weights", M * L * P, 1.0), ("output_proj", C, 1.0)):
        params[name] = {"kernel": (rng.randn(C, n_out) * scale / np.sqrt(C)).astype(np.float32),
                        "bias": (rng.randn(n_out) * 0.5 * scale).astype(np.float32)}
    mod = MSDeformAttnModule(C, L, M, P)
    with torch.no_grad():
        for name, p in params.items():
            getattr(mod, name).weight.copy_(t(p["kernel"].T))
            getattr(mod, name).bias.copy_(t(p["bias"]))
    return params, mod


def test_fused_msda_plain_matches_jax_module():
    """fp32, atol/rtol 1e-4 as test_msdeform_attn_module: the fused plain
    function fed the module's raw offsets and logits, then output_proj,
    against the JAX module (its own softmax, location math and sampler)."""
    from uni_encoder_tpu.models.pixel_decoders.msdeformattn import MSDeformAttnModule as JMod
    from uni_encoder_tpu.models.pixel_decoders.msdeformattn import _reference_points as jref
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import absolute_reference_points
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_plain

    params, mod = _msda_module(0)
    N = sum(h * w for h, w in SHAPES)
    rng = np.random.RandomState(1)
    query = rng.randn(1, N, C).astype(np.float32)
    value_src = rng.randn(1, N, C).astype(np.float32)
    j = jax.jit(JMod(d_model=C, n_levels=L, n_heads=M, n_points=P).apply, static_argnums=4)(
        {"params": params}, jnp.asarray(query), jnp.asarray(jref(SHAPES)), jnp.asarray(value_src), SHAPES,
    )
    with torch.no_grad():
        value = mod.value_proj(t(value_src)).view(1, N, M, C // M)
        out = ms_deform_attn_fused_plain(value, SHAPES, mod.sampling_offsets(t(query)),
                                         mod.attention_weights(t(query)), absolute_reference_points(SHAPES, "cpu"))
        p = mod.output_proj(out)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4, rtol=1e-4)


def test_fused_msda_plain_bf16_is_bit_identical_to_unfused_producer():
    """bf16 model: the fused plain function equals, bit for bit, the unfused
    producer (softmax on the bf16 logits, .float(), ref_abs + offset in
    fp32) followed by the sampling core."""
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import absolute_reference_points
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_plain, ms_deform_attn_plain

    _, mod = _msda_module(2)
    mod = mod.to(torch.bfloat16)
    N = sum(h * w for h, w in SHAPES)
    rng = np.random.RandomState(3)
    query = t(rng.randn(1, N, C).astype(np.float32)).to(torch.bfloat16)
    ref_abs = absolute_reference_points(SHAPES, "cpu")
    with torch.no_grad():
        value = mod.value_proj(query).view(1, N, M, C // M)
        off, logits = mod.sampling_offsets(query), mod.attention_weights(query)
        got = ms_deform_attn_fused_plain(value, SHAPES, off, logits, ref_abs)
        w = torch.softmax(logits.view(1, N, M, L * P), dim=-1).view(1, N, M, L, P).float()
        loc = ref_abs.permute(1, 0, 2)[None, :, None, :, None, :] + off.view(1, N, M, L, P, 2).float()
        ref = ms_deform_attn_plain(value, SHAPES, loc, w)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, N, C)
    assert torch.equal(got, ref)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 explicit mantissa bits), round to nearest, ties away
    from zero: add half of the dropped part to the magnitude, truncate."""
    bits = x.contiguous().numpy().view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return torch.from_numpy(bits.view(np.float32).copy())


@pytest.mark.parametrize("K", [19, 133])
def test_semantic_argmax_with_tf32_operands(K):
    """Q = 150 blobby fixture (tests/test_fused_postprocess.py's), 16 x 32 ->
    64 x 128: the kernel's TF32 semantic product against the fp32 plain
    version; per-pixel mismatch < 3e-3, the K1 map tolerance."""
    from uni_encoder_tpu_torch.inference.postprocess import semantic_inference
    from uni_encoder_tpu_torch.ops import resize_hw

    Q, h, w = 150, 16, 32
    rng = np.random.RandomState(K)
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.zeros((Q, h, w), np.float32)
    for q in range(Q):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.uniform(2, 8)
        masks[q] = (r - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)) * rng.uniform(0.5, 2.0)
    cls = t(rng.randn(Q, K + 1).astype(np.float32) * 3)
    up = resize_hw(t(masks).to(torch.bfloat16), (4 * h, 4 * w), dims=(1, 2), mode="bilinear").float()

    ref = semantic_inference(cls, up).argmax(dim=0)
    clsprob = torch.softmax(cls, dim=-1)[:, :K]
    got = torch.einsum("qc,qhw->chw", _tf32(clsprob), _tf32(torch.sigmoid(up))).argmax(dim=0)
    mismatch = (got != ref).float().mean().item()
    assert mismatch < 3e-3, mismatch
    # the rounding is real: TF32 operands differ from fp32 ones
    assert not torch.equal(_tf32(clsprob), clsprob)
