"""The port's CUDA kernels against their plain PyTorch versions. These need a
CUDA card and skip without one. They import neither jax nor the JAX
package, so on a machine without jax they run without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _msda_inputs(B, M, D, Lq, P, shapes, seed, device):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = torch.from_numpy(rng.randn(B, S, M, D).astype(np.float32)).to(device)
    loc = rng.uniform(-0.2, 1.2, size=(B, Lq, M, L, P, 2)).astype(np.float32)  # some out of range
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    loc_abs = torch.from_numpy(loc * wh[None, None, None, :, None, :] - np.float32(0.5)).to(device)
    attn = rng.rand(B, Lq, M, L, P).astype(np.float32)
    attn = torch.from_numpy(attn / attn.reshape(B, Lq, M, -1).sum(-1)[..., None, None]).to(device)
    return value, loc_abs.contiguous(), attn.contiguous()


@pytest.mark.parametrize("D", [8, 32, 24])
def test_ms_deform_attn_kernel_matches_plain(cuda, D):
    """fp32 at atol/rtol 1e-5; bf16 values within one bf16 ulp of the plain
    version plus the fp32 atol 1e-5 (both accumulate in fp32 and round
    once; the atol covers sums that cancel to near zero)."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_cuda, ms_deform_attn_plain

    shapes = ((6, 8), (3, 4), (2, 2))
    value, loc, attn = _msda_inputs(2, 4, D, 50, 4, shapes, 0, cuda)
    n0 = ms_deform_attn_cuda.launches
    got = ms_deform_attn_cuda(value, shapes, loc, attn)
    assert ms_deform_attn_cuda.launches == n0 + 1
    torch.testing.assert_close(got, ms_deform_attn_plain(value, shapes, loc, attn), atol=1e-5, rtol=1e-5)

    vb = value.to(torch.bfloat16)
    got = ms_deform_attn_cuda(vb, shapes, loc, attn).float()
    ref = ms_deform_attn_plain(vb, shapes, loc, attn).float()
    ulp = torch.where(ref == 0, torch.zeros_like(ref), 2.0 ** (torch.floor(torch.log2(ref.abs())) - 7))
    assert ((got - ref).abs() <= ulp + 1e-5).all()


def test_ms_deform_attn_kernel_rejects_bad_inputs(cuda):
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_cuda

    shapes = ((6, 8), (3, 4), (2, 2))
    value, loc, attn = _msda_inputs(1, 2, 8, 5, 4, shapes, 1, cuda)
    with pytest.raises(ValueError):
        ms_deform_attn_cuda(value.half(), shapes, loc, attn)
    with pytest.raises(ValueError):
        ms_deform_attn_cuda(value, shapes, loc.transpose(1, 2), attn)
    with pytest.raises(ValueError):
        ms_deform_attn_cuda(value, ((6, 8), (3, 4)), loc, attn)


def _blobby(seed, Q, K, h, w):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    masks = np.zeros((Q, h, w), np.float32)
    for q in range(Q):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.uniform(2, 8)
        masks[q] = (r - np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)) * rng.uniform(0.5, 2.0)
    cls = rng.randn(Q, K + 1).astype(np.float32) * 3
    return torch.from_numpy(cls), torch.from_numpy(masks).to(torch.bfloat16)


@pytest.mark.parametrize("Q,K,h,w", [(20, 7, 16, 32), (37, 19, 21, 45), (20, 13, 16, 32), (20, 29, 16, 32),
                                     (20, 40, 16, 32), (150, 133, 16, 32)])
def test_fused_postprocess_kernel_matches_plain(cuda, Q, K, h, w):
    """tests/test_fused_postprocess.py tolerances; reruns byte-identical.
    21 x 45 is ragged against the kernel's 64-row x 32-column tiles. K = 7,
    13, 19 and 29 run the 8-, 16-, 24- and 32-class register chunk once;
    K = 40 and 133 loop over 32-class chunks, and Q = 150 x K = 133 needs
    more than 48 KB of shared memory."""
    from uni_encoder_tpu_torch.inference.fused_postprocess import (
        fused_multitask_inference,
        fused_multitask_inference_plain,
        fused_postprocess_cuda,
    )

    cls, masks = _blobby(0, Q, K, h, w)
    cls, masks = cls.to(cuda), masks.to(cuda)
    thing = torch.zeros(K, dtype=torch.bool, device=cuda)
    thing[K // 2 :] = True
    kw = dict(object_mask_threshold=0.3, overlap_threshold=0.5, topk=Q)
    n0 = fused_postprocess_cuda.launches
    got = fused_multitask_inference(cls, masks, thing, **kw)
    assert fused_postprocess_cuda.launches == n0 + 1
    ref = fused_multitask_inference_plain(cls, masks, thing, **kw)
    for k in ("seg_id", "label", "isthing", "is_new_segment", "labels", "query_indices"):
        assert torch.equal(got[k].cpu(), ref[k].cpu()), k
    for k in ("sem_seg_argmax", "panoptic_seg"):
        assert got[k].dtype == torch.uint8 and got[k].shape == (4 * h, 4 * w)
        assert (got[k] != ref[k]).float().mean().item() < 3e-3, k
    torch.testing.assert_close(got["scores"], ref["scores"], atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(got["boxes"], ref["boxes"], atol=1.0, rtol=0.0)

    again = fused_multitask_inference(cls, masks, thing, **kw)
    for k in got:
        assert torch.equal(got[k], again[k]), k
