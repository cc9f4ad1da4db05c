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


def _msda_inputs(B, M, D, Lq, shapes, seed, device, dtype):
    """Raw offsets and logits of the fused contract for L = 3, P = 4, with
    about one offset in ten far outside its map."""
    from uni_encoder_tpu_torch.models.pixel_decoders.msdeformattn import absolute_reference_points

    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    L, P = len(shapes), 4
    value = rng.randn(B, S, M, D).astype(np.float32)
    off = rng.uniform(-3, 3, size=(B, Lq, M * L * P * 2)).astype(np.float32)
    off[rng.rand(*off.shape) < 0.1] *= 10
    logits = (rng.randn(B, Lq, M * L * P) * 2).astype(np.float32)
    ref_abs = absolute_reference_points(tuple(shapes), device)[:, :Lq].contiguous()
    return tuple(torch.from_numpy(x).to(device, dtype) for x in (value, off, logits)) + (ref_abs,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [8, 32, 24])
def test_ms_deform_attn_kernel_matches_plain(cuda, D, dtype):
    """The fused kernel against sampling_inputs + ms_deform_attn_plain on
    the ragged levels ((6, 8), (3, 4), (2, 2)). fp32 at atol/rtol 1e-5;
    bf16 within one bf16 ulp of the plain version plus the fp32 atol 1e-5
    (both accumulate in fp32 and round once; the atol covers sums that
    cancel to near zero)."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_cuda, ms_deform_attn_fused_plain

    shapes = ((6, 8), (3, 4), (2, 2))
    value, off, logits, ref_abs = _msda_inputs(2, 4, D, 64, shapes, 0, cuda, getattr(torch, dtype))
    n0 = ms_deform_attn_fused_cuda.launches
    got = ms_deform_attn_fused_cuda(value, shapes, off, logits, ref_abs)
    assert ms_deform_attn_fused_cuda.launches == n0 + 1
    assert got.dtype == value.dtype and tuple(got.shape) == (2, 64, 4 * D)
    ref = ms_deform_attn_fused_plain(value, shapes, off, logits, ref_abs)
    if dtype == "float32":
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        got, ref = got.float(), ref.float()
        ulp = torch.where(ref == 0, torch.zeros_like(ref), 2.0 ** (torch.floor(torch.log2(ref.abs())) - 7))
        assert ((got - ref).abs() <= ulp + 1e-5).all()
    assert torch.equal(ms_deform_attn_fused_cuda(value, shapes, off, logits, ref_abs).float(), got.float())


def test_ms_deform_attn_kernel_rejects_bad_inputs(cuda):
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_cuda

    shapes = ((6, 8), (3, 4), (2, 2))
    value, off, logits, ref_abs = _msda_inputs(1, 2, 8, 5, shapes, 1, cuda, torch.float32)
    bad = (
        (value.half(), off, logits, ref_abs),  # dtype
        (value, off.to(torch.bfloat16), logits, ref_abs),  # mixed dtypes
        (value, off.repeat(1, 1, 2)[..., ::2], logits, ref_abs),  # strides
        (value, off, logits[..., :-2], ref_abs),  # shape
        (value, off, logits, ref_abs.cpu()),  # device
        (value[..., :7].contiguous(), off, logits, ref_abs),  # odd D
    )
    for args in bad:
        with pytest.raises(ValueError):
            ms_deform_attn_fused_cuda(args[0], shapes, *args[1:])
    with pytest.raises(ValueError):
        ms_deform_attn_fused_cuda(value, ((6, 8), (3, 4)), off, logits, ref_abs)


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
                                     (20, 40, 16, 32), (150, 133, 16, 32), (23, 19, 5, 19)])
def test_fused_postprocess_kernel_matches_plain(cuda, Q, K, h, w):
    """tests/test_fused_postprocess.py tolerances; reruns byte-identical.
    The kernel's tiles are 4 output rows x 64 columns and its query chunks
    32: 21 x 45 (84 x 180 out, Q = 37) and 5 x 19 (20 x 76 out, Q = 23) are
    ragged against both. K = 7, 13, 19 and 29 take one class group of 1, 2,
    3 and 4 mma n-tiles; K = 40 and 133 loop over 32-class groups, and
    Q = 150, K = 133 is the largest class count with the most queries."""
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


def test_forward_sequence_matches_cpu(cuda):
    """forward_sequence in fp32 on the card (TF32 off) against the CPU path,
    at the scaled profile of tests/_torch_port_common.py on a 64 x 128 pair,
    from one seed's weights: atol 1e-4, rtol 1e-3 (cuDNN sums in other
    orders than the CPU)."""
    import _torch_port_common as common
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    rng = np.random.RandomState(4)
    pair = [torch.from_numpy(rng.randn(1, 64, 128, 3).astype(np.float32)) for _ in range(2)]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        model = UniEncoder(common.make_cfg(TC), device=dev, seed=0)
        outs[dev.type] = model.forward_sequence(*(x.to(dev) for x in pair))
    for k in ("disp", "motion_mask", "complete_flow", "axisangle", "translation", "cam_T_cam"):
        torch.testing.assert_close(outs["cuda"][k].cpu(), outs["cpu"][k], atol=1e-4, rtol=1e-3, msg=k)
