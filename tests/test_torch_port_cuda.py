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


def _msda_grads(fn, value, off, logits, ref_abs, shapes, grad_out):
    """(d value, d offsets, d logits) of <fn(...), grad_out>."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (value, off, logits)]
    out = fn(leaves[0], shapes, leaves[1], leaves[2], ref_abs)
    return torch.autograd.grad(out, leaves, grad_out)


@pytest.mark.parametrize("D", [8, 32, 24])
def test_ms_deform_attn_backward_kernel_matches_plain(cuda, D):
    """The backward kernel against autograd of the plain fused version, fp32,
    on the ragged levels ((6, 8), (3, 4), (2, 2)) with one offset in ten far
    outside its map. atol/rtol 1e-4: each gradient is an fp32 sum of up to a
    few hundred products, which the kernel takes in another order (d value
    exactly, in fixed point, rounded to fp32 once)."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_fused_backward_cuda,
        ms_deform_attn_fused_plain,
    )

    shapes = ((6, 8), (3, 4), (2, 2))
    value, off, logits, ref_abs = _msda_inputs(2, 4, D, 64, shapes, 2, cuda, torch.float32)
    grad_out = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 4 * D).astype(np.float32)).to(cuda)
    n0 = ms_deform_attn_fused_backward_cuda.launches
    got = ms_deform_attn_fused_backward_cuda(value, shapes, off, logits, ref_abs, grad_out)
    assert ms_deform_attn_fused_backward_cuda.launches == n0 + 1
    ref = _msda_grads(ms_deform_attn_fused_plain, value, off, logits, ref_abs, shapes, grad_out)
    for name, a, b in zip(("value", "offsets", "logits"), got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=name)
    with pytest.raises(ValueError):  # the backward kernel is fp32 only
        ms_deform_attn_fused_backward_cuda(value.bfloat16(), shapes, off.bfloat16(), logits.bfloat16(), ref_abs,
                                           grad_out)


@pytest.mark.parametrize("D", [8, 32, 24])
def test_ms_deform_attn_backward_kernel_is_deterministic(cuda, D):
    """Three reruns of the backward kernel on the same inputs give the same
    bytes in all three gradients (d value is summed in fixed point, so the
    order of its atomics does not matter)."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_backward_cuda

    shapes = ((6, 8), (3, 4), (2, 2))
    value, off, logits, ref_abs = _msda_inputs(2, 4, D, 64, shapes, 5, cuda, torch.float32)
    grad_out = torch.from_numpy(np.random.RandomState(6).randn(2, 64, 4 * D).astype(np.float32)).to(cuda)
    first = ms_deform_attn_fused_backward_cuda(value, shapes, off, logits, ref_abs, grad_out)
    for _ in range(3):
        again = ms_deform_attn_fused_backward_cuda(value, shapes, off, logits, ref_abs, grad_out)
        for name, a, b in zip(("value", "offsets", "logits"), first, again):
            assert torch.equal(a, b), name


def test_ms_deform_attn_backward_kernel_edge_cases(cuda):
    """grad_out all zero gives exactly zero gradients; one NaN in grad_out
    makes d value non-finite (all NaN), never silent zeros."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_backward_cuda

    shapes = ((6, 8), (3, 4), (2, 2))
    value, off, logits, ref_abs = _msda_inputs(2, 4, 32, 64, shapes, 7, cuda, torch.float32)
    zero = ms_deform_attn_fused_backward_cuda(value, shapes, off, logits, ref_abs,
                                              torch.zeros((2, 64, 128), device=cuda))
    for name, x in zip(("value", "offsets", "logits"), zero):
        assert bool((x == 0).all()), name
    grad_out = torch.from_numpy(np.random.RandomState(8).randn(2, 64, 128).astype(np.float32)).to(cuda)
    grad_out[1, 17, 33] = float("nan")
    grad_value = ms_deform_attn_fused_backward_cuda(value, shapes, off, logits, ref_abs, grad_out)[0]
    assert bool(torch.isnan(grad_value).all())


def test_deterministic_train_step_is_reproducible(cuda, monkeypatch):
    """Trainer(deterministic=True) at the micro config on the card: two steps
    from the same init, batch and draws give the same bytes in every
    gradient, loss and updated parameter. Both run on one stream of one
    process; chip_smoke.py's train_deterministic phase holds two processes
    to the same at the full width."""
    import _torch_port_common as common
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.training.train_step import Trainer

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    seg, seq = (common.tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda), b)
                for b in common.micro_batches())
    runs = []
    for _ in range(2):
        trainer = Trainer(common.micro_config(TC), device=cuda, deterministic=True)
        state = trainer.init(seed=0)
        draws = trainer.make_draws(torch.Generator().manual_seed(3), seg, seq, cuda)
        metrics = trainer.train_step(state, seg, seq, draws=draws)[1]
        params = dict(state.model.named_parameters())
        runs.append(({k: v.cpu() for k, v in metrics.items()},
                     {k: p.grad.cpu() for k, p in params.items() if p.grad is not None},
                     {k: p.detach().cpu() for k, p in params.items()}))
    assert not torch.are_deterministic_algorithms_enabled()
    assert runs[0][1]
    for a, b in zip(*runs):
        assert a.keys() == b.keys()
        assert [k for k in a if a[k].numpy().tobytes() != b[k].numpy().tobytes()] == []


def test_ms_deform_attn_cuda_op_carries_grad_fn(cuda):
    """On CUDA tensors the fused op is differentiable: its output has a
    grad_fn, the backward runs the backward kernel once, and the gradients
    match autograd of the plain version (atol/rtol 1e-4, as above); ref_abs
    gets none."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import (
        ms_deform_attn_fused,
        ms_deform_attn_fused_backward_cuda,
        ms_deform_attn_fused_plain,
    )

    shapes = ((6, 8), (3, 4), (2, 2))
    value, off, logits, ref_abs = _msda_inputs(1, 2, 32, 20, shapes, 4, cuda, torch.float32)
    grad_out = torch.ones((1, 20, 64), device=cuda)
    leaves = [x.clone().requires_grad_(True) for x in (value, off, logits)]
    out = ms_deform_attn_fused(leaves[0], shapes, leaves[1], leaves[2], ref_abs)
    assert out.grad_fn is not None
    n0 = ms_deform_attn_fused_backward_cuda.launches
    out.backward(grad_out)
    assert ms_deform_attn_fused_backward_cuda.launches == n0 + 1
    ref = _msda_grads(ms_deform_attn_fused_plain, value, off, logits, ref_abs, shapes, grad_out)
    for leaf, b in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, b, atol=1e-4, rtol=1e-4)
    with torch.inference_mode():
        assert ms_deform_attn_fused(value, shapes, off, logits, ref_abs).grad_fn is None
