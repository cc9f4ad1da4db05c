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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ms_deform_attn_kernel_on_scattered_queries(cuda, dtype):
    """K2 on the queries one rank of an image split by rows holds
    (`parallel/spatial.py`): image rows 32..63 of a 128x256 image, its rows
    of the levels at strides 32, 16 and 8 (grids (4, 8), (8, 16), (16, 32)),
    three runs of the level-major tokens, Lq = 168 of S = 672, with offsets
    reaching the whole value. The kernel on that subset against the plain
    version on all S queries, cut to the subset, at the tolerances above."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import ms_deform_attn_fused_cuda, ms_deform_attn_fused_plain

    shapes = ((4, 8), (8, 16), (16, 32))
    S = sum(h * w for h, w in shapes)
    value, off, logits, ref_abs = _msda_inputs(1, 8, 32, S, shapes, 3, cuda, getattr(torch, dtype))
    index, start = [], 0
    for (h, w), stride in zip(shapes, (32, 16, 8)):
        index.append(torch.arange(start + (32 // stride) * w, start + (64 // stride) * w))
        start += h * w
    index = torch.cat(index).to(cuda)
    assert index.numel() == 168 and (index.diff() > 1).sum() == 2
    got = ms_deform_attn_fused_cuda(value, shapes, off[:, index].contiguous(), logits[:, index].contiguous(),
                                    ref_abs[:, index].contiguous())
    ref = ms_deform_attn_fused_plain(value, shapes, off, logits, ref_abs)[:, index]
    assert tuple(got.shape) == (1, 168, 8 * 32)
    if dtype == "float32":
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        got, ref = got.float(), ref.float()
        ulp = torch.where(ref == 0, torch.zeros_like(ref), 2.0 ** (torch.floor(torch.log2(ref.abs())) - 7))
        assert ((got - ref).abs() <= ulp + 1e-5).all()


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


# ------------------------------------------------------------------------ K4
def _na_qkv(seed, B, H, W, nh, dh, kernel, device, dtype):
    """q, k, v as DiNAT's attention hands them to K4: views of one
    (B, H, W, 3, heads, dh) qkv tensor; and rpb."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(B, H, W, 3, nh, dh).astype(np.float32)).to(device, dtype)
    rpb = torch.from_numpy(rng.randn(nh, 2 * kernel - 1, 2 * kernel - 1).astype(np.float32)).to(device, dtype)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh", [1, 3, 6, 48])
@pytest.mark.parametrize("H,W,kernel,dilation", [
    (13, 21, 7, 1), (13, 21, 7, 2), (19, 27, 5, 1), (17, 9, 3, 1),  # tiles with ragged edges on both axes
    (5, 11, 3, 3), (7, 9, 5, 1), (6, 16, 7, 2),  # sub-grids shorter than the kernel: repeated keys
    (48, 64, 7, 20), (24, 64, 7, 5),
    (5, 11, 7, 12),  # maps shorter than the dilation: sub-grids of one key on both axes
    (3, 64, 7, 4),  # sub_len 1 on one axis only
    (20, 96, 7, 4),  # sub_len 5 < k on one axis only
    (21, 30, 9, 1), (29, 19, 11, 2), (40, 45, 13, 3),  # a warp's two rows span more than 8 halo rows
])
def test_neighborhood_attention_kernel_matches_plain(cuda, nh, dtype, H, W, kernel, dilation):
    """K4 on strided qkv views (B = 2: the views' batch stride) at head dim
    32 (the one it is built for) against the plain version on the same
    inputs, with the module's scale. The plain version computes in fp32 and
    rounds once, as the kernel does, in another order: fp32 atol/rtol 1e-5;
    bf16 within one bf16 ulp of the plain output plus 1e-5. Kernels 3 to
    13 (above 7 the bf16 kernel walks its keys in groups of 8 halo rows);
    ragged tiles (K4's are 8 x 8 sub-grid queries); sub-grids shorter than
    the kernel, where the clamped windows repeat keys, on one axis or both,
    down to one key."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d,
        neighborhood_attention_2d_cuda,
        neighborhood_attention_2d_plain,
    )

    dt, dh = getattr(torch, dtype), 32
    q, k, v, rpb = _na_qkv(H * W + nh, 2, H, W, nh, dh, kernel, cuda, dt)
    n0 = neighborhood_attention_2d_cuda.launches
    with torch.inference_mode():
        got = neighborhood_attention_2d(q, k, v, rpb, kernel, dilation, scale=dh ** -0.5)
    assert neighborhood_attention_2d_cuda.launches == n0 + 1
    assert got.dtype == dt and got.is_contiguous() and got.shape == q.shape
    ref = neighborhood_attention_2d_plain(q, k, v, rpb, kernel, dilation, scale=dh ** -0.5)
    if dt == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        got, ref = got.float(), ref.float()
        ulp = torch.where(ref == 0, torch.zeros_like(ref), 2.0 ** (torch.floor(torch.log2(ref.abs())) - 7))
        assert ((got - ref).abs() <= ulp + 1e-5).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dilation", [1, 20])
def test_neighborhood_attention_kernel_row_window_matches_plain(cuda, dtype, dilation):
    """K4 with a row window against its plain version with the same window,
    at DiNAT-L's stage-0 shape over a 1024x2048 frame (256x512, 6 heads,
    head dim 32; dilations 1 and 20) split by rows over 2 ranks as
    parallel/spatial.py splits it (rows 0-127 and 128-255) and over 3
    uneven ranks (0-95, 96-159, 160-255): each rank's queries read from
    the block of rows their windows reach (`reach_rows`), projected into one
    (B, rows, W, 3, heads, dh) buffer as the DiNAT layer does. The windows
    clamp at the whole map's edges. K4's tolerance: fp32 atol/rtol 1e-5,
    bf16 one ulp of the plain output plus 1e-5. One launch a call."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d_cuda,
        neighborhood_attention_2d_plain,
        reach_rows,
    )

    dt, H, kernel = getattr(torch, dtype), 256, 7
    q, k, v, rpb = _na_qkv(dilation, 1, H, 512, 6, 32, kernel, cuda, dt)
    qkv = torch.stack((q, k, v), dim=3)
    for lo, hi in ((0, 128), (128, 256), (0, 96), (96, 160), (160, 256)):
        k0, k1 = reach_rows(H, kernel, dilation, (lo, hi))
        block = qkv[:, k0:k1].contiguous()
        args = (block[:, lo - k0:hi - k0, :, 0], block[:, :, :, 1], block[:, :, :, 2], rpb, kernel, dilation,
                32 ** -0.5)
        n0 = neighborhood_attention_2d_cuda.launches
        with torch.inference_mode():
            got = neighborhood_attention_2d_cuda(*args, rows=(H, lo, k0))
        assert neighborhood_attention_2d_cuda.launches == n0 + 1
        assert got.shape == (1, hi - lo, 512, 6, 32) and got.is_contiguous()
        ref = neighborhood_attention_2d_plain(*args, rows=(H, lo, k0))
        if dt == torch.float32:
            torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
        else:
            got, ref = got.float(), ref.float()
            ulp = torch.where(ref == 0, torch.zeros_like(ref), 2.0 ** (torch.floor(torch.log2(ref.abs())) - 7))
            assert ((got - ref).abs() <= ulp + 1e-5).all(), (lo, hi)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_neighborhood_attention_kernel_reruns_byte_identical(cuda, dtype):
    """No atomics and a fixed order of every sum: three runs of K4 at a
    DiNAT-L stage-2 shape of the pair (B = 2, 12x32, 24 heads, dilation 3)
    give the same bytes."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_cuda

    q, k, v, rpb = _na_qkv(7, 2, 12, 32, 24, 32, 7, cuda, getattr(torch, dtype))
    with torch.inference_mode():
        runs = [neighborhood_attention_2d_cuda(q, k, v, rpb, 7, 3, scale=32 ** -0.5) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_neighborhood_attention_kernel_rejects_bad_inputs(cuda):
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_cuda

    q, k, v, rpb = _na_qkv(0, 1, 8, 8, 2, 32, 3, cuda, torch.float32)
    narrow = torch.zeros(1, 8, 8, 2, 8, device=cuda)
    shifted = torch.zeros(1 + 8 * 8 * 3 * 2 * 32, device=cuda)[1:].view(1, 8, 8, 3, 2, 32)  # 4 bytes off
    bad = (
        (q.half(), k.half(), v.half(), rpb.half()),  # dtype
        (q, k.to(torch.bfloat16), v, rpb),  # mixed dtypes
        (q, k.contiguous(), v, rpb),  # strides differ
        (narrow, narrow, narrow, rpb),  # a head dim the kernel is not built for
        (q, k, v, rpb[:, :3]),  # rpb shape
        (q, k, v, rpb.cpu()),  # device
        (shifted[:, :, :, 0], shifted[:, :, :, 1], shifted[:, :, :, 2], rpb),  # rows not 16-byte aligned
    )
    with torch.inference_mode():
        for args in bad:
            with pytest.raises(ValueError):
                neighborhood_attention_2d_cuda(*args, 3, 1)
        lse = torch.empty(1, 8, 8, 2, device=cuda)
        for args, bad_lse in (((q.bfloat16(), k.bfloat16(), v.bfloat16(), rpb.bfloat16()), lse),  # bf16 has none
                              ((q, k, v, rpb), lse[:, :4]),  # its shape
                              ((q, k, v, rpb), lse.double())):  # its dtype
            with pytest.raises(ValueError):
                neighborhood_attention_2d_cuda(*args, 3, 1, 1.0, bad_lse)


@pytest.mark.parametrize("H,W,kernel,dilation", [
    (13, 21, 7, 1), (19, 27, 5, 1), (5, 11, 3, 3), (6, 16, 7, 2), (5, 11, 7, 12), (3, 64, 7, 4), (20, 96, 7, 4),
    (40, 45, 13, 3),
])
def test_neighborhood_attention_kernel_lse_matches_plain(cuda, H, W, kernel, dilation):
    """The log-sum-exp K4's fp32 kernel writes for K5 (`lse`): each
    window's, repeated keys counted as often as the plain version lists them,
    against torch.logsumexp of the plain version's fp32 logits at atol/rtol
    1e-5 (the fp32 output's tolerance); the output's bytes are the same with
    and without it."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d_cuda,
        neighborhood_attention_2d_lse_plain,
    )

    q, k, v, rpb = _na_qkv(H * W + kernel, 2, H, W, 6, 32, kernel, cuda, torch.float32)
    lse = torch.empty(2, H, W, 6, device=cuda)
    with torch.inference_mode():
        got = neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, dilation, 32 ** -0.5, lse)
        assert torch.equal(got, neighborhood_attention_2d_cuda(q, k, v, rpb, kernel, dilation, 32 ** -0.5))
    ref = neighborhood_attention_2d_lse_plain(q, k, rpb, kernel, dilation, 32 ** -0.5)
    torch.testing.assert_close(lse, ref, atol=1e-5, rtol=1e-5)


def test_neighborhood_attention_kernel_has_no_backward(cuda):
    """K4 alone has no backward: with grad mode on and an input that
    requires grad, its wrapper and `neighborhood_attention_2d` raise instead
    of returning an output without a grad_fn; under no_grad they run.
    `neighborhood_attention_2d_qkv` pairs K4 with K5, and in bf16, which K5
    does not take, raises."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d,
        neighborhood_attention_2d_cuda,
        neighborhood_attention_2d_qkv,
    )

    q, k, v, rpb = _na_qkv(1, 1, 8, 8, 2, 32, 3, cuda, torch.float32)
    rpb = rpb.clone().requires_grad_(True)
    for fn in (neighborhood_attention_2d_cuda, neighborhood_attention_2d):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(q, k, v, rpb, 3)
    with torch.no_grad():
        assert neighborhood_attention_2d(q, k, v, rpb, 3).grad_fn is None
    qkv = torch.stack((q, k, v), dim=3)
    assert neighborhood_attention_2d_qkv(qkv, rpb, 3).grad_fn is not None
    with pytest.raises(ValueError, match="fp32 only"):
        neighborhood_attention_2d_qkv(qkv.bfloat16(), rpb.bfloat16(), 3)


# ------------------------------------------------------------------------ K5
# K5's tolerance against autograd of the plain version, both fp32 on the
# card: dqkv sums up to k * k (times a repeat count) products per element in
# another order, atol 2e-5 + rtol 1e-4; a drpb cell sums every query of a
# head (n = B * H * W terms, each carrying the rounding of a 32-long dot
# product; where every window is one key the exact sum is 0), atol
# 1e-6 * sqrt(32 n) + rtol 1e-4
def _k5_case(seed, B, H, W, nh, kernel, device, gain=1.0):
    """qkv (q and k times gain), rpb and grad_out from a numpy seed."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, H, W, 3, nh, 32).astype(np.float32)
    qkv[:, :, :, :2] *= gain
    qkv = torch.from_numpy(qkv).to(device)
    rpb = torch.from_numpy((0.5 * rng.randn(nh, 2 * kernel - 1, 2 * kernel - 1)).astype(np.float32)).to(device)
    grad_out = torch.from_numpy(rng.randn(B, H, W, nh, 32).astype(np.float32)).to(device)
    return qkv, rpb, grad_out


def _k4_forward(qkv, rpb, kernel, dilation, scale=32 ** -0.5):
    """K4's output and log-sum-exp, as NeighborhoodAttention2DFunction
    saves them for K5."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_cuda

    lse = torch.empty(qkv.shape[:3] + qkv.shape[4:5], device=qkv.device)
    with torch.no_grad():
        out = neighborhood_attention_2d_cuda(qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb, kernel, dilation,
                                             scale, lse)
    return out, lse


def _k5_check(got, ref, B, H, W):
    torch.testing.assert_close(got[0], ref[0], atol=2e-5, rtol=1e-4)
    torch.testing.assert_close(got[1], ref[1], atol=1e-6 * (32 * B * H * W) ** 0.5, rtol=1e-4)


@pytest.mark.parametrize("B,H,W,nh,kernel,dilation,gain", [
    (2, 128, 256, 6, 7, 1, 1), (2, 128, 256, 6, 7, 20, 1),  # a DiNAT-L training crop's stage 0 (6-row sub-grids at 20)
    (2, 64, 128, 12, 7, 10, 1), (2, 32, 64, 24, 7, 4, 1), (2, 16, 32, 48, 7, 2, 1),  # its stages 1-3
    (6, 48, 128, 6, 7, 20, 1), (6, 12, 32, 24, 7, 3, 1), (6, 6, 16, 48, 7, 2, 1),  # the 192x512 triples' pass: repeats
    (2, 13, 21, 3, 7, 1, 1), (2, 13, 21, 3, 7, 2, 1), (2, 19, 27, 3, 5, 1, 1), (2, 17, 9, 3, 3, 1, 1),  # ragged tiles
    (2, 5, 11, 3, 3, 3, 1), (2, 5, 11, 3, 7, 12, 1), (2, 3, 64, 3, 7, 4, 1), (2, 20, 96, 3, 7, 4, 1),  # short sub-grids
    (2, 21, 30, 3, 9, 1, 1), (2, 40, 45, 3, 13, 3, 1),  # kernels past 7
    (2, 13, 21, 3, 7, 1, 4),  # q and k 4x: logits to ~80, where one TF32 product per term misses by ~1000x
])
def test_neighborhood_attention_backward_kernel_matches_plain(cuda, B, H, W, nh, kernel, dilation, gain):
    """K5 against autograd of the plain version on the same qkv, rpb and
    grad_out, with the module's scale: DiNAT-L training shapes (the crop's
    at B = 2, the sequence pass's three frames at B = 6), edge shapes, and
    one shape whose large logits stress the 3xTF32 products (the plain fp32
    version against float64 uses a third of the tolerance there)."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d_backward_cuda,
        neighborhood_attention_2d_backward_plain,
    )

    qkv, rpb, grad_out = _k5_case(H * W + dilation, B, H, W, nh, kernel, cuda, gain)
    scale = 32 ** -0.5
    out, lse = _k4_forward(qkv, rpb, kernel, dilation, scale)
    n0 = neighborhood_attention_2d_backward_cuda.launches
    got = neighborhood_attention_2d_backward_cuda(qkv, rpb, out, lse, grad_out, kernel, dilation, scale)
    assert neighborhood_attention_2d_backward_cuda.launches == n0 + 1
    ref = neighborhood_attention_2d_backward_plain(qkv, rpb, grad_out, kernel, dilation, scale)
    _k5_check(got, ref, B, H, W)


def test_neighborhood_attention_backward_kernel_reruns_byte_identical(cuda):
    """No atomics and a fixed order of every sum: three runs of K5 at the
    triples' stage 0 at dilation 20 (B = 6, 48x128, 6 heads: sub-grids of 2
    and 3 rows) give the same bytes."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_backward_cuda

    qkv, rpb, grad_out = _k5_case(9, 6, 48, 128, 6, 7, cuda)
    out, lse = _k4_forward(qkv, rpb, 7, 20, 1.0)
    runs = [neighborhood_attention_2d_backward_cuda(qkv, rpb, out, lse, grad_out, 7, 20) for _ in range(3)]
    assert all(torch.equal(runs[0][i], r[i]) for r in runs[1:] for i in range(2))


def test_neighborhood_attention_autograd_runs_k4_then_k5(cuda):
    """`neighborhood_attention_2d_qkv` under autograd: K4's output (the
    no-grad path's bytes), one K5 launch in backward, and the gradients of
    K5 called directly. `neighborhood_attention_2d` (q, k and v apart)
    under autograd raises and names the qkv entry."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import (
        neighborhood_attention_2d,
        neighborhood_attention_2d_backward_cuda,
        neighborhood_attention_2d_cuda,
        neighborhood_attention_2d_qkv,
    )

    qkv, rpb, grad_out = _k5_case(4, 2, 24, 40, 6, 7, cuda)
    with torch.no_grad():
        served = neighborhood_attention_2d_qkv(qkv, rpb, 7, 3, 0.2)
    out, lse = _k4_forward(qkv, rpb, 7, 3, 0.2)
    assert torch.equal(out, served)
    direct = neighborhood_attention_2d_backward_cuda(qkv, rpb, out, lse, grad_out, 7, 3, 0.2)
    k4, k5 = neighborhood_attention_2d_cuda.launches, neighborhood_attention_2d_backward_cuda.launches
    leaf, bias = qkv.clone().requires_grad_(True), rpb.clone().requires_grad_(True)
    out = neighborhood_attention_2d_qkv(leaf, bias, 7, 3, 0.2)
    assert torch.equal(out, served) and out.grad_fn is not None
    out.backward(grad_out)
    assert (neighborhood_attention_2d_cuda.launches, neighborhood_attention_2d_backward_cuda.launches) == (k4 + 1,
                                                                                                          k5 + 1)
    assert torch.equal(leaf.grad, direct[0]) and torch.equal(bias.grad, direct[1])
    q, k, v = (qkv[:, :, :, i].clone().requires_grad_(True) for i in range(3))
    with pytest.raises(RuntimeError, match="neighborhood_attention_2d_qkv"):
        neighborhood_attention_2d(q, k, v, bias, 7, 3, 0.2)


def test_neighborhood_attention_backward_kernel_rejects_bad_inputs(cuda):
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_backward_cuda

    qkv, rpb, grad_out = _k5_case(0, 1, 8, 8, 2, 3, cuda)
    out = torch.zeros_like(grad_out)
    lse = torch.zeros(grad_out.shape[:4], device=cuda)
    bad = (
        (qkv.bfloat16(), rpb.bfloat16(), out.bfloat16(), lse, grad_out.bfloat16()),  # fp32 only
        (qkv.transpose(1, 2), rpb, out, lse, grad_out),  # not contiguous
        (qkv[..., :16].contiguous(), rpb, out[..., :16].contiguous(), lse, grad_out[..., :16].contiguous()),  # dh
        (qkv, rpb[:, :3], out, lse, grad_out),  # rpb shape
        (qkv, rpb, out[:, :4], lse, grad_out),  # out shape
        (qkv, rpb, out, lse[:, :4], grad_out),  # lse shape
        (qkv, rpb.cpu(), out, lse, grad_out),  # device
    )
    for args in bad:
        with pytest.raises(ValueError):
            neighborhood_attention_2d_backward_cuda(*args, 3, 1)


def test_dinat_model_matches_cpu(cuda):
    """The scaled DiNAT UniEncoder in fp32 on the card (K4, TF32 off)
    against the CPU path (the plain version), from one seed's weights:
    forward_segmentation at 128x256 at atol 5e-3, rtol 1e-3 and
    forward_sequence on a 64x128 pair at atol 1e-4, rtol 1e-3 (cuBLAS and
    cuDNN sum in other orders than the CPU). K4 runs once per NAT layer."""
    import _torch_port_common as common
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder
    from uni_encoder_tpu_torch.ops.neighborhood_attention import neighborhood_attention_2d_cuda

    rng = np.random.RandomState(5)
    img = torch.from_numpy(rng.randn(1, 128, 256, 3).astype(np.float32))
    tokens = torch.ones((1, 77), dtype=torch.int64)
    pair = [torch.from_numpy(rng.randn(1, 64, 128, 3).astype(np.float32)) for _ in range(2)]
    outs = {}
    n0 = neighborhood_attention_2d_cuda.launches
    for dev in (cuda, torch.device("cpu")):
        model = UniEncoder(common.make_cfg(TC, "dinat"), device=dev, seed=0)
        with torch.inference_mode():
            outs[dev.type] = (model.forward_segmentation(img.to(dev), tokens.to(dev)),
                              model.forward_sequence(*(x.to(dev) for x in pair)))
    assert neighborhood_attention_2d_cuda.launches == n0 + 2 * sum(common.DINAT_DEPTHS)
    for k in ("pred_logits", "pred_masks"):
        torch.testing.assert_close(outs["cuda"][0][k].cpu(), outs["cpu"][0][k], atol=5e-3, rtol=1e-3, msg=k)
    for k in ("disp", "motion_mask", "complete_flow", "axisangle", "translation", "cam_T_cam"):
        torch.testing.assert_close(outs["cuda"][1][k].cpu(), outs["cpu"][1][k], atol=1e-4, rtol=1e-3, msg=k)
