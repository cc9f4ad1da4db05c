"""The port's reproducible training step, on the CPU: the ops rewritten so
that their CUDA backward is deterministic (grid_sample as four corner
gathers, the SSIM reflect pad from slices, the InfoNCE term without
NLLLoss) against the JAX functions, forward and gradients; the Trainer's
deterministic mode and the flags it restores; two deterministic steps that
give the same bytes; and the fixed-point rule of the deformable-sampling
backward kernel's exact grad_value sum.

Inputs are made with numpy from seeds. Tolerances are stated per test.
"""

import math
from fractions import Fraction

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common
from _torch_port_common import t


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _flags():
    cudnn = torch.backends.cudnn
    return cudnn.benchmark, cudnn.deterministic, torch.are_deterministic_algorithms_enabled()


# ------------------------------------------------- ops rewritten for determinism
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_gathers_match_jax(padding_mode, align_corners):
    """The four-corner-gather grid_sample against the JAX grid_sample on the
    two call sites' shapes: a point sample ((M, 1, P) grid, one channel, as
    the criterion and matcher call it) and a dense warp (as the monodepth
    loss calls it), with source coordinates on integers, a fifth far outside
    the map and the rest inside. Output and the gradients with respect to
    the input and the grid, atol/rtol 1e-5."""
    from uni_encoder_tpu.ops import grid_sample as jgrid
    from uni_encoder_tpu_torch.ops import grid_sample

    rng = np.random.RandomState(11)
    for x_shape, g_shape in (((6, 9, 13, 1), (6, 1, 40, 2)), ((2, 8, 10, 3), (2, 8, 10, 2))):
        x = rng.randn(*x_shape).astype(np.float32)
        grid = rng.uniform(-1.0, 1.0, size=g_shape).astype(np.float32)
        far = rng.rand(*g_shape) < 0.2
        grid[far] *= 3.0
        # a few source coordinates exactly on integers (inside the map)
        H, W = x_shape[1:3]
        grid[:, :, :3, 0] = (2.0 * np.arange(1, 4) + 1.0) / W - 1.0 if not align_corners else \
            2.0 * np.arange(1, 4) / (W - 1) - 1.0
        cot = rng.randn(*g_shape[:3], x_shape[3]).astype(np.float32)

        def f(x, g):
            return jgrid(x, g, align_corners=align_corners, padding_mode=padding_mode)

        ref, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(grid))
        dx_ref, dg_ref = vjp(jnp.asarray(cot))
        tx, tg = t(x).requires_grad_(True), t(grid).requires_grad_(True)
        out = grid_sample(tx, tg, align_corners=align_corners, padding_mode=padding_mode)
        out.backward(t(cot))
        assert out.shape == ref.shape and out.dtype == torch.float32
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(tx.grad), np.asarray(dx_ref), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(tg.grad), np.asarray(dg_ref), atol=1e-5, rtol=1e-5)


def test_reflect_pad_matches_jax():
    """The slice-and-cat one-pixel reflect pad against jnp.pad(mode="reflect")
    on the two spatial axes of an NHWC tensor: values and the input gradient
    exactly (copies and sums of at most four terms, in the same order)."""
    from uni_encoder_tpu_torch.geometry import reflect_pad1

    rng = np.random.RandomState(12)
    z = rng.randn(2, 5, 7, 3).astype(np.float32)
    cot = rng.randn(2, 7, 9, 3).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jnp.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect"), jnp.asarray(z))
    tz = t(z).requires_grad_(True)
    out = reflect_pad1(tz)
    out.backward(t(cot))
    np.testing.assert_array_equal(_np(out), np.asarray(ref))
    np.testing.assert_allclose(_np(tz.grad), np.asarray(vjp(jnp.asarray(cot))[0]), atol=1e-6, rtol=1e-6)


def test_ssim_matches_jax_with_gradients():
    """SSIM over the reflect-padded 3x3 means against the JAX ssim: the loss
    map and the gradients with respect to both images, atol 1e-6, rtol
    1e-5 (fp32 sums of nine terms in another order)."""
    from uni_encoder_tpu import geometry as JG
    from uni_encoder_tpu_torch import geometry as TG

    rng = np.random.RandomState(13)
    x, y = (rng.rand(2, 9, 12, 3).astype(np.float32) for _ in range(2))
    cot = rng.randn(2, 9, 12, 3).astype(np.float32)
    ref, vjp = jax.vjp(JG.ssim, jnp.asarray(x), jnp.asarray(y))
    dx_ref, dy_ref = vjp(jnp.asarray(cot))
    tx, ty = t(x).requires_grad_(True), t(y).requires_grad_(True)
    out = TG.ssim(tx, ty)
    out.backward(t(cot))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(dx_ref), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_np(ty.grad), np.asarray(dy_ref), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("learned_scale", [False, True])
def test_contrastive_loss_matches_jax(learned_scale):
    """The bidirectional InfoNCE term (the diagonal of two log-softmaxes)
    against the JAX criterion's, with the fixed temperature and with a
    learned logit scale: the loss and the gradients with respect to the
    query and text features (and the scale), atol/rtol 1e-5."""
    from uni_encoder_tpu.training.criterion import SetCriterion as JCriterion
    from uni_encoder_tpu_torch.training.criterion import SetCriterion

    rng = np.random.RandomState(14)
    q = rng.randn(3, 5, 8).astype(np.float32)
    txt = rng.randn(3, 5, 8).astype(np.float32)
    scale = np.float32(np.log(1 / 0.07))
    jc, pc = JCriterion(num_classes=7), SetCriterion(num_classes=7)

    def jf(q, txt, s):
        return jc.contrastive_loss(q, txt, s if learned_scale else None)

    ref, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(txt), jnp.asarray(scale))
    dq_ref, dt_ref, ds_ref = vjp(jnp.ones_like(ref))
    tq, tt, ts = (t(np.asarray(a)).requires_grad_(True) for a in (q, txt, scale))
    out = pc.contrastive_loss(tq, tt, ts if learned_scale else None)
    out.backward()
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tq.grad), np.asarray(dq_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tt.grad), np.asarray(dt_ref), atol=1e-5, rtol=1e-5)
    if learned_scale:
        np.testing.assert_allclose(_np(ts.grad), np.asarray(ds_ref), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ the Trainer's mode
@pytest.mark.parametrize("step_raises", [False, True])
def test_deterministic_trainer_restores_flags(step_raises):
    """Trainer(deterministic=True) takes its step with cuDNN's benchmark off,
    cudnn.deterministic on and torch.use_deterministic_algorithms(True), and
    puts all three back as they were after the step, also when the step
    raises."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.training.train_step import Trainer

    trainer = Trainer(common.micro_config(TC), device="cpu", deterministic=True)
    state = trainer.init(seed=0)
    seg, seq = (common.tree_map(t, b) for b in common.micro_batches())
    during = []
    losses = trainer.losses

    def spy(*args):
        during.append(_flags())
        if step_raises:
            raise RuntimeError("step failed")
        return losses(*args)

    trainer.losses = spy
    before = (True, False, False)
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = before[:2]
    torch.use_deterministic_algorithms(False)
    try:
        if step_raises:
            with pytest.raises(RuntimeError, match="step failed"):
                trainer.train_step(state, seg, seq, torch.Generator().manual_seed(0))
        else:
            trainer.train_step(state, seg, seq, torch.Generator().manual_seed(0))
        assert during == [(False, True, True)]
        assert _flags() == before
    finally:
        torch.backends.cudnn.benchmark = torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)


def test_cublas_workspace_config_check(monkeypatch):
    """On CUDA a deterministic step needs CUBLAS_WORKSPACE_CONFIG set to one
    of cuBLAS's deterministic values; the check raises a clear error
    otherwise."""
    from uni_encoder_tpu_torch.training.train_step import check_cublas_workspace_config

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG=:4096:8"):
        check_cublas_workspace_config()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    with pytest.raises(RuntimeError, match="':0:0'"):
        check_cublas_workspace_config()
    for value in (":4096:8", ":16:8"):
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", value)
        check_cublas_workspace_config()


def test_deterministic_steps_are_byte_identical():
    """Two deterministic steps at the micro config, each from a fresh init
    with the same seed, batch and draws, give the same bytes in every loss,
    every gradient and every updated parameter."""
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.training.train_step import Trainer

    seg, seq = (common.tree_map(t, b) for b in common.micro_batches())
    runs = []
    for _ in range(2):
        trainer = Trainer(common.micro_config(TC), device="cpu", deterministic=True)
        state = trainer.init(seed=0)
        metrics = trainer.train_step(state, seg, seq, torch.Generator().manual_seed(3))[1]
        params = dict(state.model.named_parameters())
        runs.append(({k: _np(v).tobytes() for k, v in metrics.items()},
                     {k: _np(p.grad).tobytes() for k, p in params.items() if p.grad is not None},
                     {k: _np(p).tobytes() for k, p in params.items()}))
    assert runs[0][1] and runs[0][2]
    for a, b in zip(*runs):
        assert a.keys() == b.keys()
        assert [k for k in a if a[k] != b[k]] == []


# ------------------------------------------- the backward kernel's fixed point
def _floor_log2_from_bits(x: np.float32) -> int:
    """The kernel's floor(log2 x) from the bit pattern of a finite x > 0."""
    bits = int(np.asarray(x, np.float32).view(np.uint32)) & 0x7FFFFFFF
    biased = bits >> 23
    return biased - 127 if biased > 0 else bits.bit_length() - 1 - 149


@pytest.mark.parametrize("Lq", [1, 2, 3, 100, 10752, 43008, 2**20 - 1, 2**20])
def test_fixed_point_scale_bounds_the_sum(Lq):
    """For max|g| across the fp32 range (subnormals included), the worst sum
    of a value row, Lq * max|g| (at most one corner of each sample, weights
    of a query's samples summing to 1), stays below 2**62 units of 2**-e,
    and above 2**60: the unit is as fine as the bound allows. The kernel's
    exponent from the float's bits equals the rule's."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import FIXED_POINT_BITS, fixed_point_exponent, fixed_point_shift

    rng = np.random.RandomState(15)
    maxes = [np.float32(v) for v in (1.0, 0.75, 3.4e38, 1.2e-38, 1e-45, 7e-42, 65504.0)]
    maxes += [np.float32(v) for v in 10.0 ** rng.uniform(-44, 38, size=40)]
    for m in maxes:
        assert m > 0
        e = fixed_point_exponent(float(m), Lq)
        assert e == fixed_point_shift(Lq) - _floor_log2_from_bits(m)
        worst = Fraction(float(m)) * Lq * Fraction(2) ** e
        assert worst < 2**FIXED_POINT_BITS, (m, Lq, e)
        assert worst >= 2 ** (FIXED_POINT_BITS - 2), (m, Lq, e)
    for bad in (0.0, math.inf, math.nan):
        with pytest.raises(ValueError):
            fixed_point_exponent(bad, Lq)


def test_fixed_point_sum_matches_fp64():
    """A plain int64 emulation of the kernel's exact sum (each fp32
    contribution a * w_c * g scaled by 2**e, rounded to nearest even,
    summed with index_add_ on int64, scaled back) equals an fp64 sum of the
    same contributions within the stated resolution: half a unit 2**-e per
    contribution of the row; the same contributions in another order give
    the same bytes; and the worst row, every sample of every query on one
    token at max|g|, does not overflow."""
    from uni_encoder_tpu_torch.ops.ms_deform_attn import fixed_point_exponent

    rng = np.random.RandomState(16)
    Lq, S, LP, C = 4096, 300, 12, 4
    a = torch.softmax(torch.from_numpy(rng.randn(Lq, LP).astype(np.float32) * 2), dim=1)
    w = torch.from_numpy(rng.dirichlet(np.ones(4), size=(Lq, LP)).astype(np.float32))  # corner weights
    g = torch.from_numpy(rng.randn(Lq, C).astype(np.float32) * 3)
    tok = torch.from_numpy(rng.randint(0, S, size=(Lq, LP, 4)))
    contrib = ((a[:, :, None] * w)[..., None] * g[:, None, None, :]).reshape(-1, C)  # fp32 products
    index = tok.reshape(-1)
    e = fixed_point_exponent(float(g.abs().max()), Lq)

    def exact(order):
        units = torch.round(contrib[order].double() * 2.0**e).long()
        acc = torch.zeros((S, C), dtype=torch.int64).index_add_(0, index[order], units)
        return (acc.double() * 2.0**-e).float()

    got = exact(torch.arange(len(index)))
    again = exact(torch.from_numpy(rng.permutation(len(index))))
    assert got.numpy().tobytes() == again.numpy().tobytes()
    ref = torch.zeros((S, C), dtype=torch.float64).index_add_(0, index, contrib.double())
    count = torch.bincount(index, minlength=S).double()[:, None]
    fp32_rounding = ref.abs() * 2.0**-24
    assert ((got.double() - ref).abs() <= count * 0.5 * 2.0**-e + fp32_rounding).all()
    # the worst row: Lq queries, each putting its whole weight on one token
    worst = torch.round(torch.full((Lq,), float(g.abs().max()), dtype=torch.float64) * 2.0**e).long()
    total = torch.zeros(1, dtype=torch.int64).index_add_(0, torch.zeros(Lq, dtype=torch.int64), worst)
    assert 0 < int(total) < 2**62
