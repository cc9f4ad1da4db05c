"""The gradient of neighborhood attention, on the CPU.

(a) The plain version's autograd (the CPU's backward, and K5's plain
version) in fp32 against jax.vjp of the JAX op, whose q is pre-scaled (the
port scales q inside, so its dq carries the scale), on the same inputs and
one cotangent from a numpy seed, computed by JAX in float64: the output at
rtol 1e-5 / atol 1e-6; each gradient at rtol 1e-5 / atol 1e-6 * sqrt(n), n
the fp32 terms its element sums (fp32 rounding grows as a random walk over
them): k * k window entries for dqkv (where a window is one key repeated
49 times the exact dq is 0 and the fp32 sum leaves 1e-6), every one of the
B*H*W queries of a head for a drpb cell (JAX's own fp32 drpb misses atol
1e-6 by 5x at 128x256, where that is 32768). Kernels 3, 5 and 7, dilations 1 to 20, and the shapes whose
sub-grids are shorter than the kernel (repeated keys: the JAX gather lists a
short sub-grid's last key k - sub_len + 1 times, each with the same bias
index, and its gradients add up that often).

(b) A dense PyTorch transcription of K5's formulation, in float64 from the
same fp32 inputs, against (a)'s autograd: per query tile (`_tile_halo`)
each halo key once, weighted by its count, P from the forward's
log-sum-exp, D = dO . O of the forward's output, dS, a drpb table per tile,
then the softmax made the pass's own (P / r, D' = sum P dP / r, dq = scale /
r (sum dS k - (D' - D) sum P k)); per key tile the queries whose windows
hold each key (`_inverse_range`), the logits recomputed, P / r, dk and dv
gathered with D'. dqkv at atol 2e-6 + rtol 2e-6: the plain version sums its
49 window terms one by one in fp32, the transcription in float64; drpb at
rtol 2e-6 / atol 1e-6 * sqrt(B*H*W), as in (a). Given a log-sum-exp and an
output off by 1e-3 (K4's logits and K5's differ by a few ulps), dqkv is
still the plain version's: the correction is exact.

(c) `_inverse_range` against a brute force over `_axis_indices`.

(d) K5's 3xTF32 products, emulated in numpy: `cvt.rna.tf32` (10 mantissa
bits, ties away from zero) of x and of x - big, and small*big + big*small +
big*big summed in float64, within the bound K5's source states, 3.01 * 2^-22
of sum |x y| over 32-dim rows; one TF32 product is not. And
`neighborhood_attention_2d_lse_plain` (what K4's lse output is held to on the
card) against a float64 brute force over `_axis_indices`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uni_encoder_tpu_torch.ops.neighborhood_attention import (
    KERNEL_TILE,
    _axis_indices,
    _inverse_range,
    _tile_halo,
    _window_start,
    neighborhood_attention_2d_backward_plain,
    neighborhood_attention_2d_lse_plain,
    neighborhood_attention_2d_plain,
    neighborhood_attention_2d_qkv,
)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, B, H, W, nh, dh, kernel):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, H, W, 3, nh, dh).astype(np.float32)
    rpb = (0.5 * rng.randn(nh, 2 * kernel - 1, 2 * kernel - 1)).astype(np.float32)
    cot = rng.randn(B, H, W, nh, dh).astype(np.float32)
    return qkv, rpb, cot


# --------------------------------------------------------- (a) against JAX
@pytest.mark.parametrize("H,W,kernel,dilation", [
    (13, 21, 7, 1), (13, 21, 7, 2), (19, 27, 5, 1), (17, 9, 3, 1), (24, 40, 5, 5), (20, 30, 3, 7),
    (5, 11, 3, 3), (20, 11, 7, 12),  # one- and two-key sub-grids
    (6, 16, 7, 2), (6, 16, 7, 3), (6, 16, 7, 4),  # a DiNAT-L pair's stage 3: repeats on both axes
    (12, 32, 7, 2), (12, 32, 7, 3), (12, 32, 7, 4),  # its stage 2
    (48, 128, 7, 20),  # its stage 0 at dilation 20: sub-grids of 2 and 3 rows
    (128, 256, 7, 20),  # a training crop's stage 0 at dilation 20: 6-row sub-grids
])
def test_plain_gradients_match_jax_vjp(H, W, kernel, dilation):
    from uni_encoder_tpu.ops.neighborhood_attention import neighborhood_attention_2d as jax_na

    B, nh, dh = (1, 1, 4) if H * W > 4096 else (2, 2, 8)
    qkv, rpb, cot = _case(H * W + kernel * dilation, B, H, W, nh, dh, kernel)
    scale = dh ** -0.5

    def f(qkv, rpb):  # the JAX module: q scaled before the op
        return jax_na(qkv[:, :, :, 0] * scale, qkv[:, :, :, 1], qkv[:, :, :, 2], rpb, kernel, dilation)

    with jax.enable_x64():
        ref, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(x, jnp.float64) for x in (qkv, rpb)))
        ref, (dqkv_ref, drpb_ref) = np.asarray(ref), (np.asarray(g) for g in vjp(jnp.asarray(cot, jnp.float64)))

    tq, tr = torch.from_numpy(qkv).requires_grad_(True), torch.from_numpy(rpb).requires_grad_(True)
    out = neighborhood_attention_2d_qkv(tq, tr, kernel, dilation, scale)
    out.backward(torch.from_numpy(cot))
    assert out.dtype == tq.grad.dtype == tr.grad.dtype == torch.float32
    tol = dict(atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), ref, **tol)
    np.testing.assert_allclose(tq.grad.numpy(), dqkv_ref, atol=1e-6 * kernel, rtol=1e-5)
    np.testing.assert_allclose(tr.grad.numpy(), drpb_ref, atol=1e-6 * np.sqrt(B * H * W), rtol=1e-5)


def test_qkv_entry_matches_the_views_on_cpu():
    """On the CPU `neighborhood_attention_2d_qkv` is the plain version on
    the three views, and K5's plain version is its autograd."""
    qkv, rpb, cot = (torch.from_numpy(x) for x in _case(3, 2, 9, 14, 2, 8, 5))
    got = neighborhood_attention_2d_qkv(qkv, rpb, 5, 2, 0.3)
    ref = neighborhood_attention_2d_plain(qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], rpb, 5, 2, 0.3)
    assert torch.equal(got, ref)
    dqkv, drpb = neighborhood_attention_2d_backward_plain(qkv, rpb, cot, 5, 2, 0.3)
    assert dqkv.shape == qkv.shape and drpb.shape == rpb.shape
    tq, tr = qkv.clone().requires_grad_(True), rpb.clone().requires_grad_(True)
    neighborhood_attention_2d_qkv(tq, tr, 5, 2, 0.3).backward(cot)
    assert torch.equal(tq.grad, dqkv) and torch.equal(tr.grad, drpb)


# ------------------------------------------ (b) K5's formulation, densely
def _tiles(size, dilation):
    """(residue, tile, sub_len) of every tile that holds a query (or key)."""
    for m in range(min(dilation, size)):
        sub_len = (size - m + dilation - 1) // dilation
        for tile in range((sub_len + KERNEL_TILE - 1) // KERNEL_TILE):
            yield m, tile, sub_len


def _counts(sub_len, kernel, keys):
    """How often a window lists each of these sub-grid keys."""
    return np.where((keys == sub_len - 1) & (sub_len < kernel), kernel - sub_len + 1, 1)


def _dense_k5(qkv, rpb, dout, kernel, dilation, scale, lse, out):
    """K5's algorithm in PyTorch, in the inputs' dtype, from the forward's
    log-sum-exp `lse` (B, H, W, heads) and output `out`: (dqkv, drpb)."""
    B, H, W, _, nh, dh = qkv.shape
    q, k, v = qkv[:, :, :, 0] * scale, qkv[:, :, :, 1], qkv[:, :, :, 2]
    dqkv = torch.full_like(qkv, float("nan"))
    drpb = torch.zeros_like(rpb)
    dsum = torch.full((B, H, W, nh), float("nan"), dtype=qkv.dtype)  # D' of each query
    inv = torch.full_like(dsum, float("nan"))  # 1 / r
    rel = lambda keys, queries: torch.from_numpy(keys[None] - queries[:, None] + kernel - 1)  # noqa: E731

    # (a) query tiles: the halo, each key once with its count
    for mh, th, sub_h in _tiles(H, dilation):
        qh0, h0, ch = _tile_halo(H, kernel, dilation, mh, th)
        for mw, tw, sub_w in _tiles(W, dilation):
            qw0, w0, cw = _tile_halo(W, kernel, dilation, mw, tw)
            qsh, qsw = np.arange(qh0, min(qh0 + KERNEL_TILE, sub_h)), np.arange(qw0, min(qw0 + KERNEL_TILE, sub_w))
            ksh, ksw = np.arange(h0, h0 + len(ch)), np.arange(w0, w0 + len(cw))
            rows, cols = torch.from_numpy(qsh * dilation + mh), torch.from_numpy(qsw * dilation + mw)
            krows, kcols = torch.from_numpy(ksh * dilation + mh), torch.from_numpy(ksw * dilation + mw)
            Q, G, O = (x[:, rows][:, :, cols] for x in (q, dout, out))
            L = lse[:, rows][:, :, cols]
            K, V = (x[:, krows][:, :, kcols] for x in (k, v))

            def inside(qs, ks, sub_len):
                start = np.array([_window_start(s, sub_len, kernel) for s in qs])[:, None]
                return torch.from_numpy((ks[None] >= start) & (ks[None] < start + min(kernel, sub_len)))

            valid = (inside(qsh, ksh, sub_h)[:, None, :, None] & inside(qsw, ksw, sub_w)[None, :, None, :])
            r_h, r_w = rel(ksh, qsh), rel(ksw, qsw)
            bias = rpb[:, r_h.clamp(0, 2 * kernel - 2)[:, None, :, None], r_w.clamp(0, 2 * kernel - 2)[None, :, None, :]]
            logits = torch.einsum("bijnd,bklnd->bijnkl", Q, K) + bias.permute(1, 2, 0, 3, 4)[None]
            logits = logits.masked_fill(~valid[None, :, :, None], float("-inf"))
            count = torch.from_numpy(ch[:, None] * cw[None, :]).to(qkv.dtype)
            p = count * torch.exp(logits - L[..., None, None])  # each halo key's P, its copies counted
            d = (G * O).sum(-1)  # the forward's D = dO . O
            dp = torch.einsum("bijnd,bklnd->bijnkl", G, V)
            g = p * (dp - d[..., None, None])  # dS
            # the softmax made this pass's own: P / r, D' = sum P dP / r
            r = p.sum((-2, -1))
            d2 = (p * dp).sum((-2, -1)) / r
            dq = torch.einsum("bijnkl,bklnd->bijnd", g, K) - (d2 - d)[..., None] * torch.einsum(
                "bijnkl,bklnd->bijnd", p, K)
            dqkv[:, rows[:, None], cols[None, :], 0] = scale * dq / r[..., None]
            dsum[:, rows[:, None], cols[None, :]] = d2
            inv[:, rows[:, None], cols[None, :]] = 1 / r
            # the tile's drpb table: each query's dS at its keys' bias cells
            for i in range(len(qsh)):
                for j in range(len(qsw)):
                    ok = valid[i, j]  # (kh, kw): its window, whose bias cells are distinct
                    cells = r_h[i][:, None].expand_as(ok)[ok], r_w[j][None, :].expand_as(ok)[ok]
                    drpb[:, cells[0], cells[1]] += g[:, i, j].sum(0)[:, ok]

    # (b) key tiles: the queries whose windows hold each key
    for mh, th, sub_h in _tiles(H, dilation):
        for mw, tw, sub_w in _tiles(W, dilation):
            ksh = np.arange(th * KERNEL_TILE, min((th + 1) * KERNEL_TILE, sub_h))
            ksw = np.arange(tw * KERNEL_TILE, min((tw + 1) * KERNEL_TILE, sub_w))
            rh = [_inverse_range(sub_h, kernel, s) for s in ksh]
            rw = [_inverse_range(sub_w, kernel, s) for s in ksw]
            qsh, qsw = np.arange(rh[0][0], rh[-1][1] + 1), np.arange(rw[0][0], rw[-1][1] + 1)
            rows, cols = torch.from_numpy(ksh * dilation + mh), torch.from_numpy(ksw * dilation + mw)
            qrows, qcols = torch.from_numpy(qsh * dilation + mh), torch.from_numpy(qsw * dilation + mw)
            K, V = (x[:, rows][:, :, cols] for x in (k, v))
            Q, G = (x[:, qrows][:, :, qcols] for x in (q, dout))
            L, Dq, R = (x[:, qrows][:, :, qcols] for x in (lse, dsum, inv))
            in_h = torch.from_numpy(np.array([(qsh >= lo) & (qsh <= hi) for lo, hi in rh]))
            in_w = torch.from_numpy(np.array([(qsw >= lo) & (qsw <= hi) for lo, hi in rw]))
            valid = in_h[:, None, :, None] & in_w[None, :, None, :]  # (key i, key j, query h, query w)
            r_h, r_w = rel(ksh, qsh).T, rel(ksw, qsw).T  # key - query + k - 1, (key, query)
            bias = rpb[:, r_h.clamp(0, 2 * kernel - 2)[:, None, :, None], r_w.clamp(0, 2 * kernel - 2)[None, :, None, :]]
            logits = torch.einsum("bijnd,bklnd->bijnkl", K, Q) + bias.permute(1, 2, 0, 3, 4)[None]
            count = torch.from_numpy(_counts(sub_h, kernel, ksh)[:, None] * _counts(sub_w, kernel, ksw)[None, :])
            p = count.to(qkv.dtype)[None, :, :, None, None, None] * torch.exp(logits - L.permute(0, 3, 1, 2)[:, None, None])
            p = (p * R.permute(0, 3, 1, 2)[:, None, None]).masked_fill(~valid[None, :, :, None], 0.0)
            g = p * (torch.einsum("bijnd,bklnd->bijnkl", V, G) - Dq.permute(0, 3, 1, 2)[:, None, None])
            dqkv[:, rows[:, None], cols[None, :], 1] = torch.einsum("bijnkl,bklnd->bijnd", g, Q)
            dqkv[:, rows[:, None], cols[None, :], 2] = torch.einsum("bijnkl,bklnd->bijnd", p, G)
    return dqkv, drpb


def _forward(qkv, rpb, kernel, dilation, scale):
    """The forward's (log-sum-exp, output), plainly, as K4 hands them to K5."""
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    return (neighborhood_attention_2d_lse_plain(q, k, rpb, kernel, dilation, scale),
            neighborhood_attention_2d_plain(q, k, v, rpb, kernel, dilation, scale))


@pytest.mark.parametrize("H,W,kernel,dilation", [
    (13, 21, 7, 1),   # ragged tiles on both axes
    (13, 21, 7, 2),
    (17, 23, 5, 1),
    (20, 30, 3, 4),
    (5, 11, 3, 3),    # sub-grids of 1 and 2 keys: repeats
    (6, 16, 7, 2),    # a DiNAT-L pair's stage 3: repeats on both axes
    (12, 32, 7, 4),   # its stage 2 at dilation 4
    (48, 64, 7, 20),  # its stage 0's rows at dilation 20
    (4, 7, 7, 5),     # sub_len 1 on one axis, 1 or 2 on the other
    (24, 40, 7, 5),
])
def test_dense_k5_matches_plain_autograd(H, W, kernel, dilation):
    B, nh, dh = 2, 2, 8
    qkv, rpb, cot = (torch.from_numpy(x) for x in _case(H + 7 * W + dilation, B, H, W, nh, dh, kernel))
    scale = dh ** -0.5
    got = _dense_k5(qkv.double(), rpb.double(), cot.double(), kernel, dilation, scale,
                    *_forward(qkv.double(), rpb.double(), kernel, dilation, scale))
    ref = neighborhood_attention_2d_backward_plain(qkv, rpb, cot, kernel, dilation, scale)
    assert not got[0].isnan().any()  # every query and every key was in a tile
    torch.testing.assert_close(got[0], ref[0].double(), atol=2e-6, rtol=2e-6)
    torch.testing.assert_close(got[1], ref[1].double(), atol=1e-6 * np.sqrt(B * H * W), rtol=2e-6)


@pytest.mark.parametrize("H,W,kernel,dilation", [(13, 21, 7, 1), (20, 30, 3, 4), (6, 16, 7, 2), (5, 11, 3, 3)])
def test_dense_k5_makes_the_softmax_its_own(H, W, kernel, dilation):
    """K4's logits and K5's agree only to a few ulps, so K4's lse and
    output are slightly off for K5's P: given an lse and an output off by
    1e-3, K5's formulation (P / r, D') still gives the plain version's dqkv.
    (drpb keeps the forward's D and r, off by as much.)"""
    B, nh, dh = 2, 2, 8
    qkv, rpb, cot = (torch.from_numpy(x).double() for x in _case(H * W + kernel, B, H, W, nh, dh, kernel))
    scale = dh ** -0.5
    lse, out = _forward(qkv, rpb, kernel, dilation, scale)
    rng = np.random.RandomState(kernel * dilation)
    lse = lse + 1e-3 * torch.from_numpy(rng.randn(*lse.shape))
    out = out + 1e-3 * torch.from_numpy(rng.randn(*out.shape))
    got = _dense_k5(qkv, rpb, cot, kernel, dilation, scale, lse, out)[0]
    ref = neighborhood_attention_2d_backward_plain(qkv.float(), rpb.float(), cot.float(), kernel, dilation, scale)[0]
    torch.testing.assert_close(got, ref.double(), atol=2e-6, rtol=2e-6)


# ------------------------------------------------------- (c) inverse ranges
@pytest.mark.parametrize("kernel", [3, 5, 7])
def test_inverse_range_matches_axis_indices(kernel):
    """For sizes 1 to 64 at dilations 1 to 20, every residue class's every
    key: the queries whose windows (`_axis_indices`) list it are exactly
    `_inverse_range`'s, and each window that lists it lists it as often
    as K4 and K5 count it."""
    for size in range(1, 65):
        for dilation in range(1, 21):
            idx = _axis_indices(size, kernel, dilation)[0]
            for m in range(min(dilation, size)):
                sub_len = (size - m + dilation - 1) // dilation
                windows = (idx[m::dilation] - m) // dilation  # (sub_len, kernel) sub-grid indices
                for key in range(sub_len):
                    holds = np.flatnonzero((windows == key).any(1))
                    lo, hi = _inverse_range(sub_len, kernel, key)
                    assert holds.tolist() == list(range(lo, hi + 1)), (size, dilation, m, key)
                    times = (windows[holds] == key).sum(1)
                    assert (times == _counts(sub_len, kernel, np.array([key]))[0]).all()


# ------------------------------------------- (d) 3xTF32, and the plain lse
def _tf32_rna(x):
    """cvt.rna.tf32.f32 of finite float32 values, as K5's `tf32_rna` forms
    it: round to 10 mantissa bits, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_split_tf32_products_hold_their_bound():
    """x = big + small with big = tf32(x), small = tf32(x - big); 32-dim rows
    over 40 binades: small*big + big*small + big*big is within 3.01 * 2^-22
    of sum |x y| of the exact dot product on every row, one TF32 product
    big*big on almost none. Ties round away from zero, and x - big is exact
    in float32."""
    rng = np.random.RandomState(12)
    x, y = ((rng.randn(4096, 32) * 2.0 ** rng.randint(-20, 21, (4096, 1))).astype(np.float32) for _ in range(2))
    (xb, xs), (yb, ys) = ((b, _tf32_rna(a - b)) for a, b in ((x, _tf32_rna(x)), (y, _tf32_rna(y))))
    assert not (xb.view(np.uint32) & 0x1FFF).any() and not (xs.view(np.uint32) & 0x1FFF).any()
    assert np.array_equal(xb.astype(np.float64) + (x - xb).astype(np.float64), x.astype(np.float64))
    f = lambda a: a.astype(np.float64)  # noqa: E731
    exact, size = (f(x) * f(y)).sum(1), np.abs(f(x) * f(y)).sum(1)
    three = (f(xs) * f(yb) + f(xb) * f(ys) + f(xb) * f(yb)).sum(1)
    one = (f(xb) * f(yb)).sum(1)
    bound = 3.01 * 2.0 ** -22 * size
    assert (np.abs(three - exact) <= bound).all()
    assert (np.abs(one - exact) > bound).mean() > 0.99
    ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -23], np.float32)
    assert _tf32_rna(ties).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9, 1 + 2.0 ** -10]


@pytest.mark.parametrize("H,W,kernel,dilation", [(13, 21, 7, 1), (5, 11, 3, 3), (6, 16, 7, 2), (4, 7, 7, 5)])
def test_lse_plain_matches_a_brute_force(H, W, kernel, dilation):
    """`neighborhood_attention_2d_lse_plain`: per query, the log-sum-exp of
    q_scaled . k + rpb over its window as `_axis_indices` lists it (a short
    sub-grid's last key as often as listed), against float64; the plain
    version computes in fp32, so atol/rtol 1e-6 (a few ulps)."""
    B, nh, dh = 2, 2, 8
    qkv, rpb, _ = _case(H * W + dilation, B, H, W, nh, dh, kernel)
    qkv, rpb = qkv.astype(np.float64), rpb.astype(np.float64)
    scale = dh ** -0.5
    got = neighborhood_attention_2d_lse_plain(torch.from_numpy(qkv[:, :, :, 0]), torch.from_numpy(qkv[:, :, :, 1]),
                                              torch.from_numpy(rpb), kernel, dilation, scale).numpy()
    (ih, rh), (iw, rw) = _axis_indices(H, kernel, dilation), _axis_indices(W, kernel, dilation)
    ref = np.empty((B, H, W, nh))
    for i in range(H):
        for j in range(W):
            keys = qkv[:, ih[i]][:, :, iw[j], 1]  # (B, k, k, nh, dh)
            logits = np.einsum("bnd,bklnd->bnkl", qkv[:, i, j, 0] * scale, keys) + rpb[:, rh[i]][:, :, rw[j]][None]
            top = logits.max((-2, -1))
            ref[:, i, j] = top + np.log(np.exp(logits - top[..., None, None]).sum((-2, -1)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
