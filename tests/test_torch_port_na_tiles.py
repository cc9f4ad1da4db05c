"""K4's tile arithmetic, on the CPU. The kernel works on tiles of one residue
class's sub-grid: the keys of a tile's windows form one halo rectangle, each
key stored once and weighted by how often a clamped window lists it.
`ops/neighborhood_attention.py::_tile_halo` mirrors that integer arithmetic;
here it is held against `_axis_indices` (the JAX package's window, held
against the JAX op in tests/test_torch_port_backbones.py): every window lies
in its tile's halo and the halo holds nothing else, each key's count is how
often the window lists it, and the masked dense softmax over each tile's
halo, weighted by those counts and computed in float64 from fp32 inputs,
equals the plain version (fp32) within atol 1e-6 + rtol 2e-6: the plain
version adds its k * k window terms one after another in fp32, so where a
window repeats one key up to 42 times its own rounding reaches 4.6e-6 on an
output of 3.3 (the dense fp32 sum stays within 1.4e-6 of float64 there).
"""

import os

import numpy as np
import pytest
import torch

from uni_encoder_tpu_torch.ops.neighborhood_attention import (
    KERNEL_TILE,
    _axis_indices,
    _tile_halo,
    _window_start,
    neighborhood_attention_2d_plain,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(size, dilation):
    """(residue, tile) of every tile that holds a query, as K4's grid has them."""
    for m in range(min(dilation, size)):
        sub_len = (size - m + dilation - 1) // dilation
        for tile in range((sub_len + KERNEL_TILE - 1) // KERNEL_TILE):
            yield m, tile


def _check_axis(size, kernel, dilation):
    """Every tile's halo against `_axis_indices` along one axis."""
    idx = _axis_indices(size, kernel, dilation)[0]
    covered = 0
    for m, tile in _tiles(size, dilation):
        sub_len = (size - m + dilation - 1) // dilation
        q0, h0, counts = _tile_halo(size, kernel, dilation, m, tile)
        queries = range(q0, min(q0 + KERNEL_TILE, sub_len))
        seen = np.zeros(len(counts), bool)
        for qs in queries:
            window = idx[qs * dilation + m]
            assert ((window - m) % dilation == 0).all()
            sub = (window - m) // dilation
            assert sub.min() >= h0 and sub.max() < h0 + len(counts), (size, kernel, dilation, m, tile, qs)
            keys, times = np.unique(sub, return_counts=True)
            np.testing.assert_array_equal(times, counts[keys - h0])
            assert keys[0] == _window_start(qs, sub_len, kernel)
            seen[keys - h0] = True
        assert seen.all(), "the halo holds a key no window of the tile lists"
        covered += len(queries)
    assert covered == size  # every query is in exactly one tile


@pytest.mark.parametrize("kernel", [3, 5, 7])
def test_tile_halo_matches_axis_indices(kernel):
    """Sizes 1 to 64 at dilations 1 to 20: short sub-grids (repeated keys),
    sub-grids of one key, tiles with ragged edges."""
    for size in range(1, 65):
        for dilation in range(1, 21):
            _check_axis(size, kernel, dilation)


def test_tile_halo_at_dinat_l_shapes():
    """Every NAT layer's axes in a DiNAT-L backbone pass over a 1024x2048
    frame and a 192x512 pair (configs/cityscapes_dinat.yaml), and the eval
    resize's 96x192 stage 0 at dilation 20."""
    from uni_encoder_tpu_torch.config import load_config

    c = load_config(os.path.join(REPO, "configs/cityscapes_dinat.yaml")).model.backbone.dinat
    axes = {(96, 20), (192, 20)}
    for H, W in ((1024, 2048), (192, 512)):
        for i, dilations in enumerate(c.dilations):
            for d in dilations:
                axes |= {(H // 4 >> i, d), (W // 4 >> i, d)}
    assert len(axes) > 20
    for size, d in sorted(axes):
        _check_axis(size, c.kernel_size, d)


def _dense_tile_attention(q, k, v, rpb, kernel, dilation, scale):
    """K4's algorithm in PyTorch, in the inputs' dtype: per tile, the logits of its queries
    against every key of its halo, masked to each query's window, biased,
    softmax weighted by each key's count, then the values."""
    B, H, W, nh, dh = q.shape
    q = q * scale
    out = torch.full_like(q, float("nan"))
    for mh, th in _tiles(H, dilation):
        qh0, h0, ch = _tile_halo(H, kernel, dilation, mh, th)
        sub_h = (H - mh + dilation - 1) // dilation
        for mw, tw in _tiles(W, dilation):
            qw0, w0, cw = _tile_halo(W, kernel, dilation, mw, tw)
            sub_w = (W - mw + dilation - 1) // dilation
            qsh = np.arange(qh0, min(qh0 + KERNEL_TILE, sub_h))
            qsw = np.arange(qw0, min(qw0 + KERNEL_TILE, sub_w))
            ksh, ksw = np.arange(h0, h0 + len(ch)), np.arange(w0, w0 + len(cw))
            rows, cols = torch.from_numpy(qsh * dilation + mh), torch.from_numpy(qsw * dilation + mw)
            krows, kcols = torch.from_numpy(ksh * dilation + mh), torch.from_numpy(ksw * dilation + mw)
            Q = q[:, rows][:, :, cols]
            K, V = (x[:, krows][:, :, kcols] for x in (k, v))
            logits = torch.einsum("bijnd,bklnd->bijnkl", Q, K)

            def axis(qs, ks, sub_len):
                start = np.array([_window_start(s, sub_len, kernel) for s in qs])[:, None]
                inside = (ks[None] >= start) & (ks[None] < start + min(kernel, sub_len))
                return torch.from_numpy(inside), torch.from_numpy(np.clip(ks[None] - qs[:, None] + kernel - 1, 0,
                                                                          2 * kernel - 2))

            in_h, rel_h = axis(qsh, ksh, sub_h)
            in_w, rel_w = axis(qsw, ksw, sub_w)
            bias = rpb[:, rel_h[:, None, :, None], rel_w[None, :, None, :]]  # (nh, i, j, k, l)
            logits = logits + bias.permute(1, 2, 0, 3, 4)[None]
            valid = (in_h[:, None, :, None] & in_w[None, :, None, :])[None, :, :, None]
            logits = logits.masked_fill(~valid, float("-inf"))
            weight = torch.from_numpy(ch[:, None] * cw[None, :]).to(q.dtype)
            mx = logits.amax(dim=(-2, -1), keepdim=True)
            p = weight * torch.exp(logits - mx)
            o = torch.einsum("bijnkl,bklnd->bijnd", p, V) / p.sum(dim=(-2, -1))[..., None]
            out[:, rows[:, None], cols[None, :]] = o
    return out


@pytest.mark.parametrize("H,W,kernel,dilation", [
    (13, 21, 7, 1),   # ragged tiles on both axes
    (13, 21, 7, 2),
    (5, 11, 3, 3),    # sub-grids of 1 and 2 keys: repeats
    (9, 30, 5, 4),
    (6, 16, 7, 2),    # the pair's stage 3: 3x8 sub-grids, repeats on both axes
    (5, 11, 7, 12),   # a map shorter than the dilation on both axes: sub_len 1
    (4, 7, 7, 5),     # sub_len 1 on one axis, 1 or 2 on the other
    (20, 11, 7, 12),  # sub_len 1 or 2 on one axis, 1 on the other
    (24, 40, 7, 5),   # the pair's stage 1 at dilation 5, narrowed
])
def test_dense_tile_softmax_matches_plain(H, W, kernel, dilation):
    rng = np.random.RandomState(H * W + kernel + dilation)
    B, nh, dh = 2, 2, 8
    q, k, v = (torch.from_numpy(rng.randn(B, H, W, nh, dh).astype(np.float32)) for _ in range(3))
    rpb = torch.from_numpy(rng.randn(nh, 2 * kernel - 1, 2 * kernel - 1).astype(np.float32))
    got = _dense_tile_attention(*(x.double() for x in (q, k, v, rpb)), kernel, dilation, dh ** -0.5)
    ref = neighborhood_attention_2d_plain(q, k, v, rpb, kernel, dilation, scale=dh ** -0.5)
    assert not got.isnan().any()  # every query was in a tile
    torch.testing.assert_close(got, ref.double(), atol=1e-6, rtol=2e-6)
