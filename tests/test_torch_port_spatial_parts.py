"""The helpers of the port's spatial partitioning
(`uni_encoder_tpu_torch/parallel/spatial.py`, `parallel/mesh.py::fetch_rows`)
on 3 gloo ranks, each against its one-process module on the whole input
cut to the rank's rows. The rows are planned for a 128-row image: blocks of
32 rows, 2, 1 and 1 of them (uneven), so at stride 32 every rank holds 1 or
2 rows and one 7-row window spans all three ranks; the inputs are made with
numpy from a seed (tests/_torch_port_spatial_ranks.py::parts_inputs), the
weights from seeds, the same on every rank.

- `fetch_rows`: windows over several ranks, rows past both edges (zeros) and
  a wrapped list of rows, exactly;
- GroupNorm with the whole map's statistics (a mean of 5 against a spread
  of 2), the 3x3 convolution with its 1-row halo and zero padding at the
  map's edges only, the x2 bilinear upsample with one row from each
  neighbour, and the downsample of the stride-4 map to strides 8, 16 and 32
  from the rank's own rows alone (`resize_hw_rows` raises for a row it does
  not hold);
- the Swin block, unshifted and shifted, at stride 4 (32 rows, 20 columns:
  3 padding rows at the bottom, 1 padding column) and at stride 32 (4 rows
  in one window); the shifted block's top rows wrap into the bottom window;
- the query decoder's attention mask, with a query masked on every key
  (un-masked on every rank) and one masked on every key of rank 0 only
  (left masked there);
- the row-split masked attention, with a query whose allowed keys are all
  on one rank (fully masked on the other two: they add zero, not NaN), one
  whose keys are all on another, and one masked everywhere and un-masked;
- one deformable encoder layer (K2's plain version on the CPU) on each
  rank's scattered queries against the layer on all tokens;
- `gather_rows`, exactly;
- the general halo convolution `conv_rows` (ResNet's 7x7 stride-2 stem,
  a 3x3 stride-2 convolution, ConvNeXt's depthwise 7x7) and ResNet's
  -inf-padded 3x3 stride-2 max-pool (`max_pool_rows`, exactly);
- the plain neighbourhood attention with a row window (the rank's query
  rows, the key rows their windows reach) against the whole map's plain
  version cut to the rank's rows, exactly: dilation 1, dilation 3 (a
  clamped window reaches another rank's rows) and dilation 8 (sub-grids of
  4 rows, shorter than the kernel of 7);
- `RowPlan`: ranks past the blocks hold no row, a short last block.
"""

import numpy as np
import pytest
import torch

import _torch_port_dist_common as dist_common
import _torch_port_spatial_ranks as ranks

WORLD = 3
EXACT = ("fetch_rows", "attention_mask", "upsample_x2", "downsample_stride8", "downsample_stride16", "downsample_stride32",
         "gather_rows", "max_pool3x3_stride2", "na_row_window_dilation1", "na_row_window_dilation3",
         "na_row_window_dilation8")
# the same function as the one-process module in another order of fp32 sums
ATOL = RTOL = 1e-5
CLOSE = ("group_norm", "conv3x3", "swin4_shift0", "swin4_shift3", "swin32_shift0", "swin32_shift3",
         "masked_attention", "encoder_layer", "conv7x7_stride2", "conv3x3_stride2", "depthwise7x7")


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return dist_common.run_ranks(ranks.parts_rank, WORLD, tmp_path_factory.mktemp("spatial_parts"),
                                     ranks.parts_inputs())
    finally:
        torch.set_num_threads(n)


def test_rows_are_uneven_blocks_of_32(parts):
    assert [p["rows4"] for p in parts] == [(0, 16), (16, 24), (24, 32)]
    assert [p["rows32"] for p in parts] == [(0, 2), (2, 3), (3, 4)]


@pytest.mark.parametrize("name", EXACT)
def test_exact_on_every_rank(parts, name):
    for r, p in enumerate(parts):
        got, ref = p[name]
        assert got.shape == ref.shape, (r, got.shape, ref.shape)
        assert torch.equal(got, ref), (r, (got - ref).abs().max().item())


@pytest.mark.parametrize("name", CLOSE)
def test_matches_one_process_module(parts, name):
    for r, p in enumerate(parts):
        got, ref = p[name]
        assert got.shape == ref.shape, (r, got.shape, ref.shape)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL, msg=lambda m: f"rank {r}: {m}")


def test_masked_attention_rows_masked_on_some_ranks_only(parts):
    """Query 1's allowed keys are all on rank 1, query 2's all on rank 0:
    the other ranks hold none of theirs, and every rank's output is the
    one-process module's, the same bytes on every rank."""
    allows = np.stack([p["masked_attention_rank_allows"].numpy() for p in parts])  # (rank, B, 1, Q)
    assert (allows[[0, 2], :, :, 1] == 0).all() and (allows[1, :, :, 1] > 0).all()
    assert (allows[[1, 2], :, :, 2] == 0).all() and (allows[0, :, :, 2] > 0).all()
    outs = [p["masked_attention"][0] for p in parts]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_encoder_queries_are_scattered(parts):
    """Each rank's queries are its rows of every level: three runs, not one
    contiguous range of the level-major tokens, and the ranks' together are
    every token once."""
    idx = [p["encoder_queries"].numpy() for p in parts]
    assert all((np.diff(i) > 1).sum() == 2 for i in idx)
    assert np.array_equal(np.sort(np.concatenate(idx)), np.arange(4 * 2 + 8 * 4 + 16 * 8))


def test_row_windows_reach_other_ranks(parts):
    """The key rows of each rank's row window: at dilation 3 and 8 every
    rank reaches past its own rows; at dilation 8 every window is a whole
    sub-grid, so each rank reaches all 32 rows but its last residues'."""
    own = [p["rows4"] for p in parts]
    for d in (3, 8):
        reach = [p[f"na_reach_dilation{d}"] for p in parts]
        assert all(k0 < lo or k1 > hi for (k0, k1), (lo, hi) in zip(reach, own)), (d, reach)
    assert [p["na_reach_dilation8"] for p in parts] == [(0, 32)] * 3


def test_position_embedding_rows_are_the_whole_maps():
    from uni_encoder_tpu_torch.ops import position_embedding_sine

    whole = position_embedding_sine(23, 9, 16)
    for a, b in ((0, 7), (7, 8), (8, 23)):
        assert torch.equal(position_embedding_sine(23, 9, 16, rows=(a, b)), whole[a:b])


def test_row_plan_refuses_fewer_blocks_than_ranks(monkeypatch):
    """It refuses neither: with fewer blocks of 32 rows than ranks the last
    ranks hold none, and a height that is not a multiple of 32 (the JAX
    forward takes 80 rows) makes the last block short (the group's size and
    this rank read from a stand-in for the group)."""
    from uni_encoder_tpu_torch.parallel import mesh
    from uni_encoder_tpu_torch.parallel.spatial import RowPlan

    monkeypatch.setattr(mesh, "rank", lambda: 1)
    monkeypatch.setattr(mesh, "world", lambda: 2)
    assert RowPlan(96).bounds(4) == [(0, 16), (16, 24)] and RowPlan(96).rows(32) == (2, 3)
    assert RowPlan(80).bounds(4) == [(0, 16), (16, 20)] and RowPlan(80).bounds(32) == [(0, 2), (2, 3)]
    monkeypatch.setattr(mesh, "world", lambda: 3)
    monkeypatch.setattr(mesh, "rank", lambda: 2)
    plan = RowPlan(64)
    assert plan.bounds(4) == [(0, 8), (8, 16), (16, 16)] and plan.rows(32) == (2, 2)
    with pytest.raises(ValueError, match="needs rows"):
        RowPlan(0)
