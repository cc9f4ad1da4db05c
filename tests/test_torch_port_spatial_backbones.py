"""The port's spatial partitioning (`uni_encoder_tpu_torch/parallel/
spatial.py::spatial_inference`) on the ResNet-18, ConvNeXt and DiNAT
backbones with MSDeformAttnPixelDecoder, at the scaled profile
(tests/_torch_port_common.py::make_cfg), against the JAX `spatial_inference`
and against the port's one-process forward.

Random JAX variables (and ResNet's BatchNorm statistics) are made with numpy
from a seed on the shapes of `jax.eval_shape(model.init)` and carried to the
port by `engine/convert.py::state_dict_from_jax`; images and task tokens are
made with numpy from a seed. The JAX function runs on `make_mesh(2)` of the
conftest's virtual CPU devices, one compile a backbone; the port on gloo
ranks, one thread a rank, every backbone in one group
(tests/_torch_port_spatial_ranks.py::models_rank).

- On 2 ranks at JAX_HW, pred_logits and the gathered masks within JAX_TOL
  (atol and rtol) of the JAX function's;
- on 2 and 3 ranks, with uneven blocks of 32 rows and a short last block
  (80 rows), within ONE_PROCESS_TOL of one process (atol and rtol); an
  element past it passes only where it lies within twice the one process's
  own fp32 rounding of the float64 one-process forward (plus the rule): K2
  takes its sampling locations in fp32, so a 1-ulp difference of an offset
  between two orders of sums moves a sample, and the query decoder's
  thresholded masks carry it on (at 80x64 on ResNet 1 mask element of
  2560 read 2.07e-5 of a 0.011; in float64 the ranks and the one process
  agree within 1.2e-6 at 80 rows and at 128, K2's fp32 locations and
  weights included). Each case reports how many elements took that second
  rule, at most ONE_PROCESS_OUTLIERS of them.
- DiNAT at 256x64: at stride 4 (64 rows, 2 ranks of 32) the dilation-8
  windows cross the ranks' boundary and the clamped windows of the bottom
  rows reach 48 rows up, into rank 0's rows; at 80 rows a dilation-5
  sub-grid is shorter than the kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port_common as common
import _torch_port_dist_common as dist_common
import _torch_port_spatial_ranks as ranks

# the JAX test's (tests/test_spatial_sharding.py) atol and rtol, which the
# ranks meet on every backbone (better than the one-process segmentation
# rule of test_torch_port_backbone_models.py, atol 5e-3 and rtol 1e-3)
JAX_TOL = 2e-4
ONE_PROCESS_TOL = 2e-5  # atol and rtol: the same function, another order of fp32 sums
ONE_PROCESS_OUTLIERS = 1e-3  # the share of elements that may pass by the float64 rule
BACKBONES = ("resnet", "convnext", "dinat")
JAX_HW = {"resnet": (64, 64), "convnext": (64, 64), "dinat": (256, 64)}
# per world: the images of each backbone (blocks of 32 rows a rank)
PORT_HW = {2: {"resnet": [(64, 64), (96, 64)], "convnext": [(64, 64), (96, 64)],
               "dinat": [(256, 64), (224, 64)]},
           3: {"resnet": [(128, 64), (80, 64)], "convnext": [(128, 64), (80, 64)],
               "dinat": [(256, 64), (80, 64)]}}


def random_variables(shapes, seed):
    """numpy values for a flax variables tree of `shapes`: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), BatchNorm variances
    1 + |N(0, 0.01)|, the rest N(0, 0.01)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = tuple(leaf.shape)
        noise = rng.randn(*shape)
        if name == "scale":
            return (1 + 0.1 * noise).astype(np.float32)
        if name == "var":
            return (1 + 0.1 * np.abs(noise)).astype(np.float32)
        if len(shape) >= 2 and ("kernel" in name or name == "in_proj"):
            return (noise / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        return (0.1 * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_case(jmodel, seed):
    """Random variables of `jmodel` (numpy) and the port's state dict of them."""
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 77), jnp.int32))
    variables = random_variables(dict(shapes), seed)
    state = state_dict_from_jax(variables["params"], variables.get("batch_stats"))
    return variables, {k: v.numpy() for k, v in state.items()}


def run_cases(tmp_path_factory, cases, port_hw, images, tokens, name):
    """The port's `spatial_inference` on each world's ranks:
    {world: {case: [per image, per rank outputs]}}."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for n, hws in port_hw.items():
            args = [(cfg, state, [images[hw] for hw in hws[key]]) for key, (cfg, state) in cases.items()]
            per_rank = dist_common.run_ranks(ranks.models_rank, n, tmp_path_factory.mktemp(f"{name}_{n}"), args,
                                             tokens)
            out[n] = {key: [[r[i][j] for r in per_rank] for j in range(len(hws[key]))]
                      for i, key in enumerate(cases)}
        return out
    finally:
        torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX function's outputs at JAX_HW, and the port's on every world."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as JUniEncoder
    from uni_encoder_tpu.parallel.mesh import make_mesh
    from uni_encoder_tpu.parallel.spatial import spatial_inference
    from uni_encoder_tpu_torch import config as TC

    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 50, (1, 77)).astype(np.int32)
    hws = set(JAX_HW.values()) | {hw for per in PORT_HW.values() for v in per.values() for hw in v}
    images = {hw: rng.randn(1, *hw, 3).astype(np.float32) for hw in sorted(hws)}
    jax_out, cases = {}, {}
    for i, name in enumerate(BACKBONES):
        jmodel = JUniEncoder(common.make_cfg(JC, name))
        variables, state = jax_case(jmodel, seed=10 + i)
        hw = JAX_HW[name]
        out = spatial_inference(jmodel, variables, jnp.asarray(images[hw]), jnp.asarray(tokens), make_mesh(2))
        jax_out[name] = {k: np.asarray(out[k], np.float32) for k in ("pred_logits", "pred_masks")}
        cases[name] = (common.make_cfg(TC, name), state)
    return jax_out, run_cases(tmp_path_factory, cases, PORT_HW, images, tokens.astype(np.int64), "backbones")


def within_one_process(got, ref, ref64, what):
    """`got` within ONE_PROCESS_TOL of the one process's fp32 `ref`, or,
    element by element, within twice the one process's own rounding
    |ref - ref64| (plus the rule) of its float64 forward `ref64`. Returns
    how many elements passed by the second rule."""
    bound = ONE_PROCESS_TOL + ONE_PROCESS_TOL * ref.abs()
    past = (got - ref).abs() > bound
    own = (ref.double() - ref64).abs()
    by_float64 = (got.double() - ref64).abs() <= 2 * own + bound
    assert not (past & ~by_float64).any(), (
        f"{what}: {int((past & ~by_float64).sum())} elements past {ONE_PROCESS_TOL} and farther from the float64 "
        f"forward than twice the one process's rounding; max abs err {(got - ref).abs().max().item()}")
    assert past.float().mean() <= ONE_PROCESS_OUTLIERS, f"{what}: {int(past.sum())} of {past.numel()} past"
    return int(past.sum())


def check_one_process(per_rank, hw, n):
    """Every rank's outputs against rank 0's one-process forward
    (`within_one_process`); the logits the same bytes on every rank; each
    rank's mask rows its range of the stride-4 map."""
    ref, ref64 = per_rank[0]["one_process"], per_rank[0]["one_process_float64"]
    assert ref["pred_masks"].shape[2:] == (hw[0] // 4, hw[1] // 4)
    for r, out in enumerate(per_rank):
        assert torch.equal(out["pred_logits"], per_rank[0]["pred_logits"]), f"rank {r}'s logits differ from rank 0's"
        within_one_process(out["pred_logits"], ref["pred_logits"], ref64["pred_logits"], f"rank {r} pred_logits")
        within_one_process(out["gathered_masks"], ref["pred_masks"], ref64["pred_masks"], f"rank {r} pred_masks")
        a, b = out["rows"]
        assert out["height"] == hw[0] // 4 and torch.equal(out["pred_masks"], out["gathered_masks"][:, :, a:b])
    blocks = -(-hw[0] // 32)
    sizes = [blocks // n + (r < blocks % n) for r in range(n)]
    h4 = hw[0] // 4
    assert [out["rows"] for out in per_rank] == [(min(8 * sum(sizes[:r]), h4), min(8 * sum(sizes[:r + 1]), h4))
                                                 for r in range(n)]


@pytest.mark.parametrize("name", BACKBONES)
def test_ranks_match_jax_spatial_inference(case, name):
    jax_out, port = case
    per_rank = port[2][name][PORT_HW[2][name].index(JAX_HW[name])]
    for r, out in enumerate(per_rank):
        np.testing.assert_allclose(out["pred_logits"].numpy(), jax_out[name]["pred_logits"], atol=JAX_TOL,
                                   rtol=JAX_TOL, err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(out["gathered_masks"].numpy(), jax_out[name]["pred_masks"], atol=JAX_TOL,
                                   rtol=JAX_TOL, err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name,n,hw", [(name, n, hw) for n, per in PORT_HW.items() for name in BACKBONES
                                       for hw in per[name]])
def test_ranks_match_one_process(case, name, n, hw):
    _, port = case
    check_one_process(port[n][name][PORT_HW[n][name].index(hw)], hw, n)


def test_dinat_windows_cross_the_ranks():
    """The DiNAT sizes reach across the ranks: at 256x64 on 2 ranks, stage
    0 (64 rows, stride 4: rows 0-31 and 32-63) with the scaled dilation 8,
    a query of each rank has window rows on the other, and the bottom row's
    window, clamped at the map's edge, starts 48 rows up in rank 0's rows; at
    80x64 on 3 ranks, stride 8 (10 rows), the dilation-5 sub-grids hold 2
    rows, shorter than the kernel of 7."""
    from uni_encoder_tpu_torch.ops.neighborhood_attention import _axis_indices

    kernel, d0 = 7, common.DINAT_DILATIONS[0][1]
    idx = _axis_indices(64, kernel, d0)[0]
    assert (idx[:32] >= 32).any() and (idx[32:] < 32).any()
    assert idx[63].min() == 15 and idx[63].max() == 63  # sub-grid 7 of 8: the window starts at 1, not 4
    d1 = common.DINAT_DILATIONS[1][1]
    assert max((10 - m + d1 - 1) // d1 for m in range(d1)) < kernel
