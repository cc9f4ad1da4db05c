"""The port's spatial partitioning (`uni_encoder_tpu_torch/parallel/
spatial.py::spatial_inference`: one image's rows split over gloo ranks)
against the JAX `spatial_inference` and against the port's one-process
forward, on tests/test_model_forward.py's scaled Swin-T model (Swin-T ->
MSDeformAttnPixelDecoder -> OneFormerQueryDecoder at narrow widths).

Random JAX variables are made with numpy from a seed on the shapes of
`jax.eval_shape(model.init)` (no compile) and carried to the port by
`engine/convert.py::state_dict_from_jax`; the images and task tokens are
made with numpy from a seed. The JAX function runs on a `make_mesh(N)` of
the conftest's virtual CPU devices, jitted twice in all: N=2 at 64x128
(one row a rank at stride 32: every Swin window there, and the halos, span
both ranks) and N=4 at 128x128. The port runs on 2 ranks (64x128, and
96x128: 3 blocks of 32 rows, 2 and 1), on 3 (64x128: 2 blocks, so rank 2
holds no row; 80x128, which the JAX forward takes: the last block 16 rows)
and on 4 (128x128), one thread a rank
(tests/_torch_port_dist_common.py::run_ranks).

- pred_logits (the same bytes on every rank) and the masks gathered from
  the ranks' rows within the JAX test's atol and rtol of 2e-4
  (tests/test_spatial_sharding.py);
- against the port's one-process forward on the same weights within
  ONE_PROCESS_TOL: the same function, another order of fp32 sums;
- each rank's rows of pred_masks at its range of the stride-4 map;
- fewer blocks of 32 rows than ranks: the rank without rows returns the
  same pred_logits and no mask rows, and the ranks' result is the JAX
  function's at 64x128 (as it computes for 2 ranks: the same function on
  any mesh) and the one process's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port_dist_common as dist_common
import _torch_port_spatial_ranks as ranks
from tests.test_model_forward import _scaled_config

JAX_TOL = 2e-4  # tests/test_spatial_sharding.py: atol and rtol
ONE_PROCESS_TOL = 2e-5  # atol and rtol
SIZES = {2: [(64, 128), (96, 128)], 3: [(64, 128), (80, 128)], 4: [(128, 128)]}
JAX_SIZES = {2: (64, 128), 4: (128, 128)}


def _random_variables(shapes, seed):
    """numpy values for a flax variables tree of `shapes`: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), the rest N(0, 0.01)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = tuple(leaf.shape)
        noise = rng.randn(*shape)
        if name == "scale":
            return (1 + 0.1 * noise).astype(np.float32)
        if len(shape) >= 2 and ("kernel" in name or name == "in_proj"):
            return (noise / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        return (0.1 * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX model's and the port's outputs on the same weights and inputs."""
    from uni_encoder_tpu.models.oneformer import UniEncoder as JUniEncoder
    from uni_encoder_tpu.parallel.mesh import make_mesh
    from uni_encoder_tpu.parallel.spatial import spatial_inference
    from uni_encoder_tpu_torch import config as TC
    from uni_encoder_tpu_torch.engine.convert import state_dict_from_jax

    assert dataclasses.asdict(ranks.forward_cfg(TC)) == dataclasses.asdict(_scaled_config())
    model = JUniEncoder(_scaled_config())
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 50, (1, 77)).astype(np.int32)
    images = {hw: rng.randn(1, *hw, 3).astype(np.float32) for sizes in SIZES.values() for hw in sizes}
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 3)),
                            jnp.zeros((1, 77), jnp.int32))
    variables = _random_variables(shapes, seed=3)
    state = {k: v.numpy() for k, v in state_dict_from_jax(variables["params"]).items()}

    jax_out = {}
    for n, hw in JAX_SIZES.items():
        out = spatial_inference(model, variables, jnp.asarray(images[hw]), jnp.asarray(tokens), make_mesh(n))
        jax_out[hw] = {k: np.asarray(out[k], np.float32) for k in ("pred_logits", "pred_masks")}

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = {n: dist_common.run_ranks(ranks.forward_rank, n, tmp_path_factory.mktemp(f"spatial_{n}"), state,
                                         [images[hw] for hw in sizes], tokens.astype(np.int64))
                for n, sizes in SIZES.items()}
    finally:
        torch.set_num_threads(n_threads)
    return jax_out, port


def _port_case(port, n, hw):
    return [r[SIZES[n].index(hw)] for r in port[n]]


@pytest.mark.parametrize("n", sorted(JAX_SIZES))
def test_ranks_match_jax_spatial_inference(case, n):
    jax_out, port = case
    hw = JAX_SIZES[n]
    per_rank = _port_case(port, n, hw)
    for r, out in enumerate(per_rank):
        np.testing.assert_allclose(out["pred_logits"].numpy(), jax_out[hw]["pred_logits"], atol=JAX_TOL,
                                   rtol=JAX_TOL, err_msg=f"rank {r} of {n}")
        np.testing.assert_allclose(out["gathered_masks"].numpy(), jax_out[hw]["pred_masks"], atol=JAX_TOL,
                                   rtol=JAX_TOL, err_msg=f"rank {r} of {n}")


@pytest.mark.parametrize("n,hw", [(n, hw) for n, sizes in SIZES.items() for hw in sizes])
def test_ranks_match_one_process(case, n, hw):
    _, port = case
    per_rank = _port_case(port, n, hw)
    ref = per_rank[0]["one_process"]
    Q = ref["pred_masks"].shape[1]
    assert ref["pred_masks"].shape == (1, Q, hw[0] // 4, hw[1] // 4)
    for r, out in enumerate(per_rank):
        assert torch.equal(out["pred_logits"], per_rank[0]["pred_logits"]), f"rank {r}'s logits differ from rank 0's"
        torch.testing.assert_close(out["pred_logits"], ref["pred_logits"], atol=ONE_PROCESS_TOL,
                                   rtol=ONE_PROCESS_TOL)
        torch.testing.assert_close(out["gathered_masks"], ref["pred_masks"], atol=ONE_PROCESS_TOL,
                                   rtol=ONE_PROCESS_TOL)
        a, b = out["rows"]
        assert out["height"] == hw[0] // 4 and out["pred_masks"].shape == (1, Q, b - a, hw[1] // 4)
        assert torch.equal(out["pred_masks"], out["gathered_masks"][:, :, a:b])
    blocks = -(-hw[0] // 32)
    sizes = [blocks // n + (r < blocks % n) for r in range(n)]
    h4 = hw[0] // 4
    assert [out["rows"] for out in per_rank] == [(min(8 * sum(sizes[:r]), h4), min(8 * sum(sizes[:r + 1]), h4))
                                                 for r in range(n)]


def test_fewer_row_blocks_than_ranks_raises(case):
    """It does not raise: 64 rows are 2 blocks of 32, so in a group of 3 rank
    2 holds no row. It takes part in every exchange, returns the same
    pred_logits as the others and no mask rows, and the ranks' result is the
    JAX function's (computed on 2 devices: GSPMD's padded shards compute the
    same function) and the one process's."""
    jax_out, port = case
    hw = (64, 128)
    per_rank = _port_case(port, 3, hw)
    assert [out["rows"] for out in per_rank] == [(0, 8), (8, 16), (16, 16)]
    empty = per_rank[2]
    assert empty["pred_masks"].shape == (1, empty["pred_logits"].shape[1], 0, hw[1] // 4)
    assert torch.equal(empty["pred_logits"], per_rank[0]["pred_logits"])
    for r, out in enumerate(per_rank):
        np.testing.assert_allclose(out["pred_logits"].numpy(), jax_out[hw]["pred_logits"], atol=JAX_TOL,
                                   rtol=JAX_TOL, err_msg=f"rank {r} of 3")
        np.testing.assert_allclose(out["gathered_masks"].numpy(), jax_out[hw]["pred_masks"], atol=JAX_TOL,
                                   rtol=JAX_TOL, err_msg=f"rank {r} of 3")
