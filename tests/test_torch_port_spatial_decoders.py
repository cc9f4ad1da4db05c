"""The port's spatial partitioning (`uni_encoder_tpu_torch/parallel/
spatial.py::spatial_inference`) with the FPN-family pixel decoders the JAX
`build_pixel_decoder` selects by override, BasePixelDecoder and
TransformerEncoderPixelDecoder, on the scaled Swin-T
(tests/test_torch_port_decoder_models.py::decoder_cfg: 64 wide, for
GroupNorm's 32 groups), against the JAX `spatial_inference` and against the
port's one-process forward, as tests/test_torch_port_spatial_backbones.py
holds the backbones (random JAX variables from a seed, carried by
`state_dict_from_jax`; one JAX compile a decoder on `make_mesh(2)`; the
port's ranks in one gloo group a world, one thread a rank).

- On 2 ranks at 64x128 (one block of 32 rows a rank: every halo crosses),
  pred_logits and the gathered masks within JAX_TOL of the JAX function's;
- on 2 and 3 ranks with uneven blocks (96x128: 2 and 1; 128x128: 2, 1, 1)
  and a short last block (80x128), within the one-process rule of
  test_torch_port_spatial_backbones.py. TransformerEncoderPixelDecoder's
  encoder attends over all of res5: each rank gathers res5 and keeps its
  rows of the encoder's output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_port_decoder_models import decoder_cfg
from test_torch_port_spatial_backbones import JAX_TOL, check_one_process, jax_case, run_cases

DECODERS = ("BasePixelDecoder", "TransformerEncoderPixelDecoder")
JAX_HW = (64, 128)
PORT_HW = {2: {d: [(64, 128), (96, 128)] for d in DECODERS}, 3: {d: [(128, 128), (80, 128)] for d in DECODERS}}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX function's outputs at JAX_HW, and the port's on every world."""
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as JUniEncoder
    from uni_encoder_tpu.parallel.mesh import make_mesh
    from uni_encoder_tpu.parallel.spatial import spatial_inference
    from uni_encoder_tpu_torch import config as TC

    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 50, (1, 77)).astype(np.int32)
    hws = {JAX_HW} | {hw for per in PORT_HW.values() for v in per.values() for hw in v}
    images = {hw: rng.randn(1, *hw, 3).astype(np.float32) for hw in sorted(hws)}
    jax_out, cases = {}, {}
    for i, name in enumerate(DECODERS):
        jmodel = JUniEncoder(decoder_cfg(JC, name, "TransDSSL"))
        variables, state = jax_case(jmodel, seed=20 + i)
        out = spatial_inference(jmodel, variables, jnp.asarray(images[JAX_HW]), jnp.asarray(tokens), make_mesh(2))
        jax_out[name] = {k: np.asarray(out[k], np.float32) for k in ("pred_logits", "pred_masks")}
        cases[name] = (decoder_cfg(TC, name, "TransDSSL"), state)
    return jax_out, run_cases(tmp_path_factory, cases, PORT_HW, images, tokens.astype(np.int64), "decoders")


@pytest.mark.parametrize("name", DECODERS)
def test_ranks_match_jax_spatial_inference(case, name):
    jax_out, port = case
    per_rank = port[2][name][PORT_HW[2][name].index(JAX_HW)]
    for r, out in enumerate(per_rank):
        np.testing.assert_allclose(out["pred_logits"].numpy(), jax_out[name]["pred_logits"], atol=JAX_TOL,
                                   rtol=JAX_TOL, err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(out["gathered_masks"].numpy(), jax_out[name]["pred_masks"], atol=JAX_TOL,
                                   rtol=JAX_TOL, err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name,n,hw", [(name, n, hw) for n, per in PORT_HW.items() for name in DECODERS
                                       for hw in per[name]])
def test_ranks_match_one_process(case, name, n, hw):
    _, port = case
    check_one_process(port[n][name][PORT_HW[n][name].index(hw)], hw, n)
