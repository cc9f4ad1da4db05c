"""The port's tools/calc_throughput_torch.py and tools/analyze_model_torch.py
against the JAX tools (tools/calc_throughput.py, tools/analyze_model.py),
on the CPU:

- the throughput tool's fixed batch equals the JAX tool's recipe
  (`tools/calc_throughput.py:49-71`, computed here with numpy and
  jax.numpy), its timer starts after iteration 4 and its img/s is
  (iters - 5) * 2 * batch / elapsed; the tool runs at the micro config;
- the analysis tool's parameter TOTAL equals the JAX tool's
  (`variables["params"]` of the segmentation forward's init) for every
  shipped config at full width: the port's model on `device="meta"`, the
  JAX one through `jax.eval_shape`;
- its FLOP count (torch's operator count) of the segmentation forward
  against XLA's `cost_analysis()["flops"]` of the JAX forward, at the
  scaled profile (tests/_torch_port_common.py): XLA also counts the
  elementwise work, the softmaxes, the norms and the deformable sampling,
  so the ratio is held in a band around the measured one.
"""

import glob
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_port_common as common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
# port operator FLOPs / XLA FLOPs of the scaled segmentation forward at
# 128x256: 0.9162 / 1.1258 GFLOP = 0.814 measured (XLA counts the
# elementwise work too); held within 0.75 to 0.88
FLOP_RATIO_BAND = (0.75, 0.88)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_throughput_batch_is_the_jax_tools():
    """B = 2, 64x96, 5 targets: every array of both batches equals the JAX
    tool's recipe, byte for byte."""
    import calc_throughput_torch as tool
    from uni_encoder_tpu_torch.config import Config

    cfg = Config()
    B, H, W, N = 2, 64, 96, 5
    seg, seq = tool.synthetic_batches(cfg, B, H, W, N, "cpu")
    rng = np.random.RandomState(0)
    n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
    want_seg = {"images": np.asarray(jnp.asarray(rng.randn(B, H, W, 3), jnp.float32)),
                "task_tokens": np.ones((B, 77), np.int32), "text_tokens": np.ones((B, n_texts, 77), np.int32),
                "labels": np.asarray(jnp.asarray(rng.randint(0, 19, (B, N)), jnp.int32)),
                "masks": np.asarray(jnp.asarray(rng.rand(B, N, H // 4, W // 4) > 0.5)),
                "valid": np.ones((B, N), bool)}
    K = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    K[:, 0, 0] = K[:, 1, 1] = 300.0
    K[:, 0, 2], K[:, 1, 2] = W / 2, H / 2
    want_seq = {k: np.asarray(jnp.asarray(rng.randn(B, H, W, 3), jnp.float32) * 0.1)
                for k in ("images", "prev_images", "next_images")}
    want_seq["K"], want_seq["inv_K"] = np.asarray(jnp.asarray(K)), np.asarray(jnp.asarray(np.linalg.inv(K)))
    for got, want in ((seg, want_seg), (seq, want_seq)):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            g = got[k].numpy()
            assert g.shape == v.shape and np.array_equal(g, v.astype(g.dtype)), k
            assert g.dtype == {np.int32: np.int64}.get(v.dtype.type, v.dtype), k


def test_timer_starts_after_iteration_4():
    """`measure` with a clock that counts its calls: the timer reads once
    after step 4 (fenced) and once after the last step (fenced)."""
    import calc_throughput_torch as tool

    events = []
    ticks = iter(range(100, 200))

    def clock():
        events.append("clock")
        return float(next(ticks))

    out = tool.measure(lambda i: events.append(f"step{i}") or {"loss": i}, 8, lambda: events.append("sync"), clock)
    assert events == [f"step{i}" for i in range(5)] + ["sync", "clock"] + [f"step{i}" for i in range(5, 8)] + \
        ["sync", "clock"]
    assert out == {"metrics": {"loss": 7}, "elapsed_s": 1.0, "timed_iters": 3}
    with pytest.raises(ValueError, match="above 5"):
        tool.measure(lambda i: {}, 5, lambda: None)


def test_throughput_tool_runs_at_the_micro_config(tmp_path, capsys):
    """`main` with `--device cpu --iters 6` at the micro config: one timed
    iteration, img/s = (6 - 5) * 2 * batch / elapsed, printed as the JAX
    tool prints it."""
    import calc_throughput_torch as tool
    from test_train_cli import MICRO_YAML

    cfg = tmp_path / "micro.yaml"
    cfg.write_text(MICRO_YAML)
    out = tool.main(["--config", str(cfg), "--iters", "6", "--batch", "1", "--height", "32", "--width", "64",
                     "--targets", "3", "--device", "cpu"])
    assert out["timed_iters"] == 1 and np.isfinite(out["loss"])
    assert out["img_per_s"] == pytest.approx(2 * 1 / out["elapsed_s"], rel=1e-12)
    assert out["ms_per_step"] == pytest.approx(out["elapsed_s"] * 1e3, rel=1e-12)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == f"loss={out['loss']:.4f}"
    assert lines[-1] == f"throughput: {out['img_per_s']:.2f} img/s ({out['ms_per_step']:.1f} ms/step)"


@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: os.path.basename(p))
def test_parameter_total_is_the_jax_tools(config):
    """The port's TOTAL (the segmentation forward's modules, on meta) is the
    number of parameters the JAX tool's init creates, at full width."""
    import analyze_model_torch as tool
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu_torch.config import load_config

    cfg = load_config(config)
    out = tool.analyze(cfg, ("param",), device="meta")
    jcfg = JC.load_config(config)
    shapes = jax.eval_shape(J(jcfg.model).init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 256, 3), jnp.float32),
                            jnp.zeros((1, jcfg.input.task_seq_len), jnp.int32))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert out["params_total"] == want
    assert out["forwards"] == 0 and out["params_sequence_heads"] > 0


def test_flop_count_against_xla_cost_analysis():
    """The scaled profile at 128x256: the port's operator count over
    XLA's flops of the same forward lies in FLOP_RATIO_BAND."""
    import analyze_model_torch as tool
    from uni_encoder_tpu import config as JC
    from uni_encoder_tpu.models.oneformer import UniEncoder as J
    from uni_encoder_tpu_torch import config as TC

    H, W = 128, 256
    out = tool.analyze(TC.Config(model=common.make_cfg(TC)), ("flop", "param", "speed"), H, W, iters=1,
                       device="cpu")
    assert out["forwards"] == 3  # the count, one warm-up, one timed

    jmodel = J(common.make_cfg(JC))
    img, tok = jnp.zeros((1, H, W, 3), jnp.float32), jnp.zeros((1, 77), jnp.int32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), img, tok)
    cost = jax.jit(jmodel.apply).lower(shapes, img, tok).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    ratio = out["flops"] / cost["flops"]
    assert FLOP_RATIO_BAND[0] < ratio < FLOP_RATIO_BAND[1], (out["flops"], cost["flops"], ratio)
