"""The port's data-parallel training (`uni_encoder_tpu_torch/parallel/`) on
the CPU: gloo, 2 ranks started with the `spawn` context and a `file://`
rendezvous under the test's tmp_path (tests/_torch_port_dist_common.py),
one thread each, a time limit per run. The JAX trainer on N devices is
the one-device step at the global batch (`train.py`: one GSPMD program,
the batch sharded over the mesh's data axis); these tests hold the port's
ranks to that:

- train-mode BatchNorm on 2 ranks gives tests/test_syncbn.py's case (JAX on
  the conftest's 8 virtual devices): output, input gradient and running
  statistics (SyncBN);
- the set criterion and the monodepth loss on 2 ranks, each holding half of
  a batch of 4, give every term of JAX's on the whole batch, and the
  gradients with respect to every input; the halves differ in their valid
  targets (num_masks), their texts (the contrastive negatives) and their
  flows (m_sparsity's threshold);
- two micro Trainer steps on 2 ranks at local batch 1 equal two steps in
  one process at batch 2: losses, gradients, the parameters' updates,
  AdamW's moments, BatchNorm statistics; the ranks' states are the same
  bytes after each step; a wrong update planted in the step is caught;
- `train_torch.py --num-devices 2 --device cpu` equals `--num-devices 1`
  at the same global batch, rank 0 alone writes, and the refusals name
  their numbers.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port_dist_common as dist_common

WORLD = 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _cat_ranks(ranks, get):
    """The ranks' rows of a quantity, in rank order (the global batch's)."""
    return np.concatenate([_np(get(r)) for r in ranks])


# ------------------------------------------------------------------ SyncBN
def test_syncbn_on_two_ranks_matches_jax_sharded_batchnorm(tmp_path):
    """tests/test_syncbn.py's case: 8 shards of 2 images whose statistics
    differ widely, JAX's FrozenBatchNorm under jit with the batch sharded
    over the 8 virtual devices; the port's on 2 ranks of 8 images each.
    Output, running mean and variance, and the input gradient of
    sum(out * cotangent) (JAX's vjp; a rank's gradient of its share is the
    global gradient) at atol / rtol 1e-5."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from uni_encoder_tpu.models.layers import FrozenBatchNorm as JBN
    from uni_encoder_tpu.parallel.mesh import make_mesh

    C = 4
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(2, 4, 4, C) * (i + 1) + 3 * i for i in range(8)], axis=0).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    mesh = make_mesh(8, model_parallel=1)
    bn = JBN(C, use_running_average=False)
    variables = jax.jit(bn.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, C)))

    @jax.jit
    def step(v, inp, c):
        (out, mut), vjp = jax.vjp(lambda a: bn.apply(v, a, mutable=["batch_stats"]), inp)
        return out, mut["batch_stats"], vjp((c, jax.tree_util.tree_map(jnp.zeros_like, mut)))[0]

    sharding = NamedSharding(mesh, P("data", None, None, None))
    with mesh:
        out, stats, grad = step(variables, jax.device_put(jnp.asarray(x), sharding),
                                jax.device_put(jnp.asarray(cot), sharding))

    ranks = dist_common.run_ranks(dist_common.syncbn_rank, WORLD, tmp_path, x, cot)
    kw = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_cat_ranks(ranks, lambda r: r["out"]), np.asarray(out), **kw)
    np.testing.assert_allclose(_cat_ranks(ranks, lambda r: r["grad"]), np.asarray(grad), **kw)
    for r in ranks:
        np.testing.assert_allclose(_np(r["mean"]), np.asarray(stats["mean"]), **kw)
        np.testing.assert_allclose(_np(r["var"]), np.asarray(stats["var"]), **kw)
    # a rank's own statistics would not do: the case can fail
    assert not np.allclose(0.1 * x[:8].reshape(-1, C).mean(0), np.asarray(stats["mean"]), rtol=1e-3)


# ------------------------------------------------- criterion and monodepth
def _criterion_case():
    """A batch of 4 whose halves differ: 4 + 3 valid targets in the first
    half, 1 + 0 in the second (num_masks), texts of other scales
    (the contrastive negatives)."""
    from test_torch_port_train_parts import _criterion_draws, _seg_targets

    rng = np.random.RandomState(11)
    B, Q, K, N, H, W, C, P = 4, 6, 5, 4, 16, 20, 8, 50
    sets = [((rng.randn(B, Q, K + 1) * 2).astype(np.float32), (rng.randn(B, Q, H, W) * 3).astype(np.float32))
            for _ in range(3)]
    labels, masks, valid = _seg_targets(rng, B, N, H, W, K, N)
    valid[:] = np.arange(N)[None] < np.array([4, 3, 1, 0])[:, None]
    texts = (rng.randn(B, Q, C) * np.array([1, 1, 3, 0.3])[:, None, None]).astype(np.float32)
    from uni_encoder_tpu_torch.training.criterion import SetCriterion

    kw = dict(num_classes=K, num_points=P)
    pc = SetCriterion(**kw)
    draws = _criterion_draws(jax.random.PRNGKey(2), 3, B, B * N, P, pc.n_sampled, P - pc.n_uncertain)
    return {"kwargs": kw, "sets": sets, "queries": rng.randn(B, Q, C).astype(np.float32), "text_feats": texts,
            "logit_scale": np.float32(np.log(1 / 0.07)), "labels": labels, "masks": masks, "valid": valid,
            "draws": [{k: v.numpy() for k, v in d.items()} for d in draws]}


def _monodepth_case(step):
    """Three scales of a 24 x 40 frame triple, batch 4; the second half's
    complete flow 10x the first's, so each half's static threshold differs
    from the batch's."""
    from test_torch_port_train_parts import _monodepth_case as case, _monodepth_draws

    B, H, W, S = 4, 24, 40, 3
    outputs, targets = case(np.random.RandomState(7), B, H, W, S)
    for k, v in outputs["complete_flow"].items():
        v[2:] *= 10.0
    draws = _monodepth_draws(jax.random.PRNGKey(5), B, H, W, [(H >> s, W >> s) for s in range(S)])
    return {"outputs": outputs, "targets": targets, "step": step,
            "draws": {"noise": [x.numpy() for x in draws["noise"]],
                      "ransac_idx": [x.numpy() for x in draws["ransac_idx"]], "n_ground": draws["n_ground"]}}


def _jax_criterion(crit):
    from uni_encoder_tpu.training.criterion import SetCriterion as JCriterion

    jc = JCriterion(**crit["kwargs"])

    def loss(sets, queries, scale):
        outs = {"pred_logits": sets[-1][0], "pred_masks": sets[-1][1], "contrastive_logits": queries,
                "aux_outputs": [{"pred_logits": a, "pred_masks": b} for a, b in sets[:-1]]}
        tg = {"labels": jnp.asarray(crit["labels"]), "masks": jnp.asarray(crit["masks"]),
              "valid": jnp.asarray(crit["valid"]), "text_feats": jnp.asarray(crit["text_feats"]),
              "logit_scale": scale}
        return jc(jax.random.PRNGKey(2), outs, tg)

    @jax.jit
    def loss_and_grads(*args):
        ref, vjp = jax.vjp(loss, *args)
        return ref, vjp({k: jnp.ones_like(v) if k == "loss_total" else jnp.zeros_like(v) for k, v in ref.items()})

    return loss_and_grads([tuple(jnp.asarray(a) for a in s) for s in crit["sets"]], jnp.asarray(crit["queries"]),
                          jnp.asarray(crit["logit_scale"]))


def _jax_monodepth(md):
    from test_torch_port_train_parts import _tree_map
    from uni_encoder_tpu.training.monodepth import monodepth_loss as jloss

    targets = _tree_map(jnp.asarray, md["targets"])

    @jax.jit
    def loss_and_grads(o):
        ref, vjp = jax.vjp(lambda o: jloss(jax.random.PRNGKey(5), o, targets, jnp.asarray(md["step"])), o)
        return ref, vjp({k: jnp.ones_like(v) if k == "loss_monodepth" else jnp.zeros_like(v)
                         for k, v in ref.items()})[0]

    return loss_and_grads(_tree_map(jnp.asarray, md["outputs"]))


def _one_process(crit, md):
    """The port in this process (no group) on the whole batch: the chain's
    middle link, already held against JAX by test_torch_port_train_parts."""
    return dist_common.losses_rank(None, crit, md)


def test_criterion_and_monodepth_on_two_ranks_match_jax_at_the_global_batch(tmp_path):
    """Every term: the mean over the 2 ranks of their shares against JAX's
    on the whole batch at test_torch_port_train_parts's tolerances (the
    criterion rtol 1e-5, atol 1e-6; monodepth rtol 1e-4, atol 1e-6, but
    d_ground 2e-3 and the total 5e-4: the RANSAC plane fit's conditioning,
    that file's MONODEPTH_RTOL), and against the port in one process on the
    whole batch at rtol 1e-5 (d_ground and the total too). Gradients with
    respect to every input: a rank's gradient of its share is the global
    loss's gradient times the number of ranks; against JAX's vjp at atol
    1e-6 (criterion) / 1e-5 (monodepth), rtol 1e-4 and 1e-3, as that file.
    Each half alone would give other normalizers and thresholds: the case
    can fail."""
    from test_torch_port_train_parts import MONODEPTH_RTOL

    crit, md = _criterion_case(), _monodepth_case(10000)
    ranks = dist_common.run_ranks(dist_common.losses_rank, WORLD, tmp_path, crit, md)
    one = _one_process(crit, md)
    ref_c, (dsets, dq, dscale) = _jax_criterion(crit)
    ref_m, dmd = _jax_monodepth(md)

    for group, ref, rtol, atol in (("criterion", ref_c, {}, 1e-6), ("monodepth", ref_m, MONODEPTH_RTOL, 1e-6)):
        assert sorted(ranks[0][group]) == sorted(ref)
        for k in ref:
            mean = np.mean([_np(r[group][k]) for r in ranks])
            np.testing.assert_allclose(mean, np.asarray(ref[k]), rtol=rtol.get(k, 1e-5 if group == "criterion"
                                                                              else 1e-4), atol=atol,
                                       err_msg=f"{group} {k} against JAX")
            np.testing.assert_allclose(mean, _np(one[group][k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{group} {k} against one process")

    grads = [r["criterion_grads"] for r in ranks]
    for i, (da, db) in enumerate(dsets):
        for j, ref in enumerate((da, db)):
            got = _cat_ranks(grads, lambda g: g["sets"][i][j]) / WORLD
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, rtol=1e-4, err_msg=f"set {i} input {j}")
    np.testing.assert_allclose(_cat_ranks(grads, lambda g: g["queries"]) / WORLD, np.asarray(dq), atol=1e-6,
                               rtol=1e-4)
    np.testing.assert_allclose(np.mean([_np(g["logit_scale"]) for g in grads]), np.asarray(dscale), atol=1e-6,
                               rtol=1e-4)
    for key, tree in md["outputs"].items():
        for k in tree:
            got = _cat_ranks(ranks, lambda r: r["monodepth_grads"][key][k]) / WORLD
            np.testing.assert_allclose(got, np.asarray(dmd[key][k]), atol=1e-5, rtol=1e-3, err_msg=f"{key} {k}")

    # the halves' own normalizers differ from the batch's
    valid = crit["valid"]
    assert valid[:2].sum() != valid.sum() / WORLD != valid[2:].sum()
    flow = np.stack([md["outputs"]["complete_flow"][(1, 0)][:2], md["outputs"]["complete_flow"][(1, 0)][2:]])
    assert np.abs(flow[1]).mean() > 5 * np.abs(flow[0]).mean()


# ------------------------------------------------------------- whole steps
STEP_SIZE = 64  # micro_batches' frames: at 32x32 a rank's single image leaves GroupNorm one value a group
STEP_SEED = 5
N_STEPS = 2
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # also AdamW's moments
BN_RTOL = 1e-4
# each parameter element within lr * min(UPDATE_GAIN * (|dg / g| + |dc / c|)
# + 1e-5, PARAM_LRS) + 2 ulps, c the clip scale: AdamW's step g / sqrt(v)
# moves by at most about twice the relative change of the clipped gradient
# (1e-5: the update's own rounding), and a gradient within rounding of 0 (a bias right
# before a normalization) has a noise sign, moving the element by up to a
# learning rate either way
UPDATE_GAIN, PARAM_LRS = 4.0, 2.0


def test_two_ranks_step_equals_one_process_at_the_global_batch(tmp_path):
    """The micro Trainer (deterministic, fp32, one thread, seed 0 weights,
    draws from one seed) takes 2 steps on 2 ranks at local batch 1; before
    each, rank 0 takes one process's step at batch 2 from the same state
    with the same draws (`_torch_port_dist_common.step_rank`: no state
    crosses a file). After each step:
    - every loss term within LOSS_RTOL relative; d_ground within
      test_torch_port_train_parts's MONODEPTH_RTOL (2e-3: its RANSAC plane
      fit is ill-conditioned);
    - every gradient (all-reduced, before the clip) within GRAD_RTOL in
      relative norm, against the larger of its own norm and its share of the
      whole gradient's (`chip_smoke.scale_aware_errors`: a gradient that is
      zero in exact arithmetic holds rounding noise on either side);
    - AdamW's moments (mu and sqrt(nu)) within GRAD_RTOL in the same
      relative norm;
    - every parameter element after AdamW within its learning rate times
      UPDATE_GAIN times its gradient's relative difference, at most PARAM_LRS
      learning rates, plus two ulps (`chip_smoke.param_errors`: tight where
      the gradient stands clear of rounding noise);
    - every BatchNorm statistic within BN_RTOL of its largest element.
    The ranks' parameters, gradients, buffers and optimizer moments are the
    same bytes (sha256) after each step. A wrong update planted in the
    ranks' step (`planted_faults`: a learning rate 1% high, a first moment
    1% high) is caught by the parameter and moment bounds alone.
    chip_smoke.py's multi_device phase holds the card to these bounds (its
    MD_* constants)."""
    import chip_smoke
    from test_torch_port_train_parts import MONODEPTH_RTOL

    assert MONODEPTH_RTOL["monodepth/d_ground"] == chip_smoke.MD_D_GROUND_RTOL
    assert (LOSS_RTOL, GRAD_RTOL, BN_RTOL, UPDATE_GAIN, PARAM_LRS) == (
        chip_smoke.MD_LOSS_RTOL, chip_smoke.MD_GRAD_RTOL, chip_smoke.MD_BN_RTOL, chip_smoke.MD_UPDATE_GAIN,
        chip_smoke.MD_PARAM_LRS)
    r0, r1 = dist_common.run_ranks(dist_common.step_rank, WORLD, tmp_path, N_STEPS, STEP_SEED, STEP_SIZE)
    for s, errs in enumerate(r0["errors"]):
        assert r0["digests"][s] == r1["digests"][s], f"step {s}: the ranks' states differ"
        past, _ = chip_smoke.md_within_bounds(errs)
        assert not past, f"step {s}: {chip_smoke.md_error_summary(errs)}"
        planted = r0["planted"][s]
        assert planted["learning_rate_1%_high"] and all(
            q.startswith("param ") for q in planted["learning_rate_1%_high"]), planted
        assert planted["first_moment_1%_high"] and all(
            q.startswith("moment mu ") for q in planted["first_moment_1%_high"]), planted
    assert len(r0["errors"]) == N_STEPS and len(r0["digests"][0]) > 3 * errs["counts"]["params"]


# ------------------------------------------------------------- entry point
def _read_metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_cli_on_two_ranks_equals_one_process(tmp_path, monkeypatch):
    """`train_torch.py --device cpu --num-devices 2` (2 ranks started by
    the command) against `--num-devices 1`, both at the global `--batch 2`,
    2 iterations of tests/test_train_cli.py's micro config on
    data/synthetic.py's training tree: metrics.json's losses agree within
    the step test's LOSS_RTOL, rank 0 alone wrote the events
    and the checkpoint (rank 1 wrote nothing). A global batch that does not divide by the ranks raises before
    any rank starts, naming the numbers."""
    import train_torch
    from test_train_cli import MICRO_YAML
    from uni_encoder_tpu_torch.data import synthetic

    root = str(tmp_path / "data")
    synthetic.write_cityscapes_train(root, 4, (64, 128))
    cfg = tmp_path / "micro.yaml"
    cfg.write_text(MICRO_YAML)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' thread count
    argv = ["--config", str(cfg), "--datasets-root", root, "--device", "cpu", "--max-iter", "2", "--batch", "2",
            "--log-period", "1", "--checkpoint-period", "2"]
    runs = {name: str(tmp_path / name) for name in ("two", "one")}
    started = {}

    def two_ranks():  # the command's 2 ranks, beside this process's own run
        try:
            started["state"] = train_torch.main(argv + ["--num-devices", "2", "--output-dir", runs["two"]])
        except BaseException as e:  # noqa: BLE001 - raised below, in the test's thread
            started["error"] = e

    thread = threading.Thread(target=two_ranks)
    thread.start()
    try:
        state = train_torch.main(argv + ["--num-devices", "1", "--output-dir", runs["one"]])
    finally:
        thread.join()
    if "error" in started:
        raise started["error"]
    assert started["state"] is None and state.step == 2

    two, one = _read_metrics(runs["two"]), _read_metrics(runs["one"])
    assert [r["iteration"] for r in two] == [r["iteration"] for r in one] == [0, 1]
    for a, r in zip(two, one):
        for k in train_torch.METRICS:
            np.testing.assert_allclose(a[k], r[k], rtol=LOSS_RTOL, atol=0, err_msg=k)
    # rank 0 alone wrote: the same files as one process, once
    assert sorted(f for f in os.listdir(runs["two"]) if not f.startswith(".")) == sorted(
        f for f in os.listdir(runs["one"]) if not f.startswith("."))
    saved = torch.load(os.path.join(runs["two"], "step_2.pt"), weights_only=True)
    assert saved["step"] == 2 and saved["optimizer"] is None

    with pytest.raises(ValueError, match="--batch 3 .* does not divide over 2 ranks"):
        train_torch.main(argv[:-4] + ["--batch", "3", "--num-devices", "2", "--output-dir", str(tmp_path / "x")])
    assert not os.path.exists(tmp_path / "x")


def test_an_unreadable_item_stops_a_two_rank_run(tmp_path, monkeypatch):
    """A file that exists but cannot be read (here a directory in place of
    a panoptic PNG, which a skipping rank only stats) is read whole by the
    one rank that maps it: `train_torch.py --num-devices 2` then stops with
    that rank's error instead of dropping the item there alone (the ranks'
    batches would drift apart). One global epoch of the 4 items is mapped
    within the run's 2 batches, so the planted item is reached."""
    import train_torch
    from test_train_cli import MICRO_YAML
    from uni_encoder_tpu_torch.data import synthetic
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog
    from uni_encoder_tpu_torch.data.datasets import register_all

    root = str(tmp_path / "data")
    synthetic.write_cityscapes_train(root, 4, (64, 128))
    register_all(root)
    pan = DatasetCatalog.get("cityscapes_fine_panoptic_train")[2]["pan_seg_file_name"]
    os.remove(pan)
    os.makedirs(pan)
    cfg = tmp_path / "micro.yaml"
    cfg.write_text(MICRO_YAML)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(Exception, match="of 2: cannot read a segmentation item"):
        train_torch.main(["--config", str(cfg), "--datasets-root", root, "--device", "cpu", "--max-iter", "1",
                          "--batch", "2", "--num-devices", "2", "--output-dir", str(tmp_path / "run")])


def test_mappers_skip_draws_what_mapping_draws(tmp_path):
    """A rank skips the other ranks' items of a global batch: `skip` reads
    only the headers (`image_io.image_size` gives `read_image`'s shape) and
    draws what mapping draws, so the next item maps to the same bytes as
    when every item is mapped, and the streams end in the same state."""
    from uni_encoder_tpu_torch.data import synthetic
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog
    from uni_encoder_tpu_torch.data.datasets import register_all
    from uni_encoder_tpu_torch.data.image_io import image_size, read_image
    from uni_encoder_tpu_torch.data.train_mappers import SegmentationTrainMapper, SequenceTrainMapper

    root = str(tmp_path)
    synthetic.write_cityscapes_train(root, 3, (48, 96))
    register_all(root)
    kinds = {"cityscapes_fine_panoptic_train": lambda: SegmentationTrainMapper(crop_size=(32, 64), min_sizes=(32, 48, 64),
                                                                               max_size=128, num_texts=4),
             "cityscapes_sequence_crop_full_sequence_train": lambda: SequenceTrainMapper(hw=(32, 64))}
    for name, make in kinds.items():
        items = DatasetCatalog.get(name)
        assert image_size(items[0]["file_name"]) == read_image(items[0]["file_name"]).shape[:2]
        every, skipping = make(), make()
        mapped = [every(item) for item in items]
        skipping.skip(items[0])
        got = [skipping(item) for item in items[1:2]]
        skipping.skip(items[2])
        for k, v in mapped[1].items():
            assert (got[0][k] == v) if isinstance(v, str) else np.array_equal(got[0][k], v), (name, k)
        assert every.rng.rand() == skipping.rng.rand(), name


def test_num_devices_above_the_visible_cards_raises():
    """The check the entry points make before starting ranks on CUDA: one
    rank a card; on the CPU any number."""
    from uni_encoder_tpu_torch.parallel import mesh

    mesh.check_num_devices(2, "cuda", visible=2)
    mesh.check_num_devices(8, "cpu", visible=0)
    with pytest.raises(ValueError, match="--num-devices 3 asks for 3 CUDA devices, but 2 are visible"):
        mesh.check_num_devices(3, "cuda", visible=2)
    with pytest.raises(ValueError, match="--num-devices 0"):
        mesh.check_num_devices(0, "cpu")
    assert mesh.rank() == 0 and mesh.world() == 1 and not mesh.active()
    x = torch.arange(6.0).reshape(6, 1)
    assert mesh.all_reduce_sum(x) is x and mesh.all_gather(x) is x
    assert torch.equal(mesh.shard_batch({"a": x}, 1, 3)["a"], x[2:4])
    with pytest.raises(ValueError, match="a batch of 6 .* does not divide over 4 ranks"):
        mesh.shard_batch(x, 0, 4)


def test_a_dead_rank_fails_the_run(tmp_path):
    """A rank that raises fails the run instead of hanging it: its sibling,
    waiting in a collective, is stopped (or its collective fails as the
    rank's connection closes), and the launcher raises with the first error
    it sees, well inside the time limit (past it, a TimeoutError)."""
    with pytest.raises(Exception, match="rank 1 gives up|Connection (closed|reset) by peer"):
        dist_common.run_ranks(dist_common.failing_rank, WORLD, tmp_path, timeout_s=60)
