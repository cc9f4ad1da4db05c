"""The port's sharded evaluation on the CPU, and the small helpers of the
same slice, against the JAX package:

- `ConfusionMatrix`, `PQStat` and `APAccumulator` `merge` equal the JAX
  package's on tests/test_distributed_eval.py's cases;
- each evaluator's `merge_state` over the shards of `inference_shard`
  equals one evaluator over the union within 1e-9 (Cityscapes semantic,
  panoptic, instance and depth, KITTI, COCO);
- `evaluate_torch.main` on 2 gloo ranks (started with the `spawn` context,
  tests/_torch_port_dist_common.py) over a synthetic Cityscapes tree gives
  the metrics of one process within 1e-9 on both ranks, and rank 0 alone
  writes `--output`; `--num-devices 2` starts the ranks itself;
- `inference_shard` gives test_eval_pipeline.py's cases and JAX's shards;
- `sem_seg_postprocess` equals JAX's;
- `utils/profiling.py`'s `Timer`, `annotate` and `trace` run on the CPU.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_port_dist_common as dist_common
import _torch_port_eval_common as ecommon

SEG_SET = "cityscapes_fine_panoptic_val"
DEPTH_SET = "cityscapes_crop_test"
N_VAL = 4  # synthetic val images: 2 a rank
N_KITTI = 3  # an odd count: the shards differ in size


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic Cityscapes / KITTI tree at the test sizes, registered in
    the port's catalog, and a COCO-format split whose images are not read."""
    from uni_encoder_tpu_torch.data import datasets, synthetic
    from uni_encoder_tpu_torch.data.datasets.coco import register_coco_instances

    root = str(tmp_path_factory.mktemp("dist_eval_tree"))
    synthetic.write_cityscapes_val(root, N_VAL, ecommon.VAL_HW)
    synthetic.write_cityscapes_sequence(root, N_VAL, ecommon.SEQ_HW)
    datasets.register_all(root)
    synthetic.register_kitti(root, ecommon.KITTI_NAME, synthetic.write_kitti(root, N_KITTI))
    square = [[4, 4, 20, 4, 20, 20, 4, 20]]
    coco = {"images": [{"id": i, "file_name": f"im{i}.jpg", "height": 32, "width": 48} for i in (1, 2, 3)],
            "categories": [{"id": 9, "name": "dog"}, {"id": 5, "name": "cat"}],
            "annotations": [{"id": i, "image_id": 1 + i % 3, "category_id": (5, 9)[i % 2], "iscrowd": 0,
                             "area": 256, "bbox": [4, 4, 16, 16],
                             "segmentation": [[v + 2 * i for v in square[0]]]} for i in range(6)]}
    with open(os.path.join(root, "coco.json"), "w") as f:
        json.dump(coco, f)
    register_coco_instances("dist_eval_coco", os.path.join(root, "coco.json"), root)
    return root


# ------------------------------------------------------------ metric merges
def test_metric_merges_match_jax():
    """tests/test_distributed_eval.py's three cases, merged by both
    packages' metrics: the same matrices, statistics and AP."""
    import uni_encoder_tpu.evaluation.metrics as J
    import uni_encoder_tpu_torch.evaluation.metrics as P
    from test_distributed_eval import _random_instances

    rng = np.random.RandomState(0)
    gts = [rng.randint(0, 19, (16, 16)).astype(np.uint8) for _ in range(6)]
    preds = [rng.randint(0, 19, (16, 16)).astype(np.uint8) for _ in range(6)]
    cms = {}
    for name, mod in (("port", P), ("jax", J)):
        a, b, full = mod.ConfusionMatrix(19), mod.ConfusionMatrix(19), mod.ConfusionMatrix(19)
        for i, (g, p) in enumerate(zip(gts, preds)):
            (a if i < 3 else b).update(g, p)
            full.update(g, p)
        a.merge(b)
        np.testing.assert_array_equal(a.mat, full.mat)
        cms[name] = (a.mat, a.miou()[0])
    np.testing.assert_array_equal(cms["port"][0], cms["jax"][0])
    assert cms["port"][1] == cms["jax"][1]

    stats = {}
    for name, mod in (("port", P), ("jax", J)):
        a, b = mod.PQStat(5), mod.PQStat(5)
        a.tp[1], a.fp[2], a.fn[3], a.iou[1] = 3, 1, 2, 2.5
        b.tp[1], b.fp[2], b.fn[4], b.iou[1] = 1, 2, 1, 0.5
        a.merge(b)
        stats[name] = (a.tp, a.fp, a.fn, a.iou)
    for got, ref in zip(stats["port"], stats["jax"]):
        np.testing.assert_array_equal(got, ref)

    rng = np.random.RandomState(1)
    images = []
    for _ in range(4):
        pm, pc, ps = _random_instances(rng, 5)
        gm, gc, _ = _random_instances(rng, 4)
        images.append((pm, pc, ps, gm, gc, rng.rand(4) > 0.8))
    aps = {}
    for name, mod in (("port", P), ("jax", J)):
        full, shards = mod.APAccumulator(3), [mod.APAccumulator(3), mod.APAccumulator(3)]
        for i, image in enumerate(images):
            full.update(*image)
            shards[i % 2].update(*image)
        shards[0].merge(shards[1])
        assert shards[0].summarize() == full.summarize()
        aps[name] = shards[0].summarize()
    assert aps["port"] == aps["jax"]


# ------------------------------------------------ evaluator state merges
def _outputs(kind, items, rng):
    """Random predictions for `items` (test_torch_port_eval's for the
    segmentation evaluators)."""
    from test_torch_port_eval import _random_segmentation_output

    if kind in ("depth", "kitti"):
        hw = (192, 640) if kind == "kitti" else (192, 512)
        return [{"disp_results": (0.05 + 0.9 * rng.rand(*hw)).astype(np.float32)} for _ in items]
    if kind == "coco":
        return [{"instances": {"masks": rng.rand(8, 32, 48) > 0.5, "labels": rng.randint(0, 2, 8),
                               "scores": rng.rand(8).astype(np.float32)}} for _ in items]
    return [_random_segmentation_output(rng, ecommon.VAL_HW) for _ in items]


EVALUATORS = {
    "semantic": ("cityscapes.CityscapesSemSegEvaluator", SEG_SET),
    "panoptic": ("cityscapes.CityscapesPanopticEvaluator", SEG_SET),
    "instance": ("cityscapes.CityscapesInstanceEvaluator", SEG_SET),
    "depth": ("cityscapes.CityscapesDepthEvaluator", DEPTH_SET),
    "kitti": ("kitti.KITTIDepthEvaluator", ecommon.KITTI_NAME),
    "coco": ("coco.COCOInstanceEvaluator", "dist_eval_coco"),
}


@pytest.mark.parametrize("kind", sorted(EVALUATORS))
def test_merged_shard_states_equal_one_evaluator_over_the_union(tree, kind):
    """The dataset in `inference_shard`'s 2 shards, each through its own
    evaluator, the states merged (`merge_state`, in rank order) into a
    fresh one: its metrics equal one evaluator's over every item within
    1e-9; through `DatasetEvaluators` too."""
    import importlib

    from test_torch_port_ade_coco import _assert_close
    from uni_encoder_tpu_torch.data.build import inference_shard
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog
    from uni_encoder_tpu_torch.evaluation.evaluator import DatasetEvaluators

    path, name = EVALUATORS[kind]
    module, cls = path.split(".")
    make = getattr(importlib.import_module(f"uni_encoder_tpu_torch.evaluation.{module}"), cls)
    if kind in ("semantic", "panoptic", "instance"):
        from uni_encoder_tpu_torch.data.build import build_test_loader
        from uni_encoder_tpu_torch.data.mappers import TestMapper

        items = list(build_test_loader(name, TestMapper(seg_min_size=ecommon.VAL_HW[0],
                                                        seg_max_size=ecommon.VAL_HW[1])))
    else:
        items = DatasetCatalog.get(name)
    outs = _outputs(kind, items, np.random.RandomState(3))

    def run(evaluator, idx):
        evaluator.reset()
        for i in idx:
            evaluator.process([items[i]], [outs[i]])
        return evaluator

    ref = run(make(name), range(len(items))).evaluate()
    for wrap in (lambda e: e, lambda e: DatasetEvaluators([e])):
        states = [run(wrap(make(name)), inference_shard(len(items), r, 2)).state() for r in range(2)]
        merged = wrap(make(name))
        merged.reset()
        merged.merge_state(states)
        _assert_close(merged.evaluate(), ref)
    shards = [len(inference_shard(len(items), r, 2)) for r in range(2)]
    assert sum(shards) == len(items) and min(shards) > 0


# --------------------------------------------------------- the entry point
def test_evaluate_main_on_two_ranks_equals_one_process(tree, tmp_path):
    """`evaluate_torch.main` on the scaled profile (test_torch_port_eval's
    weights) over 4 val images and 4 depth frames: on 2 gloo ranks, each
    evaluating 2 of each, both ranks return one process's metrics within
    1e-9, and rank 0 alone wrote `--output`; `--num-devices 2` starts the 2
    ranks itself and its rank 0 writes the same."""
    import evaluate_torch
    from test_torch_port_ade_coco import _assert_close
    from test_torch_port_eval import _config_and_weights

    cfg_path, weights = _config_and_weights(tmp_path)
    argv = ["--config", str(cfg_path), "--weights", str(weights), "--device", "cpu", "--datasets-root", tree,
            f"datasets.depth_test=[{DEPTH_SET}]"]
    outputs = {k: str(tmp_path / f"{k}.json") for k in ("ranks", "command")}
    got = {}

    def beside(key, fn, *args):  # the 2-rank runs, beside each other and this process's own
        try:
            got[key] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - raised below, in the test's thread
            got["error"] = e

    threads = [threading.Thread(target=beside, args=("ranks", dist_common.run_ranks, dist_common.evaluate_rank, 2,
                                                     tmp_path / "ranks", argv + ["--output", outputs["ranks"]])),
               threading.Thread(target=beside, args=("command", evaluate_torch.main,
                                                     argv + ["--num-devices", "2", "--output", outputs["command"]]))]
    for thread in threads:
        thread.start()
    try:
        one = evaluate_torch.main(argv)
    finally:
        for thread in threads:
            thread.join()
    if "error" in got:
        raise got["error"]
    assert sorted(one["seg_and_depth"]) == sorted([f"{DEPTH_SET}/depth_error", f"{SEG_SET}/panoptic_seg",
                                                   f"{SEG_SET}/sem_seg", f"{SEG_SET}/segm"])
    for r in got["ranks"]:
        _assert_close(r, one)
    assert got["command"] is None
    for path in outputs.values():
        with open(path) as f:
            _assert_close(json.load(f), one)


def test_allgather_object_without_a_group():
    from uni_encoder_tpu_torch.evaluation.evaluator import allgather_object

    assert allgather_object({"a": [1, 2]}) == [{"a": [1, 2]}]


# ------------------------------------------------------------ small helpers
@pytest.mark.parametrize("n, world", [(10, 4), (10, 1), (3, 4), (0, 2), (7, 3)])
def test_inference_shard_matches_jax(n, world):
    from uni_encoder_tpu.data.build import inference_shard as jshard
    from uni_encoder_tpu_torch.data.build import inference_shard

    shards = [inference_shard(n, r, world) for r in range(world)]
    assert shards == [jshard(n, r, world) for r in range(world)]
    assert [i for s in shards for i in s] == list(range(n))
    if (n, world) == (10, 4):  # tests/test_eval_pipeline.py's cases
        assert list(shards[0]) == [0, 1, 2] and list(shards[3]) == [9]


@pytest.mark.parametrize("size", [(20, 30, 40, 50), (24, 32, 24, 32), (17, 23, 9, 11)])
def test_sem_seg_postprocess_matches_jax(size):
    """Crop of the padded (C, H, W) maps, then bilinear (align_corners
    False) to the output size: the JAX function's within 1e-6."""
    from uni_encoder_tpu.inference.postprocess import sem_seg_postprocess as jpost
    from uni_encoder_tpu_torch.inference.postprocess import sem_seg_postprocess

    h, w, out_h, out_w = size
    x = np.random.RandomState(h).randn(5, 32, 40).astype(np.float32)
    got = sem_seg_postprocess(torch.from_numpy(x), (h, w), out_h, out_w)
    ref = np.asarray(jpost(jnp.asarray(x), (h, w), out_h, out_w))
    assert tuple(got.shape) == ref.shape == (5, out_h, out_w)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_profiling_helpers_run_on_the_cpu(tmp_path):
    from uni_encoder_tpu_torch.utils.profiling import Timer, annotate, trace

    timer = Timer()
    x = torch.randn(64, 64)
    for _ in range(2):
        with timer.section("matmul", block_on=x @ x):
            pass
    with timer.section("plain"):
        pass
    assert timer.counts == {"matmul": 2, "plain": 1} and all(v >= 0 for v in timer.totals.values())
    assert timer.summary().splitlines()[0].startswith("matmul") or "matmul" in timer.summary()

    @annotate("decorated")
    def work():
        return x.sum()

    with trace(str(tmp_path / "trace")):
        with annotate("section"):
            work()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"section", "decorated"} <= names
