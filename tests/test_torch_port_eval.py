"""The port's evaluation path (`evaluate_torch.py`, `uni_encoder_tpu_torch/
{data,evaluation,engine/tta.py}`) against the JAX package's, on the CPU, on a
synthetic Cityscapes / KITTI tree (tests/_torch_port_eval_common.py).

- GT fed back as the prediction scores PQ = mIoU = AP = 100;
- the port's evaluators equal the JAX evaluators on the same random
  predictions: segmentation metrics to 1e-9, depth metrics to rtol 1e-5
  (the port resizes the disparity with cv2's coordinates in numpy, within
  a float32 ulp or two of cv2). The threshold metrics a1-a3 count the
  points whose depth ratio is below 1.25^k, so a point within rounding of
  a threshold may fall either side: they may also differ by one point
  (1e-4: the synthetic KITTI scan leaves about 13 000 points in the crop,
  Cityscapes about 600 000 pixels);
- `generate_depth_map` equals JAX's exactly;
- `TestMapper` and the loader give JAX's items exactly (PIL's resizes are
  reproduced bit for bit);
- `SemanticTTA` is flip-consistent and equals JAX's;
- `evaluate_torch.main([..., "--device", "cpu"])` on a `.pkl` of the scaled
  profile gives the JAX evaluators' metrics on the port Predictor's
  outputs (as above), with PIL and cv2 unimportable.
"""

import dataclasses
import math
import pickle
import sys

import numpy as np
import pytest
import torch

import _torch_port_common as common
import _torch_port_eval_common as ecommon

SEG_SET = "cityscapes_fine_panoptic_val"
DEPTH_SETS = ("cityscapes_crop_test", ecommon.KITTI_NAME)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic_tree"))
    ecommon.write_and_register_tree(root)
    return root


def _items(pkg, name, **mapper_kw):
    """(mapped items) of dataset `name` through package `pkg`'s loader."""
    import importlib

    build = importlib.import_module(f"{pkg}.data.build")
    mappers = importlib.import_module(f"{pkg}.data.mappers")
    return list(build.build_test_loader(name, mappers.TestMapper(**mapper_kw)))


DEPTH_RTOL = 1e-5
THRESHOLD_ATOL = 1e-4  # one point of the ~13 000 a synthetic KITTI scan leaves in the crop


def _assert_metrics_close(got, ref, rtol=0.0, atol=1e-9):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        g = got[k]
        if k == "depth_error":
            _assert_metrics_close({m: v for m, v in g.items() if m not in ("a1", "a2", "a3")},
                                  {m: v for m, v in r.items() if m not in ("a1", "a2", "a3")}, DEPTH_RTOL, 0.0)
            _assert_metrics_close({m: g[m] for m in ("a1", "a2", "a3")}, {m: r[m] for m in ("a1", "a2", "a3")},
                                  DEPTH_RTOL, THRESHOLD_ATOL)
        elif isinstance(r, dict):
            _assert_metrics_close(g, r, rtol, atol)
        elif isinstance(r, (list, tuple)):
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(r, float), rtol=rtol, atol=atol, err_msg=k)
        else:
            assert math.isclose(g, r, rel_tol=rtol, abs_tol=atol) or (math.isnan(g) and math.isnan(r)), (k, g, r)


# ----------------------------------------------------------- GT fed back
def test_gt_fed_back_gives_perfect_scores(tree):
    from uni_encoder_tpu_torch.data.synthetic import gt_as_prediction
    from uni_encoder_tpu_torch.evaluation.cityscapes import (
        CityscapesInstanceEvaluator,
        CityscapesPanopticEvaluator,
        CityscapesSemSegEvaluator,
    )

    items = _items("uni_encoder_tpu_torch", SEG_SET, seg_min_size=ecommon.VAL_HW[0],
                   seg_max_size=ecommon.VAL_HW[1])
    assert len(items) == 2
    evals = [CityscapesSemSegEvaluator(SEG_SET), CityscapesPanopticEvaluator(SEG_SET),
             CityscapesInstanceEvaluator(SEG_SET)]
    for e in evals:
        e.reset()
        for item in items:
            e.process([item], [gt_as_prediction(item)])
    sem, pan, inst = (e.evaluate() for e in evals)
    assert sem["sem_seg"]["mIoU"] == pytest.approx(100.0)
    assert pan["panoptic_seg"]["PQ"] == pytest.approx(100.0), pan
    assert inst["segm"]["AP"] == pytest.approx(100.0), inst


# ------------------------------------------------ evaluators against JAX
def _random_segmentation_output(rng, hw, n_inst=6):
    h, w = hw
    K = 19
    sem = rng.rand(K, h, w).astype(np.float32)
    seg = np.zeros((h, w), np.int32)
    infos = []
    labels = rng.randint(0, K, 8)
    for i, label in enumerate(labels, start=1):  # rectangles of random classes
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        seg[y:y + rng.randint(4, h // 2), x:x + rng.randint(4, w // 2)] = i
        infos.append({"id": i, "category_id": int(label), "isthing": bool(label >= 11)})
    infos = [s for s in infos if (seg == s["id"]).any()]
    masks = rng.rand(n_inst, h, w) > 0.6
    masks[:, h // 2:, : w // 2] |= rng.rand(n_inst, 1, 1) > 0.5  # some overlap the GT car
    return {"sem_seg": sem, "panoptic_seg": (seg, infos),
            "instances": {"masks": masks, "labels": rng.randint(9, 19, n_inst),
                          "scores": rng.rand(n_inst).astype(np.float32)}}


@pytest.mark.parametrize("pred_hw", [ecommon.VAL_HW, (32, 64)], ids=["gt_size", "resized"])
def test_segmentation_evaluators_match_jax(tree, pred_hw):
    """Random predictions at the GT size, and at half of it (resized to the
    GT by NEAREST in both packages)."""
    import uni_encoder_tpu.evaluation.cityscapes as J
    import uni_encoder_tpu_torch.evaluation.cityscapes as P

    jitems = _items("uni_encoder_tpu", SEG_SET, seg_min_size=ecommon.VAL_HW[0], seg_max_size=ecommon.VAL_HW[1])
    rng = np.random.RandomState(7)
    outs = [_random_segmentation_output(rng, pred_hw) for _ in jitems]
    for cls in ("CityscapesSemSegEvaluator", "CityscapesPanopticEvaluator", "CityscapesInstanceEvaluator"):
        results = []
        for mod in (P, J):
            e = getattr(mod, cls)(SEG_SET)
            e.reset()
            for item, out in zip(jitems, outs):
                e.process([item], [out])
            results.append(e.evaluate())
        _assert_metrics_close(*results)


def test_depth_evaluators_match_jax(tree):
    import uni_encoder_tpu.evaluation.cityscapes as Jc
    import uni_encoder_tpu.evaluation.kitti as Jk
    import uni_encoder_tpu_torch.evaluation.cityscapes as Pc
    import uni_encoder_tpu_torch.evaluation.kitti as Pk

    rng = np.random.RandomState(8)
    for name, pcls, jcls, hw in ((DEPTH_SETS[0], Pc.CityscapesDepthEvaluator, Jc.CityscapesDepthEvaluator, (192, 512)),
                                 (DEPTH_SETS[1], Pk.KITTIDepthEvaluator, Jk.KITTIDepthEvaluator, (192, 640))):
        from uni_encoder_tpu.data.catalog import DatasetCatalog

        items = DatasetCatalog.get(name)
        outs = [{"disp_results": (0.05 + 0.9 * rng.rand(*hw)).astype(np.float32)} for _ in items]
        results = []
        for cls in (pcls, jcls):
            e = cls(name)
            e.reset()
            for item, out in zip(items, outs):
                e.process([item], [out])
            results.append(e.evaluate())
        _assert_metrics_close(*results)


def test_generate_depth_map_matches_jax(tree):
    from uni_encoder_tpu.evaluation.kitti import generate_depth_map as jgen
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog
    from uni_encoder_tpu_torch.evaluation.kitti import generate_depth_map

    for item in DatasetCatalog.get(ecommon.KITTI_NAME):
        got = generate_depth_map(item["calib_path"], item["velo_file"], 2, True)
        ref = jgen(item["calib_path"], item["velo_file"], 2, True)
        assert got.shape == (375, 1242) and (got > 0).sum() > 1000
        np.testing.assert_array_equal(got, ref)


# -------------------------------------------------------- mapper, loader
@pytest.mark.parametrize("name,kw", [
    (SEG_SET, dict(seg_min_size=ecommon.VAL_HW[0], seg_max_size=ecommon.VAL_HW[1])),  # no resize
    (SEG_SET, dict(seg_min_size=48, seg_max_size=1000)),  # bilinear downscale
    (SEG_SET, dict(seg_min_size=100, seg_max_size=1000)),  # bilinear upscale
    (DEPTH_SETS[0], dict(sequence_hw=(192, 512))),  # Lanczos upscale of every frame
    (DEPTH_SETS[1], dict(sequence_hw=(192, 640))),  # Lanczos downscale from 375x1242
])
def test_test_mapper_and_loader_match_jax(tree, name, kw):
    got = _items("uni_encoder_tpu_torch", name, **kw)
    ref = _items("uni_encoder_tpu", name, **kw)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert g[k].dtype == v.dtype, k
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k


# -------------------------------------------------------------------- TTA
class _FakePredictor:
    """A per-class map that depends on the image content (its mean colour
    by column), resized to the output size: equal inputs give equal
    outputs in both packages."""

    def infer_segmentation(self, item):
        h, w = item["height"], item["width"]
        img = item["image"].astype(np.float32)
        col = img.mean(axis=(0, 2))
        cols = np.interp(np.linspace(0, len(col) - 1, w), np.arange(len(col)), col)
        sem = np.stack([np.broadcast_to(cols / 255.0, (h, w)), np.broadcast_to(1 - cols / 255.0, (h, w))])
        return {"sem_seg": sem.astype(np.float32)}


def test_semantic_tta_flip_consistent_and_matches_jax():
    from uni_encoder_tpu.engine.tta import SemanticTTA as JTTA
    from uni_encoder_tpu_torch.engine.tta import SemanticTTA

    class Halves:  # tests/test_engine_extras.py:83
        def infer_segmentation(self, item):
            h, w = item["height"], item["width"]
            sem = np.zeros((2, h, w), np.float32)
            sem[0, :, : w // 2] = 1.0
            sem[1, :, w // 2:] = 1.0
            return {"sem_seg": sem}

    out = SemanticTTA(Halves(), min_sizes=[16, 24], max_size=64, flip=True)(
        {"image": np.zeros((16, 32, 3), np.uint8), "height": 16, "width": 32})
    assert out["sem_seg"].shape == (2, 16, 32)
    np.testing.assert_allclose(out["sem_seg"][0] + out["sem_seg"][1], 1.0)

    img = np.random.RandomState(9).randint(0, 256, (24, 40, 3), np.uint8)
    item = {"image": img, "height": 24, "width": 40}
    kw = dict(min_sizes=[16, 30, 48], max_size=100, flip=True)
    got = SemanticTTA(_FakePredictor(), **kw)(item)["sem_seg"]
    np.testing.assert_array_equal(got, JTTA(_FakePredictor(), **kw)(item)["sem_seg"])


# ------------------------------------------------------------ entry point
def _config_and_weights(tmp_path):
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    cfg_path = tmp_path / "scaled.yaml"
    cfg_path.write_text(ecommon.SCALED_CONFIG)
    cfg = load_config(str(cfg_path))
    state = common.random_d2_state(UniEncoder(cfg.model, device="cpu"), seed=21)
    state["sem_seg_head.predictor.class_embed.weight"] *= 8.0  # queries clear the 0.8 threshold
    state["motion_decoder.layer1.0.weight"] = np.zeros((4, 4, 1, 1), np.float32)  # not owned
    weights = tmp_path / "model_final.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": state}, f)
    return cfg_path, weights


def test_evaluate_main_matches_jax_evaluators(tree, tmp_path, monkeypatch):
    """The whole entry point on the CPU (PIL and cv2 unimportable), one
    image per dataset, against the JAX loaders, mappers and evaluators fed
    the outputs of the port's Predictor with the same weights."""
    import evaluate
    import evaluate_torch
    from uni_encoder_tpu.data.build import build_test_loader as jbuild
    from uni_encoder_tpu.data.catalog import MetadataCatalog as JMeta
    from uni_encoder_tpu.data.mappers import TestMapper as JMapper
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.engine.predictor import Predictor

    cfg_path, weights = _config_and_weights(tmp_path)
    argv = ["--config", str(cfg_path), "--weights", str(weights), "--device", "cpu", "--datasets-root", tree,
            "--max-images", "1"]
    with monkeypatch.context() as m:
        for mod in ("PIL", "PIL.Image", "cv2"):
            m.setitem(sys.modules, mod, None)
        m.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        m.setattr(torch.backends.cudnn, "allow_tf32", True)
        timings = []
        got = evaluate_torch.main(argv, timings=timings)["seg_and_depth"]
        # the fp32 model's TF32 switch-off ends with the call
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert [t["dataset"] for t in timings] == [*DEPTH_SETS, SEG_SET]
    assert sorted(got) == sorted([f"{DEPTH_SETS[0]}/depth_error", f"{DEPTH_SETS[1]}/depth_error",
                                  f"{SEG_SET}/panoptic_seg", f"{SEG_SET}/sem_seg", f"{SEG_SET}/segm"])

    cfg = load_config(str(cfg_path))
    model, report = evaluate_torch.build_model(cfg, str(weights), "cpu")
    assert report.unused == ["motion_decoder.layer1.0.weight"]
    predictor = Predictor(cfg, model)
    for name in (*DEPTH_SETS, SEG_SET):
        meta = JMeta.get(name)
        etype = meta.get("evaluator_type")
        mapper = JMapper(task="panoptic", seg_min_size=ecommon.VAL_HW[0], seg_max_size=ecommon.VAL_HW[1],
                         sequence_hw=(192, 640) if etype == "kitti_depth" else (192, 512))
        loader = jbuild(name, mapper)
        loader.items = loader.items[:1]
        if etype in ("cityscapes_depth", "kitti_depth"):
            run = predictor.infer_sequence
        else:
            predictor.set_thing_ids(sorted(meta.get("thing_dataset_id_to_contiguous_id").values()), name)
            run = predictor.infer_segmentation
        ev = evaluate.build_evaluator(name, "panoptic")
        ev.reset()
        for item in loader:
            ev.process([item], [run(item)])
        ref = ev.evaluate()
        _assert_metrics_close({k: got[f"{name}/{k}"] for k in ref}, ref)


def test_evaluate_main_restores_tf32_when_it_raises(tmp_path, monkeypatch):
    import evaluate_torch

    cfg_path = tmp_path / "scaled.yaml"
    cfg_path.write_text(ecommon.SCALED_CONFIG)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(FileNotFoundError):
        evaluate_torch.main(["--config", str(cfg_path), "--weights", str(tmp_path / "missing.pth"),
                             "--device", "cpu", "--datasets-root", str(tmp_path)])
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_evaluate_main_needs_a_gpu_unless_told_cpu(tree, monkeypatch):
    import evaluate_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_torch.main(["--datasets-root", tree])


@pytest.mark.parametrize("etype", ["ade20k_panoptic_seg", "coco_instance"])
def test_unported_evaluators_raise(etype):
    """The two evaluator types that raised NotImplementedError before ADE20K
    and COCO evaluation were ported now route as evaluate.py routes them
    (tests/test_torch_port_ade_coco.py holds their metrics against JAX)."""
    import evaluate_torch
    from uni_encoder_tpu_torch.data.catalog import MetadataCatalog
    from uni_encoder_tpu_torch.evaluation.cityscapes import CityscapesPanopticEvaluator, CityscapesSemSegEvaluator
    from uni_encoder_tpu_torch.evaluation.coco import COCOInstanceEvaluator

    MetadataCatalog.get(f"unported_{etype}").set(evaluator_type=etype)
    ev = evaluate_torch.build_evaluator(f"unported_{etype}", "panoptic")
    if etype == "coco_instance":
        assert isinstance(ev, COCOInstanceEvaluator)
    else:
        assert [type(e) for e in ev._evaluators] == [CityscapesPanopticEvaluator, CityscapesSemSegEvaluator]
        inst = evaluate_torch.build_evaluator(f"unported_{etype}", "instance")._evaluators
        assert len(inst) == 1 and isinstance(inst[0], COCOInstanceEvaluator) and inst[0].num_classes == 100
