"""ADE20K and COCO evaluation in the port against the JAX package, on the
CPU: the prep codecs and ADE20K tables (`data/prep.py`, the asset), the
registrations (`data/datasets/{ade20k,coco}.py`), the mask decoders and
`COCOInstanceEvaluator` (`evaluation/coco.py`), `evaluate_torch.build_evaluator`'s
ADE20K routes and `evaluate_torch.main` on a mini-ADE20K tree.

Two trees: the JAX tests' fixture (a raw ADE20K tree run through the three
`datasets/prepare_ade20k_*.py` scripts, tests/test_eval_pipeline.py:164-213)
and the port's `synthetic.write_ade20k`; both packages register and read
the same files. Codecs, tables, decoders and registrations are equal;
metrics within 1e-9; GT fed back scores PQ = mIoU = AP = 100.
"""

import importlib.util
import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_port_common as common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAN = "ade20k_panoptic_val"
SEM = "ade20k_sem_seg_val"
INST = "ade20k_instance_val"
ADE_HW = (64, 96)  # the synthetic tree's images: the scaled model's input, no resize


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _register(root):
    """Register `root`'s ADE20K splits in both packages' catalogs."""
    from uni_encoder_tpu.data.datasets import ade20k as jade
    from uni_encoder_tpu_torch.data.datasets import ade20k

    ade20k.register_all(root)
    jade.register_all(root)


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """The JAX tests' mini-ADE20K: raw annotations -> the prepare scripts."""
    from uni_encoder_tpu.data.prep import ade20k_instance_to_semantic

    root = tmp_path_factory.mktemp("mini_ade_jax")
    base = os.path.join(str(root), "ADEChallengeData2016")
    ins_to_sem = ade20k_instance_to_semantic()
    sem_of_thing = ins_to_sem[3]
    stuff_sem = next(s for s in range(1, 151) if s not in set(ins_to_sem.values()))
    for split in ("training", "validation"):
        for sub in ("images", "annotations", "annotations_instance"):
            os.makedirs(os.path.join(base, sub, split), exist_ok=True)
        for k in range(2):
            name = f"ADE_{split[:5]}_{k:08d}"
            h, w = 32, 48
            Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(os.path.join(base, "images", split, name + ".jpg"))
            sem = np.full((h, w), stuff_sem, np.uint8)
            sem[10:20, 8:24] = sem_of_thing
            Image.fromarray(sem).save(os.path.join(base, "annotations", split, name + ".png"))
            inst = np.zeros((h, w, 3), np.uint8)
            inst[10:20, 8:24, 0] = 3
            inst[10:15, 8:24, 1] = 1
            inst[15:20, 8:24, 1] = 2
            Image.fromarray(inst).save(os.path.join(base, "annotations_instance", split, name + ".png"))
    for script in ("prepare_ade20k_sem_seg", "prepare_ade20k_pan_seg", "prepare_ade20k_ins_seg"):
        spec = importlib.util.spec_from_file_location(script, os.path.join(REPO, "datasets", script + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main(str(root))
    return str(root)


@pytest.fixture(scope="module")
def synthetic_tree(tmp_path_factory):
    from uni_encoder_tpu_torch.data import synthetic

    root = str(tmp_path_factory.mktemp("mini_ade_port"))
    synthetic.write_ade20k(root, "val", 2, ADE_HW)
    synthetic.write_ade20k(root, "train", 1, ADE_HW, seed=6)
    return root


@pytest.fixture(params=["jax_fixture", "synthetic"])
def tree(request, jax_tree, synthetic_tree):
    root = jax_tree if request.param == "jax_fixture" else synthetic_tree
    _register(root)
    return root


def _random_mask(rng, h, w, kind):
    if kind == "empty":
        return np.zeros((h, w), bool)
    if kind == "full":
        return np.ones((h, w), bool)
    if kind == "long_runs":  # runs longer than 2**16: counts of 17+ bits
        m = np.ones((h, w), bool)
        m[:, w // 2: w // 2 + 2] = False
        return m
    if kind == "noise":  # short runs after long ones: negative deltas
        m = np.zeros((h, w), bool)
        m[:, : w // 2] = True
        m[:, w // 2:] = rng.rand(h, w - w // 2) > 0.5
        return m
    return rng.rand(h, w) > rng.uniform(0.2, 0.8)


MASKS = [("empty", (5, 7)), ("full", (9, 4)), ("random", (31, 17)), ("long_runs", (400, 400)),
         ("noise", (40, 60)), ("random", (1, 1))]


# ------------------------------------------------------------ prep, tables
def test_ade20k_asset_and_tables_match_jax():
    import uni_encoder_tpu.data.prep as J
    import uni_encoder_tpu_torch.data.prep as P

    with open(J._ASSET, "rb") as a, open(P._ASSET, "rb") as b:
        assert a.read() == b.read()
    assert P.ade20k_150_categories() == J.ade20k_150_categories()
    assert P.ade20k_instance_to_semantic() == J.ade20k_instance_to_semantic()
    assert len(P.ade20k_150_categories()) == 150
    assert sum(c["isthing"] for c in P.ade20k_150_categories()) == 100


@pytest.mark.parametrize("kind,hw", MASKS, ids=[f"{k}_{h}x{w}" for k, (h, w) in MASKS])
def test_rle_codecs_match_jax(kind, hw):
    import uni_encoder_tpu.data.prep as J
    import uni_encoder_tpu_torch.data.prep as P

    mask = _random_mask(np.random.RandomState(3), *hw, kind)
    assert P.mask_to_rle_counts(mask) == J.mask_to_rle_counts(mask)
    rle = P.encode_rle(mask)
    assert rle == J.encode_rle(mask)
    assert P.rle_area(rle) == J.rle_area(rle) == int(mask.sum())
    assert P.rle_area({"counts": P.mask_to_rle_counts(mask)}) == int(mask.sum())
    assert P.mask_bbox_xywh(mask) == J.mask_bbox_xywh(mask)
    if kind == "long_runs":
        assert max(P.mask_to_rle_counts(mask)) > 2 ** 16


def test_panoptic_codec_and_id_generator_match_jax():
    import uni_encoder_tpu.data.prep as J
    import uni_encoder_tpu_torch.data.prep as P

    rng = np.random.RandomState(4)
    ids = rng.randint(0, 256 ** 3, (17, 23)).astype(np.int64)
    rgb = P.id2rgb(ids)
    np.testing.assert_array_equal(rgb, J.id2rgb(ids))
    np.testing.assert_array_equal(P.rgb2id(rgb), ids)
    np.testing.assert_array_equal(P.rgb2id(rgb), J.rgb2id(rgb))
    assert P.rgb2id([1, 2, 3]) == J.rgb2id([1, 2, 3]) == 1 + 2 * 256 + 3 * 65536
    np.testing.assert_array_equal(P.id2rgb(70000), J.id2rgb(70000))
    cats = {c["id"]: c for c in P.ade20k_150_categories()}
    gp, gj = P.IdGenerator(cats), J.IdGenerator(cats)
    draws = [int(c) for c in rng.randint(0, 150, 300)]  # repeats force the jittered colours
    assert [gp.get_id_and_color(c) for c in draws] == [gj.get_id_and_color(c) for c in draws]


# ------------------------------------------------------------- decoders
@pytest.mark.parametrize("kind,hw", MASKS, ids=[f"{k}_{h}x{w}" for k, (h, w) in MASKS])
def test_rle_decoders_match_jax(kind, hw):
    import uni_encoder_tpu.evaluation.coco as J
    import uni_encoder_tpu_torch.data.prep as prep
    import uni_encoder_tpu_torch.evaluation.coco as P

    mask = _random_mask(np.random.RandomState(5), *hw, kind)
    rle = prep.encode_rle(mask)
    counts = P._decode_compressed_rle(rle["counts"])
    assert counts == J._decode_compressed_rle(rle["counts"]) == prep.mask_to_rle_counts(mask)
    for r in (dict(rle, order="F"), {"counts": counts, "order": "F"}):
        got = P._rle_to_mask(r, *hw)
        np.testing.assert_array_equal(got, J._rle_to_mask(r, *hw))
        np.testing.assert_array_equal(got, mask)
    c_order = {"counts": prep.mask_to_rle_counts(mask.T), "order": "C"}  # row-major runs of the same mask
    np.testing.assert_array_equal(P._rle_to_mask(c_order, *hw), J._rle_to_mask(c_order, *hw))


POLYGONS = {
    "convex": [[4.2, 3.0, 30.6, 5.5, 25.0, 28.4, 6.0, 20.0]],
    "concave": [[5, 5, 40, 5, 40, 30, 22, 12, 5, 30]],
    "out_of_frame": [[-10, -5, 60, 8, 30, 50]],
    "two_parts": [[1, 1, 10, 1, 10, 10], [20.5, 20.5, 44, 21, 30, 31.5, 22, 28]],
    "degenerate": [[12, 12, 12, 12, 30, 12]],
}


@pytest.mark.parametrize("name", sorted(POLYGONS))
def test_poly_to_mask_matches_jax(name):
    import uni_encoder_tpu.evaluation.coco as J
    import uni_encoder_tpu_torch.evaluation.coco as P

    got = P._poly_to_mask(POLYGONS[name], 32, 48)
    assert got.dtype == bool and got.shape == (32, 48)
    np.testing.assert_array_equal(got, J._poly_to_mask(POLYGONS[name], 32, 48))
    rng = np.random.RandomState(6)
    random_polys = [list(rng.uniform(-8, 56, 2 * rng.randint(3, 9))) for _ in range(3)]
    np.testing.assert_array_equal(P._poly_to_mask(random_polys, 32, 48), J._poly_to_mask(random_polys, 32, 48))


# -------------------------------------------------------- registrations
def _metadata(catalog, name):
    meta = vars(catalog.get(name))
    return {k: v for k, v in meta.items() if k != "name"}


def test_ade20k_registration_matches_jax(tree):
    from uni_encoder_tpu.data.catalog import DatasetCatalog as JD, MetadataCatalog as JM
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog

    for name in (PAN, SEM, INST, "ade20k_panoptic_train", "ade20k_sem_seg_train", "ade20k_instance_train"):
        got, ref = DatasetCatalog.get(name), JD.get(name)
        assert got == ref and got, name
        assert _metadata(MetadataCatalog, name) == _metadata(JM, name), name
    meta = MetadataCatalog.get(PAN)
    assert (meta.label_divisor, meta.ignore_label, meta.evaluator_type) == (1000, 255, "ade20k_panoptic_seg")
    assert len(meta.instance_classes) == 100 and len(meta.stuff_classes) == 150
    assert all("annotations" in item for item in DatasetCatalog.get(PAN))
    assert MetadataCatalog.get(INST).evaluator_type == "coco_instance"


def test_ade20k_instance_split_registered_only_with_its_json(tmp_path):
    from uni_encoder_tpu_torch.data import synthetic
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog
    from uni_encoder_tpu_torch.data.datasets import ade20k, register_all

    synthetic.write_ade20k(str(tmp_path), "val", 1, (32, 48))
    os.remove(os.path.join(str(tmp_path), "ADEChallengeData2016", "ade20k_instance_val.json"))
    DatasetCatalog.remove(INST)
    register_all(str(tmp_path))  # the package's register_all reaches ADE20K
    assert INST not in DatasetCatalog.list() and PAN in DatasetCatalog.list()
    assert "annotations" not in ade20k.load_panoptic_split(os.path.join(str(tmp_path), "ADEChallengeData2016"),
                                                            "val")[0]


@pytest.fixture()
def coco_json(tmp_path):
    """A COCO-format json with category ids 9 and 5 (out of order), a
    polygon, an RLE and a crowd annotation, and an image without any."""
    from uni_encoder_tpu_torch.data.prep import encode_rle

    img_root = tmp_path / "images"
    img_root.mkdir()
    for i in (0, 1):
        Image.fromarray(np.full((32, 48, 3), 40 * i, np.uint8)).save(img_root / f"im{i}.jpg")
    rle_mask = np.zeros((32, 48), bool)
    rle_mask[20:30, 30:45] = True
    data = {
        "images": [{"id": 1, "file_name": "im0.jpg", "height": 32, "width": 48},
                   {"id": 2, "file_name": "im1.jpg", "height": 32, "width": 48}],
        "categories": [{"id": 9, "name": "dog"}, {"id": 5, "name": "cat"}],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 5, "iscrowd": 0, "area": 121, "bbox": [4, 4, 11, 11],
             "segmentation": [[4, 4, 14, 4, 14, 14, 4, 14]]},
            {"id": 2, "image_id": 1, "category_id": 9, "iscrowd": 0, "area": 150, "bbox": [30, 20, 15, 10],
             "segmentation": encode_rle(rle_mask)},
            {"id": 3, "image_id": 1, "category_id": 9, "iscrowd": 1, "area": 20, "bbox": [0, 25, 5, 4],
             "segmentation": [[0, 25, 4, 25, 4, 28, 0, 28]]},
        ],
    }
    path = tmp_path / "inst.json"
    path.write_text(json.dumps(data))
    return str(path), str(img_root)


def test_coco_registration_matches_jax(coco_json):
    from uni_encoder_tpu.data.catalog import DatasetCatalog as JD, MetadataCatalog as JM
    from uni_encoder_tpu.data.datasets.coco import register_coco_instances as jregister
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
    from uni_encoder_tpu_torch.data.datasets.coco import load_coco_json, register_coco_instances

    register_coco_instances("port_coco", *coco_json)
    jregister("port_coco", *coco_json)
    items = DatasetCatalog.get("port_coco")
    assert items == JD.get("port_coco") and len(items) == 2
    assert [a["category_id"] for a in items[0]["annotations"]] == [0, 1, 1]  # sorted-id remap: 5 -> 0, 9 -> 1
    assert items[1]["annotations"] == []
    assert _metadata(MetadataCatalog, "port_coco") == _metadata(JM, "port_coco")
    assert MetadataCatalog.get("port_coco").thing_classes == ["cat", "dog"]
    assert load_coco_json(*coco_json) == items


# ------------------------------------------------------------ evaluators
def _random_instances(rng, h, w, n, num_classes, gt_masks=()):
    """Random masks, labels and scores; some are jittered GT masks, so
    matches happen at several IoU thresholds."""
    masks = rng.rand(n, h, w) > 0.7
    labels = rng.randint(0, num_classes, n)
    for i, (m, c) in enumerate(gt_masks[: n // 2]):
        masks[i] = m ^ (rng.rand(h, w) > 0.97)
        labels[i] = c
    return {"masks": masks, "labels": labels, "scores": rng.rand(n).astype(np.float32)}


def _gt_masks(item):
    from uni_encoder_tpu_torch.evaluation.coco import _poly_to_mask, _rle_to_mask

    h, w = item["height"], item["width"]
    out = []
    for a in item.get("annotations", []):
        s = a["segmentation"]
        out.append((_poly_to_mask(s, h, w) if isinstance(s, list) else _rle_to_mask(dict(s, order="F"), h, w),
                    a["category_id"]))
    return out


def _evaluate(evaluator, items, outs):
    evaluator.reset()
    for item, out in zip(items, outs):
        evaluator.process([item], [out])
    return evaluator.evaluate()


def _assert_close(got, ref, atol=1e-9):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        if isinstance(r, dict):
            _assert_close(got[k], r, atol)
        else:
            np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(r, float), rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("dataset", [INST, "port_coco"])
def test_coco_instance_evaluator_matches_jax(dataset, synthetic_tree, coco_json):
    """Random predictions on the ADE20K instance split and on a COCO json:
    AP equal within 1e-9; `state` / `merge_state` over two halves give the
    whole's AP; GT fed back scores 100."""
    import uni_encoder_tpu.evaluation.coco as J
    from uni_encoder_tpu.data.datasets.coco import register_coco_instances as jregister
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog
    from uni_encoder_tpu_torch.data.datasets.coco import register_coco_instances
    from uni_encoder_tpu_torch.evaluation.coco import COCOInstanceEvaluator

    _register(synthetic_tree)
    register_coco_instances("port_coco", *coco_json)
    jregister("port_coco", *coco_json)
    items = DatasetCatalog.get(dataset)
    rng = np.random.RandomState(11)
    n_classes = 100 if dataset == INST else 2
    outs = [{"instances": _random_instances(rng, it["height"], it["width"], 12, n_classes, _gt_masks(it))}
            for it in items]
    got = _evaluate(COCOInstanceEvaluator(dataset), items, outs)
    _assert_close(got, _evaluate(J.COCOInstanceEvaluator(dataset), items, outs))
    assert 0 < got["segm"]["AP"] < 100

    halves = []
    for part in (slice(0, 1), slice(1, None)):
        e = COCOInstanceEvaluator(dataset)
        e.reset()
        for item, out in zip(items[part], outs[part]):
            e.process([item], [out])
        halves.append(e.state())
    merged = COCOInstanceEvaluator(dataset)
    merged.reset()
    merged.merge_state(halves)
    _assert_close(merged.evaluate(), got)

    if dataset == INST:  # every image holds instances
        gts = [_gt_masks(it) for it in items]
        gt_outs = [{"instances": {"masks": np.stack([m for m, _ in g]), "labels": np.asarray([c for _, c in g]),
                                  "scores": np.ones(len(g), np.float32)}} for g in gts]
        assert _evaluate(COCOInstanceEvaluator(dataset), items, gt_outs)["segm"]["AP"] == pytest.approx(100.0)


def _random_ade_output(rng, item, K=150):
    h, w = item["height"], item["width"]
    sem = rng.rand(K, h, w).astype(np.float32)
    seg = np.zeros((h, w), np.int32)
    infos = []
    for i, label in enumerate(rng.choice(K, 10, replace=False), start=1):
        y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
        seg[y:y + rng.randint(4, h // 2), x:x + rng.randint(4, w // 2)] = i
        infos.append({"id": i, "category_id": int(label), "isthing": bool(label in (7, 8, 10, 12, 14, 20))})
    gt = item.get("segments_info", [])
    for s in gt[:3]:  # some predicted segments equal GT ones
        infos.append({"id": 100 + s["id"] % 1000, "category_id": s["category_id"], "isthing": False})
    infos = [s for s in infos if (seg == s["id"]).any()]
    return {"sem_seg": sem, "panoptic_seg": (seg, infos),
            "instances": _random_instances(rng, h, w, 10, 100, _gt_masks(item))}


@pytest.mark.parametrize("task", ["panoptic", "semantic", "instance"])
def test_ade20k_build_evaluator_matches_jax(task, tree):
    """Both packages' `build_evaluator` routes for ADE20K (panoptic: PQ +
    mIoU, no segm; semantic: mIoU; instance: AP over 100 classes) on the
    same random predictions, within 1e-9."""
    import evaluate
    import evaluate_torch
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog

    items = DatasetCatalog.get(PAN)
    rng = np.random.RandomState(12)
    outs = [_random_ade_output(rng, it) for it in items]
    got = _evaluate(evaluate_torch.build_evaluator(PAN, task), items, outs)
    _assert_close(got, _evaluate(evaluate.build_evaluator(PAN, task), items, outs))
    assert sorted(got) == {"panoptic": ["panoptic_seg", "sem_seg"], "semantic": ["sem_seg"],
                           "instance": ["segm"]}[task]


def test_ade20k_gt_fed_back_gives_perfect_scores(tree):
    import evaluate_torch
    from uni_encoder_tpu_torch.data.build import build_test_loader
    from uni_encoder_tpu_torch.data.mappers import TestMapper
    from uni_encoder_tpu_torch.data.synthetic import ade20k_gt_as_prediction

    results = {}
    for task in ("panoptic", "instance", "semantic"):
        items = list(build_test_loader(PAN, TestMapper(task=task, seg_min_size=32, seg_max_size=128)))
        assert len(items) == 2
        results[task] = _evaluate(evaluate_torch.build_evaluator(PAN, task), items,
                                  [ade20k_gt_as_prediction(it) for it in items])
    assert results["panoptic"]["panoptic_seg"]["PQ"] == pytest.approx(100.0)
    assert results["panoptic"]["sem_seg"]["mIoU"] == pytest.approx(100.0)
    assert "segm" not in results["panoptic"]
    assert results["instance"]["segm"]["AP"] == pytest.approx(100.0)
    assert results["semantic"]["sem_seg"]["mIoU"] == pytest.approx(100.0)


# ------------------------------------------------------------ entry point
ADE_CONFIG = f"""
model:
  backbone:
    name: swin
    swin:
      embed_dim: {common.EMBED}
      depths: {list(common.DEPTHS)}
      num_heads: {list(common.HEADS)}
  sem_seg_head:
    num_classes: 150
    convs_dim: {common.CONV_DIM}
    mask_dim: {common.CONV_DIM}
    transformer_enc_layers: {common.ENC_LAYERS}
  one_former:
    num_object_queries: {common.NQ}
    dec_layers: {common.DEC_LAYERS}
    class_dec_layers: 2
    dim_feedforward: {common.DFF}
    hidden_dim: {common.CONV_DIM}
    nheads: {common.NHEADS}
  test:
    detections_per_image: {common.NQ * 150}
input:
  seg_min_size_test: {ADE_HW[0]}
  seg_max_size_test: {ADE_HW[1] * 2}
datasets:
  depth_test: []
  seg_test_panoptic: [{PAN}]
  seg_test_semantic: [{PAN}]
  seg_test_instance: [{PAN}, {INST}]
"""


@pytest.fixture(scope="module")
def ade_weights(tmp_path_factory):
    """A 150-class scaled model's config file and a .pkl of random weights
    (class head x8, so queries clear the 0.8 threshold)."""
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    d = tmp_path_factory.mktemp("ade_model")
    cfg_path = d / "ade_scaled.yaml"
    cfg_path.write_text(ADE_CONFIG)
    cfg = load_config(str(cfg_path))
    state = common.random_d2_state(UniEncoder(cfg.model, device="cpu"), seed=23)
    state["sem_seg_head.predictor.class_embed.weight"] *= 8.0
    weights = d / "ade_model.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": state}, f)
    return str(cfg_path), str(weights)


@pytest.mark.parametrize("task", ["panoptic", "semantic", "instance"])
def test_evaluate_main_on_ade20k_matches_jax_evaluators(task, synthetic_tree, ade_weights):
    """`evaluate_torch.main --device cpu` on the synthetic mini-ADE20K with a
    150-class scaled model, against the JAX loaders, mappers and evaluators
    fed the port Predictor's outputs with the same weights (the instance
    task also evaluates the COCO-format instance split)."""
    import evaluate
    import evaluate_torch
    from uni_encoder_tpu.data.build import build_test_loader as jbuild
    from uni_encoder_tpu.data.catalog import MetadataCatalog as JMeta
    from uni_encoder_tpu.data.mappers import TestMapper as JMapper
    from uni_encoder_tpu_torch.config import load_config
    from uni_encoder_tpu_torch.engine.predictor import Predictor

    cfg_path, weights = ade_weights
    _register(synthetic_tree)
    timings = []
    got = evaluate_torch.main(["--config", cfg_path, "--weights", weights, "--device", "cpu", "--task", task,
                               "--datasets-root", synthetic_tree], timings=timings)["seg_and_depth"]
    sets = [PAN, INST] if task == "instance" else [PAN]
    assert [t["dataset"] for t in timings] == [s for s in sets for _ in range(2)]

    cfg = load_config(cfg_path, [f"model.test.task={task}"])
    model, _ = evaluate_torch.build_model(cfg, weights, "cpu")
    predictor = Predictor(cfg, model)
    _register(synthetic_tree)
    n_instances = 0
    for name in sets:
        meta = JMeta.get(name)
        predictor.set_thing_ids(sorted(meta.get("thing_dataset_id_to_contiguous_id").values()), name)
        ev = evaluate.build_evaluator(name, task)
        ev.reset()
        for item in jbuild(name, JMapper(task=task, seg_min_size=ADE_HW[0], seg_max_size=ADE_HW[1] * 2)):
            out = predictor.infer_segmentation(item)
            n_instances += len(out["instances"]["labels"])
            ev.process([item], [out])
        ref = ev.evaluate()
        _assert_close({k: got[f"{name}/{k}"] for k in ref}, ref)
    assert sorted(got) == sorted(f"{name}/{k}" for name in sets for k in
                                 {"panoptic": ["panoptic_seg", "sem_seg"], "semantic": ["sem_seg"],
                                  "instance": ["segm"]}[task] if not (name == INST and k != "segm"))
    assert n_instances > 0
