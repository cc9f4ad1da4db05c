"""Evaluation entry point of the PyTorch port (the counterpart of
`evaluate.py`, the reference's `train_net.py --eval-only`).

Mirrors Trainer.test (reference train_net.py:188-257): iterates
DATASETS.DEPTH_TEST, then DATASETS.SEG_TEST_{TASK}, builds the evaluator
for each dataset's evaluator_type, runs single-image inference through the
port's `Predictor` (or `SemanticTTA` with TEST.AUG for the semantic task)
and merges every metric under "seg_and_depth". Datasets: the Cityscapes
panoptic and sequence splits and KITTI; ADE20K and COCO are not ported yet.

Weights: a reference d2 `.pkl` or torch `.pth`, or a port checkpoint
directory (`uni_encoder_tpu_torch/engine/checkpoint.py`); orbax directories
of the JAX package are not read. The model runs on the GPU unless
`--device cpu` is given; without a GPU and without that flag it raises.

Usage:
  python evaluate_torch.py --weights model.pth [--config cfg.yaml]
      [--task panoptic] [--device cpu] [--datasets-root DIR] [opts a.b.c=v ...]
"""

import argparse
import dataclasses
import logging
import os
import sys
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch

logger = logging.getLogger("evaluate_torch")

DEPTH_TYPES = ("cityscapes_depth", "kitti_depth")


def build_evaluator(dataset_name: str, task: str):
    from uni_encoder_tpu_torch.data.catalog import MetadataCatalog
    from uni_encoder_tpu_torch.evaluation.cityscapes import (
        CityscapesDepthEvaluator,
        CityscapesInstanceEvaluator,
        CityscapesPanopticEvaluator,
        CityscapesSemSegEvaluator,
    )
    from uni_encoder_tpu_torch.evaluation.evaluator import DatasetEvaluators
    from uni_encoder_tpu_torch.evaluation.kitti import KITTIDepthEvaluator

    etype = MetadataCatalog.get(dataset_name).get("evaluator_type")
    if etype in ("coco_instance", "ade20k_panoptic_seg"):
        raise NotImplementedError(f"the {etype!r} evaluator is not ported yet "
                                  "(ROADMAP Queue 1 item 3: ADE20K and COCO evaluation)")
    if etype == "cityscapes_depth":
        return CityscapesDepthEvaluator(dataset_name)
    if etype == "kitti_depth":
        return KITTIDepthEvaluator(dataset_name)
    if etype == "sem_seg":
        return CityscapesSemSegEvaluator(dataset_name)
    if etype in ("cityscapes_panoptic_seg", "cityscapes_sem_seg", "cityscapes_instance"):
        evals = []
        if task == "semantic":
            evals.append(CityscapesSemSegEvaluator(dataset_name))
        elif task == "instance":
            evals.append(CityscapesInstanceEvaluator(dataset_name))
        else:
            evals.append(CityscapesPanopticEvaluator(dataset_name))
            evals.append(CityscapesSemSegEvaluator(dataset_name))
            evals.append(CityscapesInstanceEvaluator(dataset_name))
        return DatasetEvaluators(evals)
    raise ValueError(f"no evaluator for type {etype!r} (dataset {dataset_name})")


def build_model(cfg, weights: Optional[str] = None, device=None) -> Tuple[torch.nn.Module, object]:
    """The port's UniEncoder in `cfg.model.dtype` on `device` (None: the
    GPU, raising without one), with `weights` loaded: a `.pkl` / `.pth`
    reference file or a port checkpoint directory. Returns the model and the
    `LoadReport` (None without weights); the file's keys the model does not
    own are logged."""
    from uni_encoder_tpu_torch.engine import checkpoint as ckpt
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.model.dtype]
    model = UniEncoder(cfg.model, device=device, dtype=dtype, seed=0, task_seq_len=cfg.input.task_seq_len)
    logger.info(f"Total Params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M")
    if not weights:
        logger.warning("no weights given: evaluating a randomly initialized model")
        return model, None
    if weights.endswith((".pkl", ".pth")):
        state = ckpt.load_reference_state(weights)
    else:
        state = ckpt.load_checkpoint(weights)["model"]
    report = ckpt.load_into(model, state)
    if report.unused:
        logger.warning(f"{len(report.unused)} checkpoint keys the model does not own: {report.unused}")
    logger.info(f"loaded {len(report.loaded)} tensors from {weights}")
    return model, report


def main(argv: Optional[List[str]] = None, timings: Optional[List[Dict]] = None) -> Dict:
    """Evaluate as the command line `argv` asks; returns {"seg_and_depth":
    {"<dataset>/<metric group>": metrics}}. With `timings`, appends one
    record per evaluated image: dataset, loader wait, predict and
    evaluator-process seconds. The TF32 flags an fp32 model turns off are
    restored on return."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--task", default=None, choices=[None, "panoptic", "semantic", "instance"])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    ap.add_argument("--datasets-root", default=None)
    ap.add_argument("--max-images", type=int, default=None, help="debug: cap per-dataset images")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_intermixed_args(argv)

    from uni_encoder_tpu_torch.config import Config, load_config
    from uni_encoder_tpu_torch.device import resolve_device

    cfg = load_config(args.config, args.opts) if (args.config or args.opts) else Config()
    if args.task:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, test=dataclasses.replace(cfg.model.test, task=args.task))
        )
    device = resolve_device(args.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if cfg.model.dtype == "float32":  # evaluate.py:122-123: full fp32 matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        return _evaluate(cfg, args, device, timings)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _evaluate(cfg, args, device, timings: Optional[List[Dict]]) -> Dict:
    from uni_encoder_tpu_torch.data import datasets as dataset_registry
    from uni_encoder_tpu_torch.data.build import build_test_loader
    from uni_encoder_tpu_torch.data.catalog import MetadataCatalog
    from uni_encoder_tpu_torch.data.mappers import TestMapper
    from uni_encoder_tpu_torch.engine.predictor import Predictor
    from uni_encoder_tpu_torch.evaluation.evaluator import inference_on_dataset

    task = cfg.model.test.task
    dataset_registry.register_all(args.datasets_root)
    model, _ = build_model(cfg, args.weights or cfg.model.weights, device)
    predictor = Predictor(cfg, model)

    # ---- dataset list: depth first, then per-task seg (reference :205-214)
    seg_sets = {
        "panoptic": cfg.datasets.seg_test_panoptic,
        "semantic": cfg.datasets.seg_test_semantic,
        "instance": cfg.datasets.seg_test_instance,
    }[task]
    results = {}
    for name in list(cfg.datasets.depth_test) + list(seg_sets):
        meta = MetadataCatalog.get(name)
        etype = meta.get("evaluator_type")
        is_depth = etype in DEPTH_TYPES
        mapper = TestMapper(
            task=task,
            seg_min_size=cfg.input.seg_min_size_test,
            seg_max_size=cfg.input.seg_max_size_test,
            sequence_hw=(192, 640) if etype == "kitti_depth" else (192, 512),
            task_seq_len=cfg.input.task_seq_len,
        )
        try:
            loader = build_test_loader(name, mapper)
        except (FileNotFoundError, KeyError) as e:
            logger.warning(f"skipping {name}: {e}")
            continue
        if args.max_images:
            loader.items = loader.items[: args.max_images]
        if not is_depth:
            thing_ids = sorted(meta.get("thing_dataset_id_to_contiguous_id", {}).values())
            predictor.set_thing_ids(thing_ids, dataset_name=name)
        if is_depth:
            run = predictor.infer_sequence
        elif cfg.model.test.aug_enabled and task == "semantic":
            from uni_encoder_tpu_torch.engine.tta import SemanticTTA

            run = SemanticTTA(
                predictor,
                cfg.model.test.aug_min_sizes,
                cfg.model.test.aug_max_size,
                cfg.model.test.aug_flip,
            )
        else:
            run = predictor.infer_segmentation
        logger.info(f"evaluating {name} ({len(loader)} images, task={task}, device={device})")
        per_image = [] if timings is not None else None
        results[name] = inference_on_dataset(run, loader, build_evaluator(name, task), per_image)
        if timings is not None:
            timings.extend(dict(t, dataset=name) for t in per_image)

    merged = {"seg_and_depth": {}}
    for name, r in results.items():
        for k, v in r.items():
            merged["seg_and_depth"][f"{name}/{k}"] = v
    logger.info("==== results ====")
    for k, v in merged["seg_and_depth"].items():
        logger.info(f"{k}: {v}")
    return merged


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    main()
