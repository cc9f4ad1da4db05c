"""Evaluation entry point of the PyTorch port (the counterpart of
`evaluate.py`, the reference's `train_net.py --eval-only`).

Mirrors Trainer.test (reference train_net.py:188-257): iterates
DATASETS.DEPTH_TEST, then DATASETS.SEG_TEST_{TASK}, builds the evaluator
for each dataset's evaluator_type, runs single-image inference through the
port's `Predictor` (or `SemanticTTA` with TEST.AUG for the semantic task)
and merges every metric under "seg_and_depth". Datasets: the Cityscapes
panoptic and sequence splits, KITTI, ADE20K (panoptic: PQ + mIoU; semantic:
mIoU; instance: AP over its 100 thing classes) and any COCO-format instance
json registered with `data/datasets/coco.py::register_coco_instances` (AP).
JPEG images (ADE20K, COCO) are decoded by PIL, imported when one is read.

Weights: a reference d2 `.pkl` or torch `.pth`, or a port checkpoint
directory (`uni_encoder_tpu_torch/engine/checkpoint.py`); orbax directories
of the JAX package are not read. The model runs on the GPU unless
`--device cpu` is given; without a GPU and without that flag it raises.

Sharded evaluation (the JAX evaluate.py on several processes): each rank of
a torch.distributed group evaluates its contiguous shard of every dataset
(`data/build.py::inference_shard`), and the evaluators' states are merged
over the ranks before the metrics are computed, so every rank returns the
dataset's metrics. `--num-devices N` starts the N ranks from this command
(as train_torch.py does: one a card under nccl, gloo with `--device cpu`);
under torchrun each process it starts is one rank; a caller that set a
process group runs `main` on each of its ranks. Rank 0 alone logs the
results and writes `--output`.

Usage:
  python evaluate_torch.py --weights model.pth [--config cfg.yaml]
      [--task panoptic] [--device cpu] [--datasets-root DIR] [--num-devices N]
      [--output results.json] [opts a.b.c=v ...]
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
    if etype == "coco_instance":
        from uni_encoder_tpu_torch.evaluation.coco import COCOInstanceEvaluator

        return COCOInstanceEvaluator(dataset_name)
    if etype == "cityscapes_depth":
        return CityscapesDepthEvaluator(dataset_name)
    if etype == "kitti_depth":
        return KITTIDepthEvaluator(dataset_name)
    if etype == "sem_seg":
        return CityscapesSemSegEvaluator(dataset_name)
    if etype == "ade20k_panoptic_seg":
        # reference train_net.py:92-149: COCOPanopticEvaluator + SemSegEvaluator
        # (+ InstanceSegEvaluator over the COCO-format instance json). AP needs
        # predictions made with the instance task token (the reference gates
        # its label remap on 'instance' in task_type), so a panoptic run
        # reports PQ + mIoU only
        from uni_encoder_tpu_torch.evaluation.coco import COCOInstanceEvaluator

        n_things = len(MetadataCatalog.get(dataset_name).get("instance_classes") or []) or 100
        if task == "semantic":
            evals = [CityscapesSemSegEvaluator(dataset_name)]
        elif task == "instance":
            evals = [COCOInstanceEvaluator(dataset_name, num_classes=n_things)]
        else:
            evals = [CityscapesPanopticEvaluator(dataset_name), CityscapesSemSegEvaluator(dataset_name)]
        return DatasetEvaluators(evals)
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


def build_structure(cfg, device=None, dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """The port's UniEncoder for `cfg` in `dtype` on `device` (None: the GPU,
    raising without one), its tensors left uninitialized: no random weights
    are drawn, for a checkpoint to fill every one (`load_into` raises on a
    tensor it does not fill)."""
    from uni_encoder_tpu_torch.device import resolve_device
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    model = UniEncoder(cfg.model, device="meta", dtype=dtype, task_seq_len=cfg.input.task_seq_len)
    return model.to_empty(device=resolve_device(device))


def build_model(cfg, weights: Optional[str] = None, device=None) -> Tuple[torch.nn.Module, object]:
    """The port's UniEncoder in `cfg.model.dtype` on `device` (None: the
    GPU, raising without one), with `weights` loaded: a `.pkl` / `.pth`
    reference file or a port checkpoint directory. Returns the model and the
    `LoadReport` (None without weights); the file's keys the model does not
    own are logged."""
    from uni_encoder_tpu_torch.engine import checkpoint as ckpt
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.model.dtype]
    if weights:
        model = build_structure(cfg, device, dtype)
    else:
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


def _parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--task", default=None, choices=[None, "panoptic", "semantic", "instance"])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    ap.add_argument("--datasets-root", default=None)
    ap.add_argument("--max-images", type=int, default=None, help="debug: cap per-dataset images")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="ranks to evaluate on, one a card on CUDA (default 1, or torchrun's WORLD_SIZE)")
    ap.add_argument("--output", default=None, help="write the results there as JSON (rank 0)")
    ap.add_argument("opts", nargs="*")
    return ap.parse_intermixed_args(argv)


def main(argv: Optional[List[str]] = None, timings: Optional[List[Dict]] = None) -> Optional[Dict]:
    """Evaluate as the command line `argv` asks; returns {"seg_and_depth":
    {"<dataset>/<metric group>": metrics}} (on every rank of a process group
    the caller set; None where this call started the ranks). With
    `timings`, appends one record per image this rank evaluated: dataset,
    loader wait, predict and evaluator-process seconds. The TF32 flags an
    fp32 model turns off are restored on return."""
    import tempfile

    from uni_encoder_tpu_torch.parallel import launch

    args = _parse(argv)
    world = launch.command_world(args.num_devices)
    with tempfile.TemporaryDirectory() as rendezvous:
        return launch.run_command(lambda: _run(args, timings), _rank_main,
                                  argv if argv is not None else sys.argv[1:], world, args.device, rendezvous)


def _rank_main(argv: List[str]) -> None:
    """One rank started by `main`, in the process group it set."""
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    _run(_parse(argv), None)


def _run(args, timings: Optional[List[Dict]]) -> Dict:
    """The evaluation of one rank (of one, without a process group)."""
    from uni_encoder_tpu_torch.config import Config, load_config
    from uni_encoder_tpu_torch.device import resolve_device
    from uni_encoder_tpu_torch.parallel import mesh

    cfg = load_config(args.config, args.opts) if (args.config or args.opts) else Config()
    if args.task:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, test=dataclasses.replace(cfg.model.test, task=args.task))
        )
    device = mesh.rank_device(mesh.local_rank(), args.device) if mesh.active() else resolve_device(args.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if cfg.model.dtype == "float32":  # evaluate.py:122-123: full fp32 matmuls
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        results = _evaluate(cfg, args, device, timings)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if args.output and mesh.rank() == 0:
        import json

        with open(args.output, "w") as f:
            json.dump(results, f, indent=1, default=float)
    return results


def _evaluate(cfg, args, device, timings: Optional[List[Dict]]) -> Dict:
    from uni_encoder_tpu_torch.data import datasets as dataset_registry
    from uni_encoder_tpu_torch.data.build import build_test_loader
    from uni_encoder_tpu_torch.data.catalog import MetadataCatalog
    from uni_encoder_tpu_torch.data.mappers import TestMapper
    from uni_encoder_tpu_torch.engine.predictor import Predictor
    from uni_encoder_tpu_torch.evaluation.evaluator import inference_on_dataset
    from uni_encoder_tpu_torch.parallel import mesh

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
            loader = build_test_loader(name, mapper, mesh.rank(), mesh.world(), limit=args.max_images)
        except (FileNotFoundError, KeyError) as e:
            logger.warning(f"skipping {name}: {e}")
            continue
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
        logger.info(f"evaluating {name} ({len(loader)} images on rank {mesh.rank()} of {mesh.world()}, "
                    f"task={task}, device={device})")
        per_image = [] if timings is not None else None
        results[name] = inference_on_dataset(run, loader, build_evaluator(name, task), per_image)
        if timings is not None:
            timings.extend(dict(t, dataset=name) for t in per_image)

    merged = {"seg_and_depth": {}}
    for name, r in results.items():
        for k, v in r.items():
            merged["seg_and_depth"][f"{name}/{k}"] = v
    if mesh.rank() == 0:
        logger.info("==== results ====")
        for k, v in merged["seg_and_depth"].items():
            logger.info(f"{k}: {v}")
    return merged


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    main()
