"""Training entry point of the PyTorch port (the counterpart of `train.py`).

The loop is train.py's: the balanced segmentation + sequence sampler (1:1)
feeds the two train mappers, each step takes `--batch` items of each kind
through `Trainer.train_step` (the set criterion with the contrastive text
branch, the 7-term monodepth loss, AdamW with 0.1x backbone LR, poly
schedule and the 0.01 whole-model gradient clip), the metrics go to the
console, `metrics.json` and MLflow every `--log-period` steps, and the
weights are saved every `--checkpoint-period` steps and at the last one.

As in train.py:
  * the mappers and the sampler are seeded 0; the first batch drawn goes to
    the trainer's initialisation (in train.py flax's `init` takes it for the
    shapes; here it is only drawn), so the steps see train.py's batches;
  * the images reach the model as float32 in 0..255, the promotion flax
    applies to the mappers' uint8 (the serving Predictor normalises by
    pixel_mean / pixel_std; this difference is train.py's, copied);
  * a checkpoint holds the weights only: the parameters, the BatchNorm
    statistics and the text encoder, no optimizer state;
  * no precision flag is set (evaluate_torch.py turns TF32 off; train.py
    sets nothing).
The step's random draws come from one `torch.Generator` on the device,
seeded 0 (train.py draws `PRNGKey(it)`; the streams cannot match JAX's).
The model runs on the GPU unless `--device cpu` is given; without a GPU and
without that flag it raises. One device only: `--num-devices` above 1
raises (data parallelism is ROADMAP Queue 1 item 8).

Usage:
  python train_torch.py --config configs/cityscapes_swin_unified.yaml \\
      --output-dir runs/exp1 [--max-iter 1000] [--batch 2] [--device cpu] [opts a.b.c=v ...]
"""

import argparse
import logging
import os
import sys
import time
from typing import Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch

logger = logging.getLogger("train_torch")

# train.py's metrics (the JAX trainer's), in metrics.json with data_time and img_per_s
METRICS = ("loss", "loss_seg", "loss_monodepth", "loss_ce", "loss_mask", "loss_dice")
INT_KEYS = ("task_tokens", "text_tokens", "labels")  # int32 from the mappers -> int64


def stack_batch(items: List[Dict]) -> Dict[str, np.ndarray]:
    """train.py's stack_batch on the host: every key but `task`, stacked."""
    keys = items[0].keys()
    return {k: np.stack([it[k] for it in items]) for k in keys if k != "task"}


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A stacked batch as the trainer takes it: uint8 images as float32 in
    0..255, tokens and labels int64, masks and validity bool, K and inv_K
    float32. The `orig_*` frames, which the trainer does not read, stay on
    the host."""
    out = {}
    for k, v in batch.items():
        if k.startswith("orig_"):
            continue
        t = torch.from_numpy(v)
        if v.dtype == np.uint8:
            t = t.to(torch.float32)
        elif k in INT_KEYS:
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


def main(argv: Optional[List[str]] = None, timings: Optional[List[Dict]] = None):
    """Train as the command line `argv` asks; returns the final TrainState.
    With `timings`, each step is fenced by device synchronisation and one
    record per iteration is appended: host seconds of the batch (`data_s`),
    of the step (`step_s`) and of the checkpoint written after it
    (`checkpoint_s`, 0 without one), and on CUDA the peak of allocated
    device memory since the previous record (`peak_gb`; the first counts
    from the caller's last reset, so it holds the model's initialisation
    and cuDNN's benchmarking of a first step), the count reset after
    each."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--output-dir", default="runs/default")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None, help="override ims_per_batch")
    ap.add_argument("--datasets-root", default=None)
    ap.add_argument("--checkpoint-period", type=int, default=5000)
    ap.add_argument("--log-period", type=int, default=20)
    ap.add_argument("--num-devices", type=int, default=None,
                    help="devices to train on; only 1 is ported (data parallelism is not)")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_intermixed_args(argv)

    from uni_encoder_tpu_torch.config import Config, load_config
    from uni_encoder_tpu_torch.data import datasets as dataset_registry
    from uni_encoder_tpu_torch.data.catalog import DatasetCatalog
    from uni_encoder_tpu_torch.data.train_mappers import BalancedSampler, build_train_mappers
    from uni_encoder_tpu_torch.device import resolve_device
    from uni_encoder_tpu_torch.engine import checkpoint as ckpt
    from uni_encoder_tpu_torch.engine.events import (
        CommonMetricPrinter,
        EventStorage,
        JSONWriter,
        MLflowWriter,
    )
    from uni_encoder_tpu_torch.training.train_step import Trainer

    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(f"--num-devices {args.num_devices}: training on more than one device is not "
                                  "ported yet (ROADMAP Queue 1 item 8: data-parallel training with DDP)")
    device = resolve_device(args.device)
    cfg = load_config(args.config, args.opts) if (args.config or args.opts) else Config()
    max_iter = args.max_iter or cfg.solver.max_iter
    batch = args.batch or max(2, cfg.solver.ims_per_batch // 2)  # per modality

    dataset_registry.register_all(args.datasets_root)
    seg_items = []
    seq_items = []
    for name in cfg.datasets.train:
        try:
            items = DatasetCatalog.get(name)
        except (FileNotFoundError, KeyError) as e:
            logger.warning(f"train dataset {name} unavailable: {e}")
            continue
        (seq_items if items and items[0]["type"] == "sequence" else seg_items).extend(items)
    # sequence sets usually registered separately
    for name in ("cityscapes_sequence_crop_full_sequence_train",):
        if not seq_items:
            try:
                seq_items = DatasetCatalog.get(name)
            except (FileNotFoundError, KeyError):
                pass
    if not (seg_items and seq_items):
        raise FileNotFoundError(f"need both segmentation and sequence train data under {args.datasets_root}: "
                                f"found {len(seg_items)} segmentation and {len(seq_items)} sequence items")

    seg_mapper, seq_mapper = build_train_mappers(cfg)
    sampler = iter(BalancedSampler(seg_items, seq_items))

    def next_batches():
        seg, seq = [], []
        while len(seg) < batch or len(seq) < batch:
            kind, item = next(sampler)
            try:
                if kind == "segmentation" and len(seg) < batch:
                    seg.append(seg_mapper(item))
                elif kind == "sequence" and len(seq) < batch:
                    seq.append(seq_mapper(item))
            except (FileNotFoundError, OSError) as e:
                logger.warning(f"skipping unreadable item: {e}")
        return stack_batch(seg), stack_batch(seq)

    trainer = Trainer(cfg, device=device)
    next_batches()  # train.py's init batch (see the module docstring)
    state = trainer.init(seed=0)
    generator = torch.Generator(device=device).manual_seed(0)

    storage = EventStorage()
    writers = [
        CommonMetricPrinter(max_iter),
        JSONWriter(os.path.join(args.output_dir, "metrics.json")),
        MLflowWriter(args.output_dir, args.checkpoint_period),
    ]
    sync = torch.cuda.synchronize if (timings is not None and device.type == "cuda") else (lambda: None)

    try:
        t_data = 0.0
        t0 = time.perf_counter()
        for it in range(max_iter):
            td = time.perf_counter()
            seg_np, seq_np = next_batches()
            seg_b, seq_b = batch_to_device(seg_np, device), batch_to_device(seq_np, device)
            data_s = time.perf_counter() - td
            t_data += data_s

            sync()
            ts = time.perf_counter()
            state, metrics = trainer.train_step(state, seg_b, seq_b, generator)
            sync()
            step_s = time.perf_counter() - ts

            if (it + 1) % args.log_period == 0:
                # one host read per logging period
                values = torch.stack([metrics[k].float() for k in METRICS]).tolist()
                elapsed = time.perf_counter() - t0
                storage.put_scalars(**dict(zip(METRICS, values)), data_time=t_data / args.log_period,
                                    img_per_s=args.log_period * 2 * batch / elapsed)
                for wr in writers:
                    wr.write(storage)
                t_data, t0 = 0.0, time.perf_counter()
            checkpoint_s = 0.0
            if (it + 1) % args.checkpoint_period == 0 or it + 1 == max_iter:
                tc = time.perf_counter()
                ckpt.save_checkpoint(args.output_dir, state.model, step=it + 1)
                checkpoint_s = time.perf_counter() - tc
            if timings is not None:
                record = {"data_s": data_s, "step_s": step_s, "checkpoint_s": checkpoint_s}
                if device.type == "cuda":  # this iteration's peak, then a fresh count for the next
                    record["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
                    torch.cuda.reset_peak_memory_stats(device)
                timings.append(record)
            storage.step()
    finally:
        for wr in writers:
            wr.close()
    logger.info("training done")
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    main()
