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
without that flag it raises.

Data parallelism (train.py's `--num-devices`): `--num-devices N` starts N
ranks from this one command (`parallel/launch.py`: processes started with
the `spawn` context, a `file://` rendezvous under `--output-dir`); under
torchrun, which sets RANK / WORLD_SIZE / LOCAL_RANK, each process it starts
is one rank. On CUDA a rank runs on its own card under nccl (N above the
cards visible raises); with `--device cpu` the ranks use gloo. `--batch`
stays the global batch per modality and must divide by N. Every rank runs
the same sampler and mappers and maps only its rows of each global batch
(it advances the mappers' random streams past the others' rows, reading
only their headers), so with the same seeds N ranks train on the batches
of one process; the step is the one-device step at the global batch
(`training/train_step.py`). Rank 0 alone writes the events and the
checkpoints. A rank that fails stops the others and the command exits
non-zero. A missing file is dropped by every rank alike; a file that exists
but cannot be read stops a run of N ranks (one process drops it).

Usage:
  python train_torch.py --config configs/cityscapes_swin_unified.yaml \\
      --output-dir runs/exp1 [--max-iter 1000] [--batch 2] [--device cpu] [--num-devices N] [opts a.b.c=v ...]
  torchrun --nproc-per-node N train_torch.py --config ... [--batch B]
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


def _parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None)
    ap.add_argument("--output-dir", default="runs/default")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="override ims_per_batch: the global batch per modality, divided over the ranks")
    ap.add_argument("--datasets-root", default=None)
    ap.add_argument("--checkpoint-period", type=int, default=5000)
    ap.add_argument("--log-period", type=int, default=20)
    ap.add_argument("--num-devices", type=int, default=None,
                    help="ranks to train on, one a card on CUDA (default 1, or torchrun's WORLD_SIZE)")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    ap.add_argument("opts", nargs="*")
    return ap.parse_intermixed_args(argv)


def _config(args):
    """The Config, and the global batch per modality."""
    from uni_encoder_tpu_torch.config import Config, load_config

    cfg = load_config(args.config, args.opts) if (args.config or args.opts) else Config()
    return cfg, args.batch or max(2, cfg.solver.ims_per_batch // 2)


def main(argv: Optional[List[str]] = None, timings: Optional[List[Dict]] = None):
    """Train as the command line `argv` asks; returns the final TrainState
    (this rank's, in a process group the caller set; None where this call
    started the ranks). With `timings`, each step is fenced by device
    synchronisation and one record per iteration is appended: host seconds
    of the batch (`data_s`), of the step (`step_s`) and of the checkpoint
    written after it (`checkpoint_s`, 0 without one), and on CUDA the peak
    of allocated device memory since the previous record (`peak_gb`; the
    first counts from the caller's last reset, so it holds the model's
    initialisation and cuDNN's benchmarking of a first step), the count
    reset after each."""
    from uni_encoder_tpu_torch.parallel import launch, mesh

    args = _parse(argv)
    cfg, batch = _config(args)
    world = launch.command_world(args.num_devices)
    mesh.check_divides(batch, world)
    return launch.run_command(lambda: _train(args, cfg, batch, timings), _rank_main,
                              argv if argv is not None else sys.argv[1:], world, args.device, args.output_dir)


def _rank_main(argv: List[str]) -> None:
    """One rank started by `main`, in the process group it set."""
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    args = _parse(argv)
    cfg, batch = _config(args)
    _train(args, cfg, batch, None)


def _train(args, cfg, batch: int, timings: Optional[List[Dict]]):
    """The training loop of one rank (of one, without a process group)."""
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
    from uni_encoder_tpu_torch.parallel import mesh
    from uni_encoder_tpu_torch.training.train_step import Trainer

    rank, world = mesh.rank(), mesh.world()
    device = mesh.rank_device(mesh.local_rank(), args.device) if mesh.active() else resolve_device(args.device)
    max_iter = args.max_iter or cfg.solver.max_iter
    local = mesh.check_divides(batch, world)
    mine = range(rank * local, (rank + 1) * local)  # this rank's rows of each global batch

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
        """This rank's rows of the next global batch: the items at its
        positions mapped, the others skipped (their random numbers drawn)."""
        seg, seq = [], []
        taken = {"segmentation": 0, "sequence": 0}
        while taken["segmentation"] < batch or taken["sequence"] < batch:
            kind, item = next(sampler)
            if taken[kind] >= batch:
                continue
            out, mapper = (seg, seg_mapper) if kind == "segmentation" else (seq, seq_mapper)
            try:
                if taken[kind] in mine:
                    out.append(mapper(item))
                else:
                    mapper.skip(item)
                taken[kind] += 1
            except FileNotFoundError as e:  # every rank drops it: `skip` stats each file
                logger.warning(f"skipping missing item: {e}")
            except OSError as e:
                # only the rank that maps the item reads it whole: were it
                # dropped there alone, the ranks' batches would drift apart
                if world > 1:
                    raise RuntimeError(f"rank {rank} of {world}: cannot read a {kind} item ({e}); a data-parallel "
                                       f"run stops here: fix or remove the file") from e
                logger.warning(f"skipping unreadable item: {e}")
        return stack_batch(seg), stack_batch(seq)

    next_batches()  # train.py's init batch (see the module docstring)
    trainer = Trainer(cfg, device=device)
    state = trainer.init(seed=0)
    generator = torch.Generator(device=device).manual_seed(0)

    storage = EventStorage()
    writers = [
        CommonMetricPrinter(max_iter),
        JSONWriter(os.path.join(args.output_dir, "metrics.json")),
        MLflowWriter(args.output_dir, args.checkpoint_period),
    ] if rank == 0 else []
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

            if (it + 1) % args.log_period == 0 and writers:
                # one host read per logging period
                values = torch.stack([metrics[k].float() for k in METRICS]).tolist()
                elapsed = time.perf_counter() - t0
                storage.put_scalars(**dict(zip(METRICS, values)), data_time=t_data / args.log_period,
                                    img_per_s=args.log_period * 2 * batch / elapsed)
                for wr in writers:
                    wr.write(storage)
                t_data, t0 = 0.0, time.perf_counter()
            checkpoint_s = 0.0
            if rank == 0 and ((it + 1) % args.checkpoint_period == 0 or it + 1 == max_iter):
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
