"""Training throughput of the PyTorch port (the counterpart of
tools/calc_throughput.py): the real `Trainer.train_step` for `--iters`
iterations on one fixed synthetic batch, the timer started after iteration
4 and both ends fenced with `torch.cuda.synchronize`; one step consumes a
segmentation batch and a sequence batch of `--batch` images each, so

    img/s = (iters - 5) * 2 * batch / elapsed.

The batch is the JAX tool's, drawn from `np.random.RandomState(0)` in its
order: the segmentation images, labels and masks at a quarter of the size,
then the three frames (x 0.1) with intrinsics K (focal 300, principal point
at the centre) and inv_K. Both halves are `--height` x `--width`. Iteration
i draws its random numbers from a generator seeded with i.

    python tools/calc_throughput_torch.py [--config CFG] [--iters 30] [--batch 4]
        [--height 192 --width 512] [--targets 20] [--device cpu]

The GPU is the default (it raises without one); `--device cpu` runs the
port's plain versions of the kernels.
"""

import argparse
import os
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WARMUP_ITERS = 5  # iterations 0..4 run before the timer starts


def synthetic_batches(cfg, batch: int, height: int, width: int, targets: int, device) -> tuple:
    """The JAX tool's fixed (segmentation, sequence) batch for `cfg`, as
    the port's Trainer takes it, on `device`."""
    B, H, W, N = batch, height, width, targets
    rng = np.random.RandomState(0)
    n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
    seg = {
        "images": rng.randn(B, H, W, 3).astype(np.float32),
        "task_tokens": np.ones((B, cfg.input.task_seq_len), np.int64),
        "text_tokens": np.ones((B, n_texts, cfg.model.text_encoder.context_length), np.int64),
        "labels": rng.randint(0, 19, (B, N)).astype(np.int64),
        "masks": rng.rand(B, N, H // 4, W // 4) > 0.5,
        "valid": np.ones((B, N), bool),
    }
    K = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    K[:, 0, 0] = K[:, 1, 1] = 300.0
    K[:, 0, 2], K[:, 1, 2] = W / 2, H / 2
    seq = {k: rng.randn(B, H, W, 3).astype(np.float32) * np.float32(0.1)
           for k in ("images", "prev_images", "next_images")}
    seq["K"], seq["inv_K"] = K, np.linalg.inv(K)
    to = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in d.items()}  # noqa: E731
    return to(seg), to(seq)


def measure(step: Callable[[int], Dict], iters: int, sync: Callable[[], None],
            clock: Callable[[], float] = time.perf_counter) -> Dict:
    """Run `step(i)` for i < `iters`; the timer starts once iteration
    WARMUP_ITERS - 1 has finished (`sync()` first) and stops after the last
    (`sync()` again). Returns the last step's metrics, the elapsed seconds
    and the iterations timed."""
    if iters <= WARMUP_ITERS:
        raise ValueError(f"--iters must be above {WARMUP_ITERS}: the timer starts after iteration {WARMUP_ITERS - 1}")
    t_start = None
    for it in range(iters):
        metrics = step(it)
        if it == WARMUP_ITERS - 1:
            sync()
            t_start = clock()
    sync()
    return {"metrics": metrics, "elapsed_s": clock() - t_start, "timed_iters": iters - WARMUP_ITERS}


def throughput(cfg, batch: int = 4, height: int = 192, width: int = 512, targets: int = 20, iters: int = 30,
               device=None) -> Dict:
    """The tool on `cfg`: a Trainer on `device` (weights random from seed
    0), the fixed batch, `iters` steps. Returns img/s, ms a step, the
    elapsed seconds and the last loss."""
    from uni_encoder_tpu_torch.device import resolve_device
    from uni_encoder_tpu_torch.training.train_step import Trainer

    device = resolve_device(device)
    trainer = Trainer(cfg, device=device)
    state = trainer.init(seed=0)
    seg, seq = synthetic_batches(cfg, batch, height, width, targets, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def step(it):
        gen = torch.Generator(device=device).manual_seed(it)
        return trainer.train_step(state, seg, seq, gen)[1]

    run = measure(step, iters, sync)
    elapsed, timed = run["elapsed_s"], run["timed_iters"]
    return {"img_per_s": timed * 2 * batch / elapsed, "ms_per_step": elapsed / timed * 1e3, "elapsed_s": elapsed,
            "timed_iters": timed, "loss": float(run["metrics"]["loss"])}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--targets", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from uni_encoder_tpu_torch.config import Config, load_config

    cfg = load_config(args.config) if args.config else Config()
    out = throughput(cfg, args.batch, args.height, args.width, args.targets, args.iters, args.device)
    print(f"loss={out['loss']:.4f}")
    print(f"throughput: {out['img_per_s']:.2f} img/s ({out['ms_per_step']:.1f} ms/step)")
    return out


if __name__ == "__main__":
    main()
