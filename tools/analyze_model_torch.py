"""Model analysis of the PyTorch port (the counterpart of
tools/analyze_model.py): parameters, FLOPs, activation memory and speed of
the segmentation forward at a fixed input size (zeros: one image and the
task prompt's tokens), in the config's dtype (`model.dtype`).

- param: the parameters of the modules the segmentation forward runs (the
  backbone, the pixel decoder, the query decoder and the task MLP: the tree
  the JAX tool's `init` builds), summed by the first two components of
  their names; TOTAL is the JAX tool's total. The sequence heads are
  listed apart.
- flop: `torch.utils.flop_counter.FlopCounterMode` over one forward
  (recording autograd, as its module hooks need): an operator count (matrix products, convolutions, attention), not XLA's
  cost analysis, which also counts elementwise work and the deformable
  sampling.
- activation: the forward's peak memory on the card beyond the weights
  (`reset_peak_memory_stats`, then `max_memory_allocated`); not measured
  on the CPU.
- speed: ms an image over `--iters` forwards after one warm-up, fenced with
  `torch.cuda.synchronize`, under `torch.inference_mode`.

    python tools/analyze_model_torch.py [--config CFG] [--tasks flop param activation speed]
        [--height 512 --width 1024] [--iters 20] [--device cpu]

The GPU is the default (it raises without one).
"""

import argparse
import os
import sys
import time
from typing import Dict, Optional, Sequence

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TASKS = ("flop", "param", "activation", "speed")
# the modules forward_segmentation runs, by their names' prefixes
SEGMENTATION_MODULES = ("backbone.", "sem_seg_head.pixel_decoder.", "sem_seg_head.predictor.", "task_mlp.")


def param_table(model) -> Dict[str, int]:
    """Parameters of the segmentation forward's modules, summed by the first
    two components of their names."""
    agg: Dict[str, int] = {}
    for name, p in model.named_parameters():
        if name.startswith(SEGMENTATION_MODULES):
            key = ".".join(name.split(".")[:2])
            agg[key] = agg.get(key, 0) + p.numel()
    return agg


def analyze(cfg, tasks: Sequence[str] = ("flop", "param"), height: int = 512, width: int = 1024, iters: int = 20,
            device=None) -> Dict:
    """The tool on `cfg`, the model's weights random from seed 0: a dict
    with each task's numbers and the number of forwards it ran."""
    from uni_encoder_tpu_torch.device import resolve_device
    from uni_encoder_tpu_torch.models.oneformer import UniEncoder

    device = resolve_device(device)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.model.dtype]
    model = UniEncoder(cfg.model, device=device, dtype=dtype, seed=0, task_seq_len=cfg.input.task_seq_len)
    out: Dict = {"forwards": 0}
    if "param" in tasks:
        table = param_table(model)
        out["params"] = table
        out["params_total"] = sum(table.values())
        out["params_sequence_heads"] = sum(p.numel() for n, p in model.named_parameters()
                                           if not n.startswith(SEGMENTATION_MODULES))
    if not set(tasks) - {"param"}:
        return out
    images = torch.zeros(1, height, width, 3, dtype=dtype, device=device)
    tokens = torch.zeros(1, cfg.input.task_seq_len, dtype=torch.int64, device=device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def forward(mode=torch.inference_mode):
        out["forwards"] += 1
        with mode():
            return model.forward_segmentation(images, tokens)

    if "flop" in tasks:
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
        with counter:
            # with grad: the counter's module hooks need an autograd graph
            # wherever a module's input requires grad (a parameter's view)
            forward(torch.enable_grad)
        out["flops"] = counter.get_total_flops()
        out["flops_by_module"] = {k: sum(v.values()) for k, v in counter.get_flop_counts().items()
                                  if k.count(".") <= 1 and k != "Global"}
    if "activation" in tasks and cuda:
        sync()
        weights = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        forward()
        sync()
        out["activation_peak_bytes"] = torch.cuda.max_memory_allocated() - weights
    if "speed" in tasks:
        forward()  # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            forward()
        sync()
        out["ms_per_img"] = (time.perf_counter() - t0) / iters * 1e3
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--tasks", nargs="+", default=["flop", "param"], choices=TASKS)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from uni_encoder_tpu_torch.config import Config, load_config

    cfg = load_config(args.config) if args.config else Config()
    out = analyze(cfg, args.tasks, args.height, args.width, args.iters, args.device)
    if "param" in args.tasks:
        print("\n== parameters ==")
        for k, v in sorted(out["params"].items(), key=lambda kv: -kv[1]):
            print(f"{k:60s} {v / 1e6:10.3f} M")
        print(f"{'TOTAL':60s} {out['params_total'] / 1e6:10.3f} M")
        print(f"{'(sequence heads, not in TOTAL)':60s} {out['params_sequence_heads'] / 1e6:10.3f} M")
    if "flop" in args.tasks:
        print("\n== operator FLOP count (torch.utils.flop_counter, segmentation forward) ==")
        for k, v in sorted(out["flops_by_module"].items(), key=lambda kv: -kv[1]):
            print(f"{k:60s} {v / 1e9:10.2f} GFLOP")
        print(f"flops:            {out['flops'] / 1e9:.2f} GFLOP")
    if "activation" in args.tasks:
        peak = out.get("activation_peak_bytes")
        print(f"\npeak activation memory: {'not measured on the CPU' if peak is None else f'{peak / 1e9:.3f} GB'}")
    if "speed" in args.tasks:
        dt = out["ms_per_img"]
        print(f"\n== speed == {dt:.2f} ms/img ({1e3 / dt:.2f} img/s) at {args.height}x{args.width}")
    return out


if __name__ == "__main__":
    main()
