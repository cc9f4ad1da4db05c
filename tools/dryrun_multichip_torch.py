"""Tensor-parallel dry run of the PyTorch port: the counterpart of the micro
part of `__graft_entry__.py::dryrun_multichip`.

    python tools/dryrun_multichip_torch.py N [--device cpu] [--timeout S]

N ranks on a grid of (N / M) data x M model indices (`mesh.init_grid`), M
= 2 when N is even, else 1, each taking one full training step of
`Trainer.train_step` (set criterion, monodepth loss, AdamW, clip, poly LR)
on the micro config `tiny_config()` (this file's copy of the JAX dry run's
`_tiny_config`), random weights from seed 0:

  * the parameters the JAX rule selects at `min_dim` 256 (the decoder FFN
    kernels, the text encoder's vocabulary, ...) plus exactly one attention
    `in_proj` (`IN_PROJ`, the one the JAX dry run adds: the first `in_proj`
    leaf of its params tree in key order,
    `predictor/class_dec_0/multihead_attn/in_proj`) split over the model
    axis (`parallel/tensor.py::shard_params`), everything else replicated;
  * the JAX dry run's batch (`np.random.RandomState(0)` in its order), B =
    max(2, N / M) images a modality, split over the data axis; the step's
    draws from a generator seeded 1, the same on every rank; the step with
    deterministic algorithms only (`Trainer(deterministic=True)`: no
    cuDNN benchmark of every convolution on the card's first step).

It prints the coverage (column-sharded, row-sharded, of how many
parameters), the step's collectives (calls and MB over the model group, the
data group and the whole world: the replicated gradients' mean) and, last, the
JAX dry run's line `dryrun_multichip(n=N, mesh=(D, M)): loss=... seg=...
mono=...`; it raises unless the loss is finite and the step count is 1.

Sizes: the JAX dry run's 32 x 32 images, but 64 x 64 where a data rank
holds one image (N >= 4 here): one 32 x 32 image leaves a GroupNorm group of
the depth decoder a single value, which torch refuses in training where the
JAX copy computes (a rank's batch of one at tiny sizes). The normalization
is not changed.

Ranks: `parallel/launch.py::spawn`, nccl with one rank a card when N cards
are visible, else N gloo ranks sharing card 0; `--device cpu`, gloo on the
CPU. The card is the default (raises without one). It has no counterpart
of the JAX dry run's production-width compile: `chip_smoke.py`'s phase
`tensor_parallel` takes the production-width step at the production rule.
"""

import argparse
import math
import os
import sys
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MIN_DIM = 256
IN_PROJ = "sem_seg_head.predictor.class_transformer.decoder.layers.0.multihead_attn.in_proj_weight"
TARGETS = 4  # padded targets an image, 3 of them valid
STEP_SEED = 1


def tiny_config():
    """The JAX dry run's `_tiny_config`: every width minimized, 1 block a
    Swin stage, 2 disparity scales."""
    from uni_encoder_tpu_torch import config as C

    swin = C.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8))
    of = C.OneFormerConfig(num_object_queries=8, dec_layers=2, class_dec_layers=1, dim_feedforward=256, hidden_dim=64,
                           train_num_points=64)
    head = C.SemSegHeadConfig(num_classes=19, transformer_enc_layers=1, convs_dim=64, mask_dim=64)
    text = C.TextEncoderConfig(width=32, num_layers=1, proj_num_layers=1, n_ctx=2, vocab_size=512)
    model = C.ModelConfig(backbone=C.BackboneConfig(name="swin", swin=swin), sem_seg_head=head, one_former=of,
                          text_encoder=text, is_train=True, num_depth_scales=2)
    return C.Config(model=model, solver=C.SolverConfig(ims_per_batch=8))


def grid(n: int):
    """(D, M): the data and model axes of n ranks."""
    m = 2 if n % 2 == 0 and n > 1 else 1
    return n // m, m


def batches(cfg, B: int, H: int, W: int):
    """The JAX dry run's segmentation and sequence batches of B images."""
    rng = np.random.RandomState(0)
    n_texts = cfg.model.one_former.num_object_queries - cfg.model.text_encoder.n_ctx
    seg = {"images": rng.randn(B, H, W, 3).astype(np.float32),
           "task_tokens": np.ones((B, cfg.input.task_seq_len), np.int64),
           "text_tokens": np.ones((B, n_texts, cfg.model.text_encoder.context_length), np.int64),
           "labels": rng.randint(0, 19, (B, TARGETS)).astype(np.int64),
           "masks": rng.rand(B, TARGETS, H // 4, W // 4) > 0.5,
           "valid": np.asarray([[True, True, True, False]] * B)}
    K = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    K[:, 0, 0] = K[:, 1, 1] = 50.0
    K[:, 0, 2], K[:, 1, 2] = W / 2, H / 2
    seq = {k: (rng.randn(B, H, W, 3) * 0.1).astype(np.float32) for k in ("images", "prev_images", "next_images")}
    seq["K"], seq["inv_K"] = K, np.linalg.inv(K).astype(np.float32)
    return seg, seq


def sizes(n: int):
    """(B, side): the global batch a modality and the image side."""
    D, _ = grid(n)
    B = max(2, D)
    return B, 32 if B // D >= 2 else 64


def rank_main(out_dir: str, n: int, device: str) -> None:
    """One rank: the grid, the sharded micro model, its rows, one step;
    rank 0 saves what the parent prints."""
    from uni_encoder_tpu_torch.parallel import mesh, tensor
    from uni_encoder_tpu_torch.training.train_step import Trainer

    D, M = grid(n)
    mesh.init_grid(M)
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = mesh.rank_device(mesh.local_rank()) if torch.distributed.get_backend() == "nccl" \
            else torch.device("cuda", 0)
    cfg = tiny_config()
    trainer = Trainer(cfg, device=dev, deterministic=True)
    model = trainer.build_model(seed=0)
    specs = tensor.shard_params(model, mesh.model_group(), MIN_DIM, (IN_PROJ,))
    state = trainer.init(model=model)
    B, side = sizes(n)
    seg, seq = ({k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in mesh.shard_batch(b).items()}
                for b in batches(cfg, B, side, side))

    counts = {"model": [0, 0], "data": [0, 0], "world": [0, 0]}
    all_reduce = mesh._all_reduce_

    def counted(x, *args):
        group = args[1] if len(args) > 1 else None
        key = "world" if group is None else "model" if group is mesh.model_group() else "data"
        counts[key][0] += 1
        counts[key][1] += x.numel() * x.element_size()
        return all_reduce(x, *args)

    mesh._all_reduce_ = counted
    try:
        _, metrics = trainer.train_step(state, seg, seq, torch.Generator().manual_seed(STEP_SEED))
    finally:
        mesh._all_reduce_ = all_reduce
    if mesh.rank() == 0:
        params = list(state.model.named_parameters())
        torch.save({"mesh": (D, M), "batch": B, "side": side, "local_batch": int(seg["images"].shape[0]),
                    "step": state.step, "metrics": {k: float(v) for k, v in metrics.items()},
                    "column": sum(s == tensor.COLUMN for s in specs.values()),
                    "row": sum(s == tensor.ROW for s in specs.values()), "sharded": sorted(specs),
                    "params": len(params),
                    "sharded_elements": sum(math.prod(tensor.whole_shape(p)) for _, p in params if tensor.shard_of(p)),
                    "elements": sum(math.prod(tensor.whole_shape(p)) for _, p in params),
                    "collectives": {k: {"calls": c, "mb": b / 1e6} for k, (c, b) in counts.items()}},
                   os.path.join(out_dir, "result.pt"))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", type=int, help="ranks")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--timeout", type=float, default=900.0, help="seconds the ranks may take")
    args = parser.parse_args(argv)
    from uni_encoder_tpu_torch.parallel import launch

    device = torch.device(args.device).type
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu to run on the CPU")
    backend = "nccl" if device == "cuda" and torch.cuda.device_count() >= args.n else "gloo"
    # the ranks' deterministic steps need cuBLAS's workspace fixed before their first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with tempfile.TemporaryDirectory() as work:
        launch.spawn(rank_main, args.n, (work, args.n, device), backend=backend, rendezvous_dir=work,
                     timeout_s=args.timeout)
        res = torch.load(os.path.join(work, "result.pt"), weights_only=False)
    res["backend"] = backend
    m = res["metrics"]
    if not math.isfinite(m["loss"]) or res["step"] != 1:
        raise AssertionError(f"dry run: loss {m['loss']}, step {res['step']}")
    D, M = res["mesh"]
    print(f"TP coverage: {res['column']} column-sharded + {res['row']} row-sharded kernels of {res['params']} params "
          f"({res['sharded_elements']} of {res['elements']} elements; FFN up/down, vocab embed, attn in_proj); "
          f"rest replicated, batch split over the data axis", flush=True)
    c = res["collectives"]
    print("collectives in the step (a rank): " + "; ".join(
        f"{k} {'' if k == 'world' else 'group '}{c[k]['calls']} all-reduces, {c[k]['mb']:.3f} MB"
        for k in ("model", "data", "world")) + f" ({backend})", flush=True)
    print(f"step {res['step']} on mesh ({D}, {M}): global batch {res['batch']} a modality at "
          f"{res['side']}x{res['side']}, {res['local_batch']} a data rank, device {device}", flush=True)
    print(f"dryrun_multichip(n={args.n}, mesh=({D}, {M})): loss={m['loss']:.4f} seg={m['loss_seg']:.4f} "
          f"mono={m['loss_monodepth']:.4f}", flush=True)
    return res


if __name__ == "__main__":
    main()
