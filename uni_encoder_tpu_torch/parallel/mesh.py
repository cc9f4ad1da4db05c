"""Data parallelism over processes (the port's counterpart of
`uni_encoder_tpu/parallel/mesh.py`).

The JAX trainer is one GSPMD program over a mesh whose `data` axis shards
the global batch, with the state replicated; every reduction over the batch
axis is global, so a step on N devices is the one-device step at the global
batch. PyTorch's idiom is one process per device (a rank), each holding a
replica and its rows of the global batch. Every reduction over the batch
that the step computes is made global here, as a sum over the ranks:

  * the gradients (`all_reduce_gradients`: bucketed, then the mean);
  * the train-mode BatchNorm statistics (SyncBN, `models/layers.py`);
  * the criterion's normalizers and its query-text contrastive loss over
    the global batch (`training/criterion.py`);
  * `m_sparsity`'s static threshold, count and `all` (`training/monodepth.py`);
  * the reported metrics (`mean_over_ranks`).

Each rank's loss is its share of the global loss: the mean over the ranks of
the ranks' losses is the global loss, and the mean over the ranks of their
gradients is the global-batch gradient. Collectives that a loss runs
through carry gradients: the backward of a sum over the ranks is the sum
over the ranks of the gradients.

Every cross-rank reduction is a sum all-reduce (an all-gather is a
zero-padded buffer summed): with the gloo backend only `all_reduce` and
`broadcast` are sure to take CUDA tensors. The backend is nccl on CUDA, one
rank per card, and gloo on the CPU.

Without a process group `rank()` is 0, `world()` is 1 and every collective
here is the identity; with one, the collectives run even when the group
holds one rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, List, Optional, Union

import torch
import torch.distributed as dist

# gradients are all-reduced in buckets of at most this many bytes
BUCKET_BYTES = 256 << 20
# how long a rank waits for the others (set-up and each collective)
TIMEOUT_S = 600


def active() -> bool:
    """Whether a process group is set (the collectives below then run)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def local_rank() -> int:
    """This process's index among the ranks of its host: `LOCAL_RANK` where a
    launcher such as torchrun set it, else the rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def default_backend(device: Union[str, torch.device]) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(backend: str, rank: int, world: int, init_method: str,
                       timeout_s: float = TIMEOUT_S) -> None:
    """Join a process group of `world` ranks as `rank` (`init_method`: a
    `file://` path or `tcp://host:port` every rank is given, or `env://`).
    Raises if the group cannot be set up; under nccl the rank's card is made
    the current device first."""
    if active():
        raise RuntimeError("a process group is already set")
    if backend == "nccl":
        torch.cuda.set_device(rank_device(int(os.environ.get("LOCAL_RANK", rank))))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def destroy_process_group() -> None:
    if active():
        dist.destroy_process_group()


def rank_device(local_rank: int, device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device of a rank: `cuda:<local_rank>` by default or for a bare
    "cuda"; the CPU, or a card given with its index, as asked."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank)


def check_num_devices(n: int, device: Union[str, torch.device], visible: Optional[int] = None) -> None:
    """Raise unless `n` ranks can run on `device`'s kind: at most one rank a
    card on CUDA (`visible`: the cards visible, by default
    torch.cuda.device_count())."""
    if n < 1:
        raise ValueError(f"--num-devices {n}: give 1 or more")
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count() if visible is None else visible
        if n > visible:
            raise ValueError(f"--num-devices {n} asks for {n} CUDA devices, but {visible} are visible: "
                             f"give --num-devices {visible} or less, or --device cpu")


def check_divides(batch: int, n: int, what: str = "--batch") -> int:
    """The rows of `batch` each of `n` ranks holds; raises unless `n`
    divides `batch` (train.py's assertion on the data axis)."""
    if batch % n:
        raise ValueError(f"{what} {batch} (the global batch per modality) does not divide over {n} ranks: "
                         f"give a multiple of {n} as {what}, or another --num-devices")
    return batch // n


def shard_batch(batch, rank: int, world: int):
    """A rank's rows of a global batch: the contiguous block `rank` of
    `world` along the first axis of every tensor or array of a (nested)
    dict (the counterpart of the JAX `shard_batch` / `batch_shardings`).
    Raises when a batch does not divide by `world`."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    b = check_divides(batch.shape[0], world, "a batch of")
    return batch[rank * b:(rank + 1) * b]


# ------------------------------------------------------------- collectives
def _all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """Sum `x` over the ranks, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


class _SumOverRanks(torch.autograd.Function):
    """y = the sum over the ranks of x; the gradient of x is the sum over
    the ranks of the gradients of y."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone(memory_format=torch.contiguous_format))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `x`, with gradients (identity without a
    group)."""
    if not active():
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverRanks.apply(x)
    return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format))


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` stacked along the first axis in rank order (each
    rank's of the same shape), with gradients: a zero buffer of `world`
    blocks, this rank's block `x`, summed over the ranks."""
    if not active():
        return x
    blocks = [torch.zeros_like(x)] * world()
    blocks[rank()] = x
    return all_reduce_sum(torch.cat(blocks))


def all_reduce_gradients(params: Iterable[torch.Tensor]) -> None:
    """Replace each parameter's gradient by its mean over the ranks, in
    buckets of at most BUCKET_BYTES (one all-reduce per bucket). Parameters
    without a gradient are skipped: every rank runs the same graph, so they
    are the same on every rank."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    n = world()
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for g in grads:
        if not buckets or size + g.numel() * g.element_size() > BUCKET_BYTES or buckets[-1][0].dtype != g.dtype:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel() * g.element_size()
    for bucket in buckets:
        flat = _all_reduce_(torch.cat([g.reshape(-1) for g in bucket]))
        flat.div_(n)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def mean_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each 0-d tensor of `values`, in one
    all-reduce (unchanged without a group)."""
    if not active():
        return values
    keys = list(values)
    stacked = _all_reduce_(torch.stack([values[k].detach().float() for k in keys])).div_(world())
    return {k: stacked[i] for i, k in enumerate(keys)}

