"""Data parallelism over processes, and the (data x model) grid of tensor
parallelism (the port's counterpart of `uni_encoder_tpu/parallel/mesh.py`).

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

For one image split by rows over the ranks (`parallel/spatial.py`) it also
holds the row exchange (`fetch_rows`: the halo rows a rank needs from its
neighbours) and the global max (`all_reduce_max`).

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
holds one rank (but over a grid's group of one rank, where a sum is the
identity, they do not).

Tensor parallelism (`parallel/tensor.py`) splits the ranks into a grid of
D x M (`init_grid(M)`, the JAX `make_mesh(n, model_parallel=M)`): rank r
has data index r // M and model index r % M. The M ranks of a model group
hold the same rows of the global batch and each holds a block of the
sharded parameters; the D ranks of a data group hold the same blocks and
other rows. Every reduction over the batch then runs over the data group
(`data_group()`, `data_rank()`, `data_world()`), which each collective
here takes as `group`; without a grid, or with M = 1, the data group is
the whole world and every reduction is what it was without the grid.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

# gradients are all-reduced in buckets of at most this many bytes
BUCKET_BYTES = 256 << 20
# how long a rank waits for the others (set-up and each collective)
TIMEOUT_S = 600


# the (data x model) grid of `init_grid`, None without one
_GRID: Optional[Dict] = None


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
    global _GRID
    _GRID = None
    if active():
        dist.destroy_process_group()


# ------------------------------------------------------------------- grid
def init_grid(model_parallel: int) -> None:
    """Split the process group's ranks into a grid of world // M data
    indices by M = `model_parallel` model indices (the JAX `make_mesh`'s
    `np.asarray(devices).reshape(n // M, M)`): rank r gets data index
    r // M and model index r % M. Builds every data group (the ranks of one
    model index) and model group (the ranks of one data index) with
    `dist.new_group`, which every rank must call, in the same order. Raises
    unless M divides the world. With M = 1 the data group is the whole
    world, as without a grid."""
    global _GRID
    if not active():
        raise RuntimeError("init_grid needs a process group (init_process_group first)")
    n, m = world(), model_parallel
    if m < 1 or n % m:
        raise ValueError(f"model_parallel {m} does not divide the {n} ranks: give a divisor of {n}")
    d, r = n // m, rank()
    data_groups = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)] if m > 1 else [None]
    model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    _GRID = {"model_parallel": m, "data_index": r // m, "model_index": r % m,
             "data_group": data_groups[r % m], "model_group": model_groups[r // m]}


def _grid() -> Optional[Dict]:
    """The grid, where one is set and its process group is active."""
    return _GRID if _GRID and active() else None


def model_parallel() -> int:
    """M, the ranks of a model group (1 without a grid)."""
    return _grid()["model_parallel"] if _grid() else 1


def data_rank() -> int:
    """This rank's data index: the block of the global batch it holds."""
    return _grid()["data_index"] if _grid() else rank()


def data_world() -> int:
    """D, the ranks of a data group: how many blocks the global batch is
    split into."""
    return world() // model_parallel()


def model_rank() -> int:
    """This rank's model index: the block of each sharded parameter it
    holds."""
    return _grid()["model_index"] if _grid() else 0


def data_group():
    """The group the batch reductions run over (None: the whole world)."""
    return _grid()["data_group"] if _grid() else None


def model_group():
    """The ranks that hold this rank's rows and the other blocks of the
    sharded parameters (None without a grid)."""
    return _grid()["model_group"] if _grid() else None


def group_size(group) -> int:
    """The ranks of `group` (None: the whole world)."""
    return world() if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in `group` (None: the whole world)."""
    return rank() if group is None else dist.get_rank(group)


def _alone(group) -> bool:
    """Whether `group` is a grid's group of one rank, over which a sum is
    the identity (the whole world always runs its collectives)."""
    return group is not None and group_size(group) == 1


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


def shard_batch(batch, rank: Optional[int] = None, world: Optional[int] = None):
    """A rank's rows of a global batch: the contiguous block `rank` of
    `world` along the first axis of every tensor or array of a (nested)
    dict (the counterpart of the JAX `shard_batch` / `batch_shardings`),
    by default this rank's data index of the data world. Raises when a
    batch does not divide by `world`."""
    rank, world = data_rank() if rank is None else rank, data_world() if world is None else world
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    b = check_divides(batch.shape[0], world, "a batch of")
    return batch[rank * b:(rank + 1) * b]


# ------------------------------------------------------------- collectives
def _all_reduce_(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """Reduce `x` over the ranks of `group` (None: all) by `op` (the sum),
    in place."""
    dist.all_reduce(x, op=op, group=group)
    return x


class _SumOverRanks(torch.autograd.Function):
    """y = the sum over the ranks of `group` of x; the gradient of x is the
    sum over those ranks of the gradients of y."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format), dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone(memory_format=torch.contiguous_format), dist.ReduceOp.SUM, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of `group` (None: all) of `x`, with gradients
    (identity without a process group)."""
    if not active() or _alone(group):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverRanks.apply(x, group)
    return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), dist.ReduceOp.SUM, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` of `group` (None: all) stacked along the first axis
    in the group's rank order (each rank's of the same shape), with
    gradients: a zero buffer of one block a rank, this rank's block `x`,
    summed over the ranks."""
    if not active() or _alone(group):
        return x
    blocks = [torch.zeros_like(x)] * group_size(group)
    blocks[group_rank(group)] = x
    return all_reduce_sum(torch.cat(blocks), group)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the ranks of `x` (no gradient; identity
    without a group)."""
    if not active():
        return x
    return _all_reduce_(x.detach().clone(memory_format=torch.contiguous_format), dist.ReduceOp.MAX)


def _row_indices(want) -> np.ndarray:
    """A rank's wanted rows: a (lo, hi) range or a sequence of row indices."""
    if isinstance(want, tuple) and len(want) == 2:
        return np.arange(want[0], want[1])
    return np.asarray(want, dtype=np.int64).reshape(-1)


def fetch_rows(x: torch.Tensor, wants: Sequence, owned: Sequence[Tuple[int, int]], dim: int = 1) -> torch.Tensor:
    """Rows of a tensor split by rows over the ranks, from whichever ranks
    hold them (a collective: every rank calls it with the same `wants` and
    `owned`).

    `owned[r]` = (start, end): the global rows rank r holds, contiguous, the
    ranks in order, covering rows 0 .. H-1 together; `x` is this rank's block
    along `dim`. `wants[r]`: the global rows rank r asks for, a (lo, hi)
    range or a sequence of indices, in the order wanted. Returns this rank's
    rows, `x_global[wants[rank]]` along `dim`; a row outside [0, H) comes back
    as zeros (the padding at the image's edges).

    One sum all-reduce of a buffer that holds, for every rank, only the rows
    it asks for and does not hold (each filled in by its owner, zeros
    elsewhere): a halo of a few rows crosses, never a shard. Without a
    group (one rank holding every row) nothing is exchanged."""
    me, n = rank(), len(owned)
    H = owned[-1][1]
    idx = [_row_indices(w) for w in wants]
    # per asking rank: the positions of its wanted rows that another rank holds
    remote = [np.flatnonzero((i >= 0) & (i < H) & ((i < s) | (i >= e))) for i, (s, e) in zip(idx, owned)]
    offsets = np.cumsum([0] + [len(p) for p in remote])
    start, end = owned[me]
    shape = list(x.shape)
    buf = None
    if offsets[-1]:
        shape[dim] = int(offsets[-1])
        buf = x.new_zeros(shape)
        for r in range(n):
            if r == me:
                continue
            rows = idx[r][remote[r]]
            mine = np.flatnonzero((rows >= start) & (rows < end))
            if len(mine):
                buf.index_copy_(dim, torch.as_tensor(offsets[r] + mine, device=x.device),
                                x.index_select(dim, torch.as_tensor(rows[mine] - start, device=x.device)))
        if n > 1:
            _all_reduce_(buf)
    i = idx[me]
    shape[dim] = len(i)
    out = x.new_zeros(shape)
    local = np.flatnonzero((i >= start) & (i < end))
    if len(local):
        out.index_copy_(dim, torch.as_tensor(local, device=x.device),
                        x.index_select(dim, torch.as_tensor(i[local] - start, device=x.device)))
    if len(remote[me]):
        out.index_copy_(dim, torch.as_tensor(remote[me], device=x.device),
                        buf.narrow(dim, int(offsets[me]), len(remote[me])))
    return out


def all_reduce_gradients(params: Iterable[torch.Tensor], group=None) -> None:
    """Replace each parameter's gradient by its mean over the ranks of
    `group` (None: all), in buckets of at most BUCKET_BYTES (one all-reduce
    per bucket). Parameters without a gradient are skipped: every rank runs
    the same graph, so they are the same on every rank."""
    if not active() or _alone(group):
        return
    grads = [p.grad for p in params if p.grad is not None]
    n = group_size(group)
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for g in grads:
        if not buckets or size + g.numel() * g.element_size() > BUCKET_BYTES or buckets[-1][0].dtype != g.dtype:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel() * g.element_size()
    for bucket in buckets:
        flat = _all_reduce_(torch.cat([g.reshape(-1) for g in bucket]), dist.ReduceOp.SUM, group)
        flat.div_(n)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def mean_over_ranks(values: Dict[str, torch.Tensor], group=None) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of `group` (None: all) of each 0-d tensor of
    `values`, in one all-reduce (unchanged without a process group)."""
    if not active() or _alone(group):
        return values
    keys = list(values)
    stacked = _all_reduce_(torch.stack([values[k].detach().float() for k in keys]), dist.ReduceOp.SUM,
                           group).div_(group_size(group))
    return {k: stacked[i] for i, k in enumerate(keys)}

