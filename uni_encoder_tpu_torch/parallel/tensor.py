"""Tensor parallelism over the model axis of the (data x model) grid (the
port's counterpart of the JAX `param_spec`, `shard_params` and
`params_shardings` of `uni_encoder_tpu/parallel/mesh.py`).

The JAX rule (`param_spec`) shards a 2-D parameter of its own layout over
the `model` axis of the mesh: by its output dimension, P(None, 'model'),
where that dimension is at least `min_dim` wide and a multiple of 8
(column: the FFN up-projections, Swin's qkv), else by its input dimension,
P('model', None), where that one is (row: the FFN down-projections, Swin's
patch-merging reduction, the text encoder's vocabulary); everything else is
replicated. GSPMD then inserts the collectives and keeps the arithmetic of
the unsharded step. Here the rule is applied to each parameter in the JAX
layout (`jax_shape`: an `nn.Linear` weight (out, in) is the JAX Dense kernel
(in, out) transposed, as is the packed attention `in_proj`; an
`nn.Embedding` table has the same layout in both), and `shard_params`
replaces the layers that own a selected parameter, in place, keeping every
state-dict name:

  * `ColumnLinear`: rank m of the model group holds output block m of the
    weight; its output is gathered to the whole width, the bias added after
    (the next op needs the whole width: Swin's qkv is split into q | k | v
    across the heads), or, where a `RowLinear` follows through an
    elementwise activation (a parent's fc1 -> fc2, linear1 -> linear2,
    c_fc -> c_proj), handed on as the block, with the bias's block;
  * `RowLinear`: rank m holds input block m, multiplies its block of the
    input (taken from the whole width, or handed on) and sums over the
    model group; the bias is added once, after the sum;
  * `VocabEmbedding`: rank m holds rows block m of the table; ids outside it
    give zeros, then a sum over the model group;
  * a `MultiheadAttention`'s `in_proj_weight` split by output rows
    (`in_proj_shard`): each projection gathered to the whole width.

A dimension that M does not divide is split into blocks of ceil(n / M), the
last one short (GSPMD's padded layout). Every collective is an
`autograd.Function` whose backward is the conjugate collective (a sum's is
the identity, the identity's is a sum, a gather's is the block, a block's is
a gather), so after `backward()` every replicated parameter's gradient
equals one process's on every rank of a model group (the same bytes where
the ranks' libraries take the same algorithms: `Trainer.train_step`
averages it over the world), and every sharded parameter's gradient is its
block of one process's. The
sharded parameters carry their `Shard` (`shard_of`); `FusedAdamW` takes the
global gradient norm over them and the replicated ones, and its moments of
a sharded parameter are its blocks. `gather_state_dict` assembles the whole
state dict (a collective of the model group).

Every cross-rank operation here is a sum all-reduce over the model group
(`mesh._all_reduce_`): gloo takes CUDA tensors in `all_reduce` only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import mesh

MODEL_AXIS = "model"
COLUMN = (None, MODEL_AXIS)  # P(None, 'model'): the JAX kernel's output dimension
ROW = (MODEL_AXIS, None)  # P('model', None): its input dimension
REPLICATED = ()
# (up, down) children of one parent with only an elementwise activation
# between them: the up-projection's block goes to the down-projection as is
PAIRS = (("fc1", "fc2"), ("linear1", "linear2"), ("c_fc", "c_proj"))


def param_spec(shape: Sequence[int], min_dim: int = 1024) -> Tuple:
    """The JAX `param_spec` on a parameter's shape in the JAX layout: COLUMN,
    ROW or REPLICATED (the PartitionSpec's entries)."""
    if len(shape) == 2 and shape[-1] >= min_dim and shape[-1] % 8 == 0:
        return COLUMN
    if len(shape) == 2 and shape[0] >= min_dim and shape[0] % 8 == 0:
        return ROW
    return REPLICATED


def jax_shape(module: nn.Module, name: str, p: torch.Tensor) -> Tuple[int, ...]:
    """A parameter's shape in the JAX package's layout: an `nn.Linear` weight
    and the packed `in_proj_weight` transposed (Dense kernels are (in, out)),
    every other parameter as it is."""
    if (isinstance(module, nn.Linear) and name == "weight") or name == "in_proj_weight":
        return tuple(p.shape[::-1])
    return tuple(p.shape)


def selection(model: nn.Module, min_dim: int = 1024, extra: Iterable[str] = ()) -> Dict[str, Tuple]:
    """name -> COLUMN or ROW of every parameter the rule shards, plus the
    parameters named in `extra`, which the rule leaves replicated, as
    COLUMN (the JAX dry run's one attention `in_proj`)."""
    extra = set(extra)
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            spec = param_spec(jax_shape(mod, pname, p), min_dim)
            if name in extra:
                if spec != REPLICATED:
                    raise ValueError(f"{name} is sharded {spec} by the rule already")
                spec = COLUMN
                extra.discard(name)
            if spec != REPLICATED:
                out[name] = spec
    if extra:
        raise KeyError(f"no parameter named {sorted(extra)}")
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """Block `index` of `parts` along dimension `dim` (of `size`) of a
    parameter, over the model group `group`."""

    group: object
    index: int
    parts: int
    size: int
    dim: int

    @property
    def lo(self) -> int:
        return min(self.index * -(-self.size // self.parts), self.size)

    @property
    def hi(self) -> int:
        return min(self.lo + -(-self.size // self.parts), self.size)

    def block(self, x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """This rank's block of a whole tensor along `dim` (the shard's)."""
        return x.narrow(self.dim if dim is None else dim, self.lo, self.hi - self.lo)


def shard_of(p: torch.Tensor) -> Optional[Shard]:
    """The `Shard` of a parameter `shard_params` split, else None."""
    return getattr(p, "model_shard", None)


def _sum(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    return mesh._all_reduce_(x, dist.ReduceOp.SUM, shard.group)


def _whole(x: torch.Tensor, shard: Shard, dim: int) -> torch.Tensor:
    """The whole tensor from this rank's block `x` along `dim`: a zero
    buffer of the whole length, the block in place, summed over the group."""
    shape = list(x.shape)
    shape[dim] = shard.size
    buf = x.new_zeros(shape)
    shard.block(buf, dim).copy_(x)
    return _sum(buf, shard)


class _Copy(torch.autograd.Function):
    """Forward the identity, backward the sum over the model group (a
    replicated input into a block's product)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad.clone(memory_format=torch.contiguous_format), ctx.shard), None


class _Reduce(torch.autograd.Function):
    """Forward the sum over the model group (of partial products), backward
    the identity."""

    @staticmethod
    def forward(ctx, x, shard):
        return _sum(x.clone(memory_format=torch.contiguous_format), shard)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """Forward the blocks along the last dimension gathered to the whole
    width, backward this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _whole(x, shard, x.ndim - 1)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.block(grad, grad.ndim - 1).contiguous(), None


class _Split(torch.autograd.Function):
    """Forward this rank's block of the last dimension, backward the blocks'
    gradients gathered to the whole width."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return shard.block(x, x.ndim - 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _whole(grad.contiguous(), ctx.shard, grad.ndim - 1), None


def copy_to_model(x, shard):
    return x if shard.parts == 1 else _Copy.apply(x, shard)


def reduce_from_model(x, shard):
    return x if shard.parts == 1 else _Reduce.apply(x, shard)


def gather_from_model(x, shard):
    return x if shard.parts == 1 else _Gather.apply(x, shard)


def split_to_model(x, shard):
    return x if shard.parts == 1 else _Split.apply(x, shard)


def _block_parameter(p: nn.Parameter, shard: Shard) -> nn.Parameter:
    out = nn.Parameter(shard.block(p.detach()).clone(), requires_grad=p.requires_grad)
    out.model_shard = shard
    return out


class ColumnLinear(nn.Module):
    """An `nn.Linear` split by output features: this rank's block of the
    weight, the bias whole (replicated). `gather`: the output at the whole
    width (bias added after the gather), else this rank's block of it."""

    def __init__(self, linear: nn.Linear, shard: Shard, gather: bool = True):
        super().__init__()
        self.weight = _block_parameter(linear.weight, shard)
        self.bias = linear.bias
        self.shard, self.gather = shard, gather

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.shard)
        if self.gather:
            y = gather_from_model(F.linear(x, self.weight), self.shard)
            return y if self.bias is None else y + self.bias
        return F.linear(x, self.weight, None if self.bias is None else split_to_model(self.bias, self.shard))


class RowLinear(nn.Module):
    """An `nn.Linear` split by input features: this rank's block of the
    weight, the bias whole. `split`: the input comes at the whole width and
    this rank takes its block, else it comes as the block; the partial
    products are summed over the model group, the bias added once."""

    def __init__(self, linear: nn.Linear, shard: Shard, split: bool = True):
        super().__init__()
        self.weight = _block_parameter(linear.weight, shard)
        self.bias = linear.bias
        self.shard, self.split = shard, split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split:
            x = split_to_model(x, self.shard)
        y = reduce_from_model(F.linear(x, self.weight), self.shard)
        return y if self.bias is None else y + self.bias


class VocabEmbedding(nn.Module):
    """An `nn.Embedding` split by rows (the vocabulary): ids outside this
    rank's block look up zeros; the rows are summed over the model group."""

    def __init__(self, embedding: nn.Embedding, shard: Shard):
        super().__init__()
        self.weight = _block_parameter(embedding.weight, shard)
        self.shard = shard

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.shard.lo
        inside = (local >= 0) & (local < self.weight.shape[0])
        rows = F.embedding(local.clamp(0, self.weight.shape[0] - 1), self.weight)
        return reduce_from_model(rows * inside[..., None].to(rows.dtype), self.shard)


def column_in_proj(inputs: Sequence[torch.Tensor], weight: torch.Tensor, bias: torch.Tensor,
                   shard: Shard) -> Tuple[torch.Tensor, ...]:
    """q, k, v of a `MultiheadAttention` whose packed (3E, E) `in_proj_weight`
    is split by output rows: each input's product with this rank's block
    gathered to the whole 3E (once for inputs that are the same tensor),
    the bias added, then its third."""
    E = shard.size // 3
    whole = {}
    out = []
    for i, x in enumerate(inputs):
        if id(x) not in whole:
            whole[id(x)] = gather_from_model(F.linear(copy_to_model(x, shard), weight), shard) + bias
        out.append(whole[id(x)][..., i * E:(i + 1) * E])
    return tuple(out)


def shard_params(model: nn.Module, group, min_dim: int = 1024, extra: Iterable[str] = ()) -> Dict[str, Tuple]:
    """Split the parameters `selection(model, min_dim, extra)` names over
    the model group `group` (this rank keeps its block), in place: their
    `nn.Linear` and `nn.Embedding` modules are replaced by `ColumnLinear`,
    `RowLinear` and `VocabEmbedding`, and a `MultiheadAttention`'s
    `in_proj_weight` by its block; state-dict names stay. Returns the
    selection. A selected parameter of any other kind raises."""
    specs = selection(model, min_dim, extra)
    parts, index = mesh.group_size(group), mesh.group_rank(group)
    modules = dict(model.named_modules())
    new: Dict[str, nn.Module] = {}
    for name, spec in specs.items():
        mname, _, pname = name.rpartition(".")
        mod, p = modules[mname], dict(modules[mname].named_parameters(recurse=False))[pname]
        if isinstance(mod, nn.Linear) and pname == "weight" and mname:
            dim = 0 if spec == COLUMN else 1
            layer = ColumnLinear if spec == COLUMN else RowLinear
            new[mname] = layer(mod, Shard(group, index, parts, p.shape[dim], dim))
        elif isinstance(mod, nn.Embedding) and pname == "weight" and spec == ROW and mname:
            new[mname] = VocabEmbedding(mod, Shard(group, index, parts, p.shape[0], 0))
        elif pname == "in_proj_weight" and spec == COLUMN and hasattr(mod, "in_proj_shard"):
            mod.in_proj_shard = Shard(group, index, parts, p.shape[0], 0)
            mod.in_proj_weight = _block_parameter(p, mod.in_proj_shard)
        else:
            raise NotImplementedError(
                f"{name}: a {type(mod).__name__} parameter of JAX shape {jax_shape(mod, pname, p)} sharded {spec}; "
                f"tensor parallelism splits nn.Linear weights, nn.Embedding rows and an attention's in_proj_weight")
    for parent in {n.rpartition(".")[0] for n in new}:
        for up, down in PAIRS:
            a, b = new.get(f"{parent}.{up}" if parent else up), new.get(f"{parent}.{down}" if parent else down)
            if isinstance(a, ColumnLinear) and isinstance(b, RowLinear) and a.shard.size == b.shard.size:
                a.gather, b.split = False, False
    for mname, layer in new.items():
        parent, _, child = mname.rpartition(".")
        setattr(modules[parent], child, layer)
    return specs


@torch.no_grad()
def gather_param(p: torch.Tensor, x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole tensor of which `x` (default: the parameter `p` itself, or
    its gradient or moment, shaped like it) is this rank's block; `x`
    itself where `p` is replicated. A collective of `p`'s model group."""
    x = p.detach() if x is None else x.detach()
    shard = shard_of(p)
    return x if shard is None or shard.parts == 1 else _whole(x.contiguous(), shard, shard.dim)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every sharded parameter whole, under the
    same names (a collective of the model group: every rank calls it)."""
    return {name: gather_param(t) for name, t in model.state_dict(keep_vars=True).items()}


def whole_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """The shape of the whole parameter of which `p` is a block (or is)."""
    shard = shard_of(p)
    if shard is None:
        return tuple(p.shape)
    return tuple(shard.size if d == shard.dim else n for d, n in enumerate(p.shape))
