"""Tensor (Megatron) parallelism over a mesh's model group (counterpart of
`rgbdseg_tpu/parallel/sharding.py`).

The rules are the JAX package's tables: a Linear under one of the `_COL` names
is column-parallel (its weight split over its outputs, the bias with it), one
under a `_ROW` name row-parallel (the weight split over its inputs, the bias
replicated); everything else is replicated. `megatron_param_specs` names each
parameter's rule as the JAX specs do.

In the JAX package GSPMD inserts the collectives for any consistent layout.
Here `shard_model` does the work: it shards the blocks that carry the pairing,
column-parallel projections into per-head (or per-hidden-unit) work and a
row-parallel projection out, with Megatron's two operators on the model group:
- *f* (`copy_to_model`) before the column-parallel block: the identity
  forward, an all-reduce of the input's gradient backward;
- *g* (`reduce_from_model`) after the row-parallel product: an all-reduce
  forward (then the replicated bias is added), the identity backward.
A block is sharded only where its head count (attention) or hidden width (MLP)
divides by the model width; otherwise it stays replicated, which computes the
same function (Swin-T's stage 0 has 3 heads). The fusion modules' `fc1`/`fc2`
carry the table's names, but dropout sits between them and they stay
replicated; the rules only decide what is distributed.

Per-head tensors that stay replicated (the deformable attention's
`sampling_offsets` and `attention_weights` outputs, Swin's relative-position
bias table) are computed whole on every rank and cut to the rank's heads by
`take_heads`, through *f*, so that their replicated parameters get the full
gradient on every rank. Only all-reduce crosses the ranks: DTensor's
redistributions would need all-gather and reduce-scatter, which Gloo does not
give for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.layers import Linear, promote

# Module names whose Linear weights shard column-parallel / row-parallel (the JAX tables).
_COL = {"query", "key", "value", "q_proj", "k_proj", "v_proj", "value_proj", "mlp_fc1", "fc1"}
_ROW = {"proj", "out_proj", "output_proj", "mlp_fc2", "fc2"}

# Blocks that shard: class name -> (column-parallel children, row-parallel
# children, the attribute holding the head count, None for an MLP (its hidden
# width is the first child's output width)).
_BLOCKS = {
    "WindowAttention": (("query", "key", "value"), ("proj",), "num_heads"),
    "MultiheadAttention": (("q_proj", "k_proj", "v_proj"), ("out_proj",), "num_heads"),
    "DeformableAttention": (("value_proj",), ("output_proj",), "nh"),
    "SwinBlock": (("mlp_fc1",), ("mlp_fc2",), None),
    "DecoderLayer": (("fc1",), ("fc2",), None),
    "EncoderLayer": (("fc1",), ("fc2",), None),
}


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    group: object  # the model group (torch.distributed ProcessGroup)
    index: int  # this rank's model index
    width: int  # model-parallel size


def _all_reduce(t: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=tp.group)
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    return x if tp is None else _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    return x if tp is None else _ReduceFromModel.apply(x, tp)


def local_heads(num_heads: int, tp: Optional[TensorParallel]) -> int:
    return num_heads if tp is None else num_heads // tp.width


def take_heads(t: torch.Tensor, dim: int, tp: Optional[TensorParallel]) -> torch.Tensor:
    """This rank's heads of a per-head tensor computed whole on every rank,
    through f (so the gradient reaching the whole tensor is the full one)."""
    if tp is None:
        return t
    k = t.shape[dim] // tp.width
    return copy_to_model(t, tp).narrow(dim, tp.index * k, k)


class ColumnParallelLinear(Linear):
    """f, then the product with this rank's rows of the weight (and bias)."""

    tp: Optional[TensorParallel] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(copy_to_model(x, self.tp))


class RowParallelLinear(Linear):
    """The product with this rank's columns of the weight, g, then the bias."""

    tp: Optional[TensorParallel] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote(x, self.weight, self.bias)
        y = reduce_from_model(F.linear(x, w), self.tp)
        return y if b is None else y + b


def megatron_param_specs(model: nn.Module) -> dict[str, Optional[str]]:
    """Parameter name -> "col", "row" or None, by the JAX package's rules
    (a Linear's 2-D weight under a `_COL` / `_ROW` name; a `_COL` bias)."""
    specs = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        module, kind = (parts[-2] if len(parts) > 1 else None), parts[-1]
        spec = None
        if p.dim() == 2 and kind == "weight":
            spec = "col" if module in _COL else "row" if module in _ROW else None
        elif p.dim() == 1 and kind == "bias" and module in _COL:
            spec = "col"
        specs[name] = spec
    return specs


def _shard_linear(lin: nn.Linear, cls, dim: int, tp: TensorParallel) -> nn.Linear:
    """A `cls` holding this rank's slice of `lin` along weight dim `dim` (0:
    outputs, with the bias; 1: inputs, the bias whole)."""
    w = lin.weight.detach()
    k = w.shape[dim] // tp.width
    out_f, in_f = (k, w.shape[1]) if dim == 0 else (w.shape[0], k)
    new = cls(in_f, out_f, bias=lin.bias is not None, device=w.device, dtype=w.dtype)
    new.tp = tp
    with torch.no_grad():
        new.weight.copy_(w.narrow(dim, tp.index * k, k))
        if lin.bias is not None:
            new.bias.copy_(lin.bias.detach().narrow(0, tp.index * k, k) if dim == 0 else lin.bias.detach())
    new.train(lin.training)
    return new


def shard_model(model: nn.Module, mesh) -> list[str]:
    """Shard `model` in place over `mesh`'s model group (nothing at width 1);
    returns the names of the sharded blocks. The model keeps `tp_shards`,
    {parameter name: the weight dim it is split along}, and `mesh`."""
    model.mesh = mesh
    model.tp_shards = {}
    if mesh.model_width == 1:
        return []
    tp = TensorParallel(mesh.model_group, mesh.model_index, mesh.model_width)
    sharded = []
    for name, block in list(model.named_modules()):
        layout = _BLOCKS.get(type(block).__name__)
        if layout is None:
            continue
        col, row, heads_attr = layout
        width = getattr(block, heads_attr) if heads_attr else getattr(block, col[0]).out_features
        if width % tp.width:
            continue
        prefix = f"{name}." if name else ""
        for child, cls, dim in [(c, ColumnParallelLinear, 0) for c in col] + [(r, RowParallelLinear, 1) for r in row]:
            lin = getattr(block, child)
            setattr(block, child, _shard_linear(lin, cls, dim, tp))
            model.tp_shards[f"{prefix}{child}.weight"] = dim
            if lin.bias is not None and dim == 0:
                model.tp_shards[f"{prefix}{child}.bias"] = 0
        if heads_attr:
            block.tp = tp
        sharded.append(name)
    return sharded


def gather_shard(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The full tensor of a shard split along `dim` over the model group, on
    every rank: an all-reduce of zero-padded buffers."""
    k = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = k * mesh.model_width
    full = t.new_zeros(shape)
    full.narrow(dim, mesh.model_index * k, k).copy_(t)
    dist.all_reduce(full, group=mesh.model_group)
    return full


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's state_dict with every tensor-parallel shard gathered to its
    full tensor (the same on every rank): a checkpoint that does not depend on
    the topology. Every rank of the model group must call it."""
    shards = getattr(model, "tp_shards", {})
    sd = model.state_dict()
    return {k: gather_shard(v, shards[k], model.mesh) if k in shards else v for k, v in sd.items()}


def local_shard(name: str, full: torch.Tensor, model: nn.Module) -> torch.Tensor:
    """This rank's slice of a full tensor of `name` (itself when replicated)."""
    dim = getattr(model, "tp_shards", {}).get(name)
    if dim is None:
        return full
    mesh = model.mesh
    k = full.shape[dim] // mesh.model_width
    return full.narrow(dim, mesh.model_index * k, k).contiguous()
