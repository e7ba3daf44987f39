"""The (data, model) grid of ranks (counterpart of `rgbdseg_tpu/parallel/mesh.py`)
and the data-parallel helpers that keep a step equal to one process's step over
the global batch.

The JAX package runs one SPMD program over a `Mesh(('data', 'model'))` of
devices and XLA inserts the collectives. The port runs one process per device
(torchrun), so `make_mesh` lays the ranks out in the same grid, rank
`d * model_axis + m`, and gives each rank its process groups: the ranks of its
grid column (`data_group`, the same model index: gradients and batch
statistics are summed there) and of its grid row (`model_group`, the same
data index: the tensor-parallel ranks of `parallel.sharding`).

While a mesh is active (`with active(mesh):`, which the train step and eval
enter), the code that the global batch decides reads it:
- `global_draw`: a random draw of a batch-first shape takes the global batch's
  shape and keeps this rank's rows, so every rank's generator stays in step
  with one process's and the ranks of one data index draw the same numbers;
- `data_sum`: a sum over the data group without gradient (the loss
  denominators, the logged loss, the eval statistics);
- `models.layers.BatchNorm2d` sums its statistics over the data group.
With no mesh active, or a data width of 1, each of them is the single-process
code path, unchanged.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    grid: np.ndarray  # (data, model) ranks, rank = d * model + m
    data_index: int
    model_index: int
    data_group: Optional[object]  # torch.distributed ProcessGroup of this grid column; None in one process
    model_group: Optional[object]  # of this grid row
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.grid.shape[0], "model": self.grid.shape[1]}

    @property
    def data_width(self) -> int:
        return self.grid.shape[0]

    @property
    def model_width(self) -> int:
        return self.grid.shape[1]

    @property
    def world_size(self) -> int:
        return self.grid.size


def mesh_device(device=None) -> torch.device:
    """`device` as given, else `cuda:LOCAL_RANK` (raises without CUDA)."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def rank_grid(n: int, model_axis: int = 1) -> np.ndarray:
    """The (data, model) grid of n ranks, rank d * model_axis + m: the JAX
    mesh's order of its first n devices."""
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model_axis={model_axis}")
    return np.arange(n).reshape(n // model_axis, model_axis)


def make_mesh(num_devices: Optional[int] = None, model_axis: int = 1, device=None) -> Mesh:
    """The (data, model) grid over the process group's ranks (world size 1
    without one). `num_devices` None means the world size; any other value
    raises, since the port runs one process per device. Every rank creates
    every group, in one order, as torch.distributed requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"num_devices={n} but the process group has {world} rank(s): the port runs one process "
                         f"per device (torchrun --nproc_per_node={n})")
    grid = rank_grid(n, model_axis)
    data_group = model_group = None
    if dist.is_initialized():
        for m in range(grid.shape[1]):
            g = dist.new_group(grid[:, m].tolist())
            if rank in grid[:, m]:
                data_group = g
        for d in range(grid.shape[0]):
            g = dist.new_group(grid[d].tolist())
            if rank in grid[d]:
                model_group = g
    d, m = divmod(rank, model_axis)
    return Mesh(grid, d, m, data_group, model_group, mesh_device(device))


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("rgbdseg_torch_mesh", default=None)


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Make `mesh` the active one for the block (None: no mesh)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def data_parallel() -> Optional[Mesh]:
    """The active mesh if its data width is above 1, else None."""
    mesh = _ACTIVE.get()
    return mesh if mesh is not None and mesh.data_width > 1 else None


def global_draw(draw: Callable[[tuple], torch.Tensor], shape: tuple) -> torch.Tensor:
    """`draw(shape)` for a batch-first shape; under data parallelism the draw
    takes the global batch's shape and this rank's rows are kept."""
    mesh = data_parallel()
    if mesh is None:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((b * mesh.data_width,) + tuple(shape[1:]))
    return full[mesh.data_index * b:(mesh.data_index + 1) * b]


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the active mesh's data group, without gradient (`t`
    itself when there is none)."""
    mesh = data_parallel()
    if mesh is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.data_group)
    return out


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a batch-first tensor -> the global batch's rows, on
    every rank of the data group: an all-reduce of zero-padded buffers (Gloo
    has no all-gather for CUDA tensors). Integers travel as float64, exact
    below 2**53."""
    if mesh.data_width == 1:
        return t
    b = t.shape[0]
    full = torch.zeros((b * mesh.data_width,) + tuple(t.shape[1:]), dtype=torch.float64, device=t.device)
    full[mesh.data_index * b:(mesh.data_index + 1) * b] = t.to(torch.float64)
    dist.all_reduce(full, group=mesh.data_group)
    return full.to(t.dtype)


def is_main_process() -> bool:
    """Rank 0, or the only process: the one that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
