"""Multi-process start-up and per-process rows (counterpart of
`rgbdseg_tpu/parallel/multihost.py`).

Every process runs the same program, one per device: `initialize()` joins the
process group that torchrun's environment describes, and each process loads
only its rows of every global batch (`host_row_range`, fed to
`data.pipeline.SegmentationDataset.batches(local_rows=...)`).

The JAX package assembles one global array from the processes' rows
(`global_batch_array`); the port has no counterpart of it, because each rank
keeps its own rows and the collectives of `parallel.mesh`, `models.layers`,
`ops.losses` and DistributedDataParallel make the step compute what one
process computes over the global batch.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(backend: Optional[str] = None, device=None) -> bool:
    """Join the process group described by torchrun's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`); returns whether
    a group is set up.

    Nothing happens in a single process (no `RANK` / `WORLD_SIZE` in the
    environment) or when a group already exists. The backend is `backend` if
    given, else NCCL for a CUDA device and Gloo for the CPU (`device`: None or
    "cuda..." means CUDA, "cpu" the CPU). NCCL without CUDA raises: nothing
    switches to Gloo behind the caller's back."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ and "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"torch.distributed environment incomplete: {missing} not set")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if on_cpu else "nccl")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA device; pass --device cpu to run on the CPU over Gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def _rows_for_process(proc_of_data_index: list[int], process_id: int, global_batch: int) -> tuple[int, int]:
    """Data-axis index i owns rows [i*B/D, (i+1)*B/D); a process owns the union
    of its indices' blocks, which must be contiguous, and B must divide by D."""
    d = len(proc_of_data_index)
    if global_batch % d:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {d}")
    rows_per = global_batch // d
    mine = [i for i, p in enumerate(proc_of_data_index) if p == process_id]
    if not mine:
        return (0, 0)
    if mine != list(range(mine[0], mine[-1] + 1)):
        raise ValueError(f"process {process_id} owns non-contiguous data-axis indices {mine}")
    return (mine[0] * rows_per, (mine[-1] + 1) * rows_per)


def host_row_range(global_batch: int, mesh: Mesh) -> tuple[int, int]:
    """Half-open [start, stop) of the global-batch rows this rank loads: its
    data index's block. Every rank of one data index (its row of the grid, the
    tensor-parallel ranks) loads the same rows; ownership goes by the first
    rank of each grid row, as the JAX function decides it by the first device."""
    owners = [int(row[0]) for row in mesh.grid]
    return _rows_for_process(owners, int(mesh.grid[mesh.data_index][0]), global_batch)
