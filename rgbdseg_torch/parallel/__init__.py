"""Data and tensor parallelism over torch.distributed (counterpart of
`rgbdseg_tpu/parallel/`): `mesh` (the rank grid, its process groups, the
data-parallel helpers), `multihost` (start-up from torchrun's environment,
each process's rows) and `sharding` (the Megatron rules and `shard_model`).
The JAX package's `data_sharding` and `replicated` name XLA shardings and have
no counterpart: each rank holds its own rows, and DistributedDataParallel
keeps the replicated parameters equal."""

from .mesh import Mesh, make_mesh  # noqa: F401
