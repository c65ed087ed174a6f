"""Multi-process execution: process groups, device meshes, data-parallel
batches and the tensor-parallel parameter layout (port of
perspectivefields_tpu/parallel)."""

from .mesh import init_distributed, make_mesh
from .sharding import (
    all_gather_batch,
    batch_rows,
    param_shardings,
    replicate,
    shard_batch,
    sharded_forward,
)

__all__ = [
    "init_distributed",
    "make_mesh",
    "all_gather_batch",
    "batch_rows",
    "param_shardings",
    "replicate",
    "shard_batch",
    "sharded_forward",
]
