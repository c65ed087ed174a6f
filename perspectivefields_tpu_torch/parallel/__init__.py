"""Multi-process execution: process groups, device meshes, data-parallel
batches and the tensor-parallel layout, whose split Linears training and
``sharded_forward`` run on (port of perspectivefields_tpu/parallel)."""

from .mesh import init_distributed, make_mesh
from .sharding import (
    all_gather_batch,
    batch_rows,
    param_shardings,
    replicate,
    shard_batch,
    sharded_forward,
)
from .tensor_parallel import split_model_

__all__ = [
    "init_distributed",
    "make_mesh",
    "all_gather_batch",
    "batch_rows",
    "param_shardings",
    "replicate",
    "shard_batch",
    "sharded_forward",
    "split_model_",
]
