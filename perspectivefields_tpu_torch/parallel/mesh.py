"""Process groups and the (data, model) device mesh.

Port of perspectivefields_tpu/parallel/mesh.py. One process drives one
device (``torchrun --nproc_per_node=N``); ``init_distributed`` joins the
processes into one group and ``make_mesh`` lays them out as a 2-D
(data, model) ``DeviceMesh``: batches split over "data", the
tensor-parallel parameter layout (``sharding.py``) over "model".
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to the default process group (once; a second call
    does nothing).

    coordinator_address: "host:port" (or any init_method URL, such as
    "file:///path") of rank 0's store; num_processes / process_id: the
    world size and this rank. Each one left None is read from torchrun's
    environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK).
    backend: None means NCCL where CUDA is available, else gloo. NCCL
    refuses two ranks on one GPU: pass "gloo" for that.
    """
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    device_type: Optional[str] = None,
    axis_names=("data", "model"),
) -> DeviceMesh:
    """A 2-D (data, model) mesh over the first n_data * n_model ranks.

    Defaults to every rank on "data": the model is far below one card's
    memory, so splitting the batch is the throughput layout; the model axis
    is for the tensor-parallel forward. device_type: None means "cuda" on
    an NCCL group, else "cpu". Call it on every rank."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model > world:
        raise ValueError(f"mesh {n_data}x{n_model} > {world} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = np.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, torch.as_tensor(ranks), mesh_dim_names=tuple(axis_names))
