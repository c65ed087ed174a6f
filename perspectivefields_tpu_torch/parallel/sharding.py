"""Data-parallel batches and the tensor-parallel forward.

Port of perspectivefields_tpu/parallel/sharding.py.

* **Data parallel (primary).** Each process on the "data" axis takes its
  own rows of the global batch (``shard_batch``) and holds a replica of
  the parameters (``replicate``). Training all-reduces the gradients over
  the data group (``train.train_step``).
* **Tensor parallel (the "model" axis).** The big matrices are split
  Megatron-style, GSPMD's parameter annotations in PyTorch: attention q / kv
  and MixFFN fc1, the decoder's per-scale embeds and ConvNeXt's pwconv1 by
  output features, attention proj, fc2 and pwconv2 by input features
  (``param_shardings``). A flax kernel is (in, out) and a torch
  ``Linear.weight`` is (out, in), so JAX's P(None, "model") is Shard(0) here
  and P("model", None) is Shard(1). ``tensor_parallel`` holds the split
  Linears and their collectives; training (``train.create_train_state``)
  and the inference forward (``sharded_forward``) run on them. Everything
  else runs replicated.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard


def _groups(mesh: DeviceMesh) -> list:
    return [mesh.get_group(name) for name in mesh.mesh_dim_names]


@torch.no_grad()
def replicate(mesh: DeviceMesh, obj):
    """Make every rank of the mesh hold the mesh's first rank's copy: a
    module's parameters and buffers in place (the module is returned), or a
    tensor (a broadcast copy is returned)."""
    tensors = list(obj.parameters()) + list(obj.buffers()) if isinstance(obj, nn.Module) else [obj.clone()]
    for group in _groups(mesh):
        for t in tensors:
            dist.broadcast(t.data, group=group, group_src=0)
    return obj if isinstance(obj, nn.Module) else tensors[0]


def batch_rows(mesh: DeviceMesh | None, batch_size: int, axis: str = "data") -> slice:
    """This rank's rows of a global batch of ``batch_size`` split over the
    mesh axis (all rows without a mesh). The batch must divide evenly:
    pad it at the serving layer."""
    if mesh is None:
        return slice(0, batch_size)
    n = mesh[axis].size()
    if batch_size % n:
        raise ValueError(f"batch {batch_size} does not divide over the {axis!r} axis of size {n}")
    i = mesh.get_local_rank(axis)
    per = batch_size // n
    return slice(i * per, (i + 1) * per)


def shard_batch(mesh: DeviceMesh, array, axis: str = "data"):
    """This rank's rows of a global batch (leading dim) on the mesh axis."""
    return array[batch_rows(mesh, array.shape[0], axis)]


def all_gather_batch(mesh: DeviceMesh, tensor: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """The global batch from every rank's rows on the mesh axis (the inverse
    of ``shard_batch``)."""
    parts = [torch.empty_like(tensor) for _ in range(mesh[axis].size())]
    dist.all_gather(parts, tensor.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Tensor-parallel rules (state-dict name regex -> placement on "model")
# ---------------------------------------------------------------------------

_TP_RULES = [
    # MixFFN: fc1 split by output features, fc2 by input features
    (r".*mlp\.fc1\.weight", Shard(0)),
    (r".*mlp\.fc1\.bias", Shard(0)),
    (r".*mlp\.fc2\.weight", Shard(1)),
    # attention: q / kv by output features, proj by input features
    (r".*attn\.(q|kv)\.weight", Shard(0)),
    (r".*attn\.(q|kv)\.bias", Shard(0)),
    (r".*attn\.proj\.weight", Shard(1)),
    # decoder per-scale embeds, by output features
    (r".*linear_c[1-4]\.proj\.weight", Shard(0)),
    (r".*linear_c[1-4]\.proj\.bias", Shard(0)),
    # ConvNeXt pointwise MLPs
    (r".*pwconv1\.weight", Shard(0)),
    (r".*pwconv1\.bias", Shard(0)),
    (r".*pwconv2\.weight", Shard(1)),
]


def _spec_for(name: str, shape, n_model: int) -> Placement:
    """A parameter's placement on a model axis of ``n_model``: its rule's
    Shard where the split dim divides evenly, else Replicate (JAX's
    fallback)."""
    if n_model > 1:
        for pattern, spec in _TP_RULES:
            if re.fullmatch(pattern, name):
                if shape[spec.dim] % n_model == 0:
                    return spec
                break
    return Replicate()


def param_shardings(mesh: DeviceMesh, model: nn.Module) -> dict[str, Placement]:
    """Each parameter's placement on the mesh's "model" axis (a split
    model's shards give their own)."""
    n_model = mesh["model"].size() if "model" in mesh.mesh_dim_names else 1
    out = {}
    for name, p in model.named_parameters():
        shard = getattr(p, "model_shard", None)  # tensor_parallel.model_shard
        out[name] = Shard(shard.dim) if shard is not None else _spec_for(name, p.shape, n_model)
    return out


def sharded_forward(model: nn.Module, mesh: DeviceMesh):
    """A tensor-parallel inference forward of a PersNet over the mesh.

    Returns (fn, sharded_model). ``sharded_model`` is a copy of ``model``
    built with every kernel off (a kernel takes whole weights) whose ruled
    Linears are split over the "model" axis by ``param_shardings``
    (``tensor_parallel.split_model_``, the layer training splits with).
    ``fn(images)`` runs this rank's rows of the global batch
    (``shard_batch(mesh, images)``, normalized NHWC) and returns plain
    tensors for those rows; ranks that share a data index return the same
    values (``all_gather_batch`` puts the global batch back together).
    Every rank of the mesh calls it: reading a split ``model``'s state
    dict is a collective."""
    from ..models import PersNet
    from .tensor_parallel import split_model_

    sharded = PersNet(model.cfg).to(next(model.parameters()).device)
    sharded.load_state_dict(model.state_dict())
    split_model_(sharded, mesh)
    sharded.eval().requires_grad_(False)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> dict[str, torch.Tensor]:
        return sharded(images)

    return fn, sharded
