"""Data-parallel batches and the tensor-parallel forward.

Port of perspectivefields_tpu/parallel/sharding.py.

* **Data parallel (primary).** Each process on the "data" axis takes its
  own rows of the global batch (``shard_batch``) and holds a replica of
  the parameters (``replicate``). Training all-reduces the gradients over
  the data group (``train.train_step``).
* **Tensor parallel (the "model" axis).** The big matrices are stored as
  DTensors sharded Megatron-style, GSPMD's parameter annotations in
  PyTorch: attention q / kv and MixFFN fc1, the decoder's per-scale embeds
  and ConvNeXt's pwconv1 split by output features, attention proj, fc2 and
  pwconv2 by input features. A flax kernel is (in, out) and a torch
  ``Linear.weight`` is (out, in), so JAX's P(None, "model") is Shard(0) here
  and P("model", None) is Shard(1). The output of a column-split layer is
  gathered (redistributed to Replicate) as it leaves the layer, as GSPMD
  all-gathers before an op that cannot run sharded: kv's output is laid
  out [k | v], so a split of it would hand one rank all of k, and MixFFN's
  depthwise conv sits on fc1's output. A row-split layer then reads its
  own slice of the replicated input and its partial sums are reduced.
  Everything else runs replicated.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor


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
    """Each parameter's placement on the mesh's "model" axis."""
    n_model = mesh["model"].size() if "model" in mesh.mesh_dim_names else 1
    return {name: _spec_for(name, p.shape, n_model) for name, p in model.named_parameters()}


def _gather_output(module, args, out):
    return out.redistribute(out.device_mesh, [Replicate()])


def sharded_forward(model: nn.Module, mesh: DeviceMesh):
    """A tensor-parallel inference forward of a PersNet over the mesh.

    Returns (fn, sharded_model). ``sharded_model`` is a copy of ``model``
    built with every kernel off (a DTensor cannot enter a kernel's launch)
    whose parameters are DTensors on the "model" axis, laid out by
    ``param_shardings``. ``fn(images)`` runs this rank's rows of the global
    batch (``shard_batch(mesh, images)``, normalized NHWC) and returns plain
    tensors for those rows; ranks that share a data index return the same
    values (``all_gather_batch`` puts the global batch back together)."""
    from ..models import PersNet

    model_mesh = mesh["model"]
    placements = param_shardings(mesh, model)
    sharded = PersNet(model.cfg).to(next(model.parameters()).device)
    sharded.load_state_dict(model.state_dict())
    sharded.eval().requires_grad_(False)
    for name, p in list(sharded.named_parameters()):
        owner, leaf = name.rsplit(".", 1)
        dt = distribute_tensor(p.detach(), model_mesh, [placements[name]])
        setattr(sharded.get_submodule(owner), leaf, nn.Parameter(dt, requires_grad=False))
    for mod in sharded.modules():
        if isinstance(mod, nn.Linear) and mod.weight.placements[0] == Shard(0):
            mod.register_forward_hook(_gather_output)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> dict[str, torch.Tensor]:
        from torch.distributed.tensor.experimental import implicit_replication

        x = DTensor.from_local(images, model_mesh, [Replicate()], run_check=False)
        # plain constants made inside the forward (phase matrices, ones
        # maps) join the DTensors as replicated
        with implicit_replication():
            out = sharded(x)
        return {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in out.items()}

    return fn, sharded
