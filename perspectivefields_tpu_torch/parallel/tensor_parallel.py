"""Tensor-parallel Linears over the mesh's "model" axis.

The layout is ``sharding.param_shardings``' (JAX's ``_TP_RULES``, which
GSPMD applies to the JAX step). A Linear whose weight a rule marks Shard(0)
becomes a ``ColumnLinear``: this rank's rows of the weight and of the bias,
so its slice of the output features. One marked Shard(1) becomes a
``RowLinear``: this rank's columns of the weight, and the whole bias. A
tensor whose split dim does not divide stays replicated, and its module a
plain ``nn.Linear`` (JAX's fallback). The shards are plain
``nn.Parameter``s, so an optimizer built after the split holds only this
rank's shards of its state, as GSPMD's optax state is split.

The collectives run over the model group, inside autograd functions:

* ``ColumnLinear``: the replicated input enters as it is, and its gradient
  is all-reduced (each rank's rows of the weight give part of it). The
  local output features are all-gathered, so the layer's output is
  replicated, as GSPMD gathers before an op that cannot run split: kv's
  output is laid out [k | v], and MixFFN's depthwise conv reads fc1's
  output. The gathered output's gradient is the same on every rank, and
  each rank keeps its own features' slice of it.
* ``RowLinear``: each rank takes its own features of the replicated input
  (the gradient is all-gathered), the partial products are all-reduced,
  and the replicated bias is added once, after the reduce.

Everything else runs replicated: every rank of a model group computes the
same values and gradients, so the replicated parameters stay bit-equal
across the group. ``state_dict()`` gathers each shard into its full tensor
under its own name, and ``load_state_dict`` takes this rank's slice of a
full tensor, so state dicts and checkpoints are the one-process ones. Both
are collectives over the model group: every rank of it calls them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .sharding import _spec_for

# module attributes that route a weight into a CUDA kernel, which takes
# whole weights
_KERNEL_FLAGS = ("use_kernels", "fused", "fuse_block")


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A parameter's split: dim ``dim`` cut into ``size`` equal slices over
    the ranks of ``group`` (None: the default group); this rank holds
    slice ``rank``."""

    dim: int
    size: int
    rank: int
    group: Any = None

    def local(self, full: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """This rank's slice of ``full`` along ``dim`` (the split dim by
        default), a view."""
        dim = self.dim if dim is None else dim
        per = full.shape[dim] // self.size
        return full.narrow(dim, self.rank * per, per)

    def full_shape(self, shape) -> torch.Size:
        """The whole tensor's shape from a shard's."""
        shape = list(shape)
        shape[self.dim] *= self.size
        return torch.Size(shape)

    def gather(self, t: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
        """Every rank's slice of the group concatenated along ``dim`` (the
        split dim by default): the whole tensor. Not differentiable."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=self.dim if dim is None else dim)


def model_shard(p: torch.Tensor) -> Optional[ModelShard]:
    """The split of a parameter of a ``ColumnLinear`` / ``RowLinear``; None
    for a replicated one."""
    return getattr(p, "model_shard", None)


class _Enter(torch.autograd.Function):
    """The identity on a replicated input; its gradient, a partial sum on
    each rank, all-reduced over the model group."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.shard.group)
        return g, None


class _Gather(torch.autograd.Function):
    """Every rank's slice gathered along ``dim``; the replicated gradient's
    own slice back."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.local(g, ctx.dim).contiguous(), None, None


class _Take(torch.autograd.Function):
    """This rank's slice along ``dim`` of a replicated tensor; the slices'
    gradients gathered back."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard.local(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.gather(g, ctx.dim), None, None


class _Sum(torch.autograd.Function):
    """The partial sums all-reduced over the model group; the replicated
    gradient passes through."""

    @staticmethod
    def forward(ctx, x, shard):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=shard.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _shard_parameter(t: torch.Tensor, shard: Optional[ModelShard], requires_grad: bool) -> nn.Parameter:
    data = t.detach() if shard is None else shard.local(t.detach())
    p = nn.Parameter(data.clone(), requires_grad=requires_grad)
    if shard is not None:
        p.model_shard = shard
    return p


def _gather_state(module, state_dict, prefix, local_metadata) -> None:
    """state_dict() hook: each shard's full tensor under its own name."""
    for leaf, p in module._parameters.items():
        shard = model_shard(p) if p is not None else None
        if shard is not None and prefix + leaf in state_dict:
            state_dict[prefix + leaf] = shard.gather(p.detach())


def _take_state(module, state_dict, prefix, local_metadata, strict, missing_keys,
                unexpected_keys, error_msgs) -> None:
    """load_state_dict() hook: this rank's slice of each full tensor."""
    for leaf, p in module._parameters.items():
        shard = model_shard(p) if p is not None else None
        key = prefix + leaf
        if shard is None or key not in state_dict:
            continue
        full = state_dict[key]
        if full.shape != shard.full_shape(p.shape):
            error_msgs.append(f"size mismatch for {key}: a split parameter loads from its full "
                              f"shape {tuple(shard.full_shape(p.shape))}, got {tuple(full.shape)}")
            continue
        state_dict[key] = shard.local(full)


class _SplitLinear(nn.Module):
    """An ``nn.Linear`` split over the model group (``ColumnLinear`` or
    ``RowLinear``). ``in_features`` / ``out_features`` are the whole
    layer's; a subclass sets ``split_dim``."""

    split_dim: int

    def __init__(self, linear: nn.Linear, size: int, rank: int, group=None):
        super().__init__()
        self.in_features, self.out_features = linear.in_features, linear.out_features
        self.shard = ModelShard(self.split_dim, size, rank, group)
        self.weight = _shard_parameter(linear.weight, self.shard, linear.weight.requires_grad)
        self.bias = None
        if linear.bias is not None:
            bias_shard = self.shard if self.split_dim == 0 else None
            self.bias = _shard_parameter(linear.bias, bias_shard, linear.bias.requires_grad)
        self.register_state_dict_post_hook(_gather_state)
        self.register_load_state_dict_pre_hook(_take_state)

    def full_weights(self) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The whole weight and bias, gathered; their gradients reach each
        rank's own slice."""
        bias = self.bias
        if bias is not None and model_shard(bias) is not None:
            bias = _Gather.apply(bias, self.shard, 0)
        return _Gather.apply(self.weight, self.shard, self.split_dim), bias

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"split dim {self.split_dim} over {self.shard.size} ranks (this rank "
                f"{self.shard.rank})")


class ColumnLinear(_SplitLinear):
    """A Linear split by output features (the weight's and bias's Shard(0));
    a replicated input and a replicated output."""

    split_dim = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(_Enter.apply(x, self.shard), self.weight, self.bias)
        return _Gather.apply(y, self.shard, -1)


class RowLinear(_SplitLinear):
    """A Linear split by input features (the weight's Shard(1)), its bias
    replicated; a replicated input and a replicated output."""

    split_dim = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _Sum.apply(F.linear(_Take.apply(x, self.shard, -1), self.weight), self.shard)
        # the bias in the product's dtype, as F.linear adds it under autocast
        return y if self.bias is None else y + self.bias.to(y.dtype)


def unsplit_ruled(model: nn.Module, size: int) -> list[str]:
    """The names of ``model``'s parameters that ``param_shardings`` splits on
    a model axis of ``size`` but that are held whole."""
    return [name for name, p in model.named_parameters()
            if model_shard(p) is None and not _spec_for(name, p.shape, size).is_replicate()]


def split_linears_(model: nn.Module, size: int, rank: int, group=None) -> nn.Module:
    """Replace, in place, every Linear whose parameters ``param_shardings``
    splits on a model axis of ``size`` by its ``ColumnLinear`` /
    ``RowLinear``, holding slice ``rank`` of ``group``. Raises where the
    model cannot be split: a kernel route is on (kernels take whole
    weights), or a rule names a tensor that is not an ``nn.Linear``'s
    weight with its bias split alike. Returns the model."""
    if size <= 1:
        return model
    on = sorted({f for m in model.modules() for f in _KERNEL_FLAGS if getattr(m, f, False) is True})
    if on:
        raise ValueError(f"a tensor-parallel model runs every kernel off (kernels take whole "
                         f"weights); this one has {', '.join(on)} on")
    owners: dict[str, dict] = {}
    for name, p in model.named_parameters():
        placement = _spec_for(name, p.shape, size)
        if not placement.is_replicate():
            owner, leaf = name.rsplit(".", 1)
            owners.setdefault(owner, {})[leaf] = placement
    for owner, leaves in owners.items():
        linear = model.get_submodule(owner)
        weight = leaves.get("weight")
        if type(linear) is not nn.Linear or weight is None:
            raise ValueError(f"{owner}: the rules split {sorted(leaves)} of a "
                             f"{type(linear).__name__}; only an nn.Linear's weight splits")
        bias = leaves.get("bias")
        bias_ok = linear.bias is None or (bias == weight if weight.dim == 0 else bias is None)
        if not bias_ok:
            raise ValueError(f"{owner}: weight {weight} and bias {bias} do not split as one "
                             "Linear")
        parent, _, attr = owner.rpartition(".")
        cls = ColumnLinear if weight.dim == 0 else RowLinear
        setattr(model.get_submodule(parent), attr, cls(linear, size, rank, group))
    return model


def split_model_(model: nn.Module, mesh) -> nn.Module:
    """``split_linears_`` over the mesh's "model" axis (nothing to do on a
    model axis of 1). Returns the model."""
    if "model" not in mesh.mesh_dim_names or mesh["model"].size() == 1:
        return model
    return split_linears_(model, mesh["model"].size(), mesh.get_local_rank("model"),
                          mesh.get_group("model"))


def gather_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The whole tensor of ``t``, shaped like parameter ``p``'s shard (an
    optimizer moment, a gradient): gathered for a split ``p``, else ``t``."""
    shard = model_shard(p)
    return t if shard is None else shard.gather(t)
