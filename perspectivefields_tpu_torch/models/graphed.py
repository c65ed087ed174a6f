"""CUDA-graph replay of a model's inference forward, one graph per input
signature, as a client of ``utils.cuda_graphs`` (the shared rules).
``forward(model, eager, images, generator, rows)`` runs ``eager`` (the
model's own forward) or replays a graph of it. The forward adds:

* its rule: eval mode on the model and every submodule, grad off, no
  ``generator`` or ``rows`` (stochastic depth), no forward (pre-)hook on a
  submodule or globally (the model's own run around it), no parameter split
  over ranks (its forward runs collectives);
* its signature: the input's shape, strides, dtype and device, and the
  inference, autocast and TF32 modes;
* its warm-up: the first call runs eager on the caller's stream, outside
  the lock; the capture runs one more eager call on the capture stream;
* four graphs a model (full batch, tail batch, B=1, one more);
* a replay copies the input in and clones each output (one clone for an
  output under two keys), so a result kept is never written by a later call;
* each kernel module's ``LAUNCHES`` counts under replay as eager: a
  capture's increments are taken back and added on every replay.

Counters: ``COUNTS``. Spans: ``pf.graph_replay`` (copy in, replay, clones)
and ``pf.graph_capture``.
"""

from __future__ import annotations

from operator import attrgetter

import torch
from torch.nn.modules import module as _nn_module

from .. import kernels
from ..utils import cuda_graphs

_training = attrgetter("training")


class _Graph:
    """A captured forward: its static input and outputs, and its launches."""

    def __init__(self, graph, static_in, static_out: dict, launches: list):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.launches = launches

    def replay(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        self.static_in.copy_(images)
        self.graph.replay()
        for mod, n in self.launches:
            mod.LAUNCHES += n
        once = {id(t): t for t in self.static_out.values()}  # an output under two keys: one clone
        clones = {i: t.clone() for i, t in once.items()}
        return {key: clones[id(t)] for key, t in self.static_out.items()}


def _listing(model, submodules: list, tensors: list) -> tuple:
    """The submodules' forward hooks; whether a tensor is split over ranks."""
    hooks = [d for m in submodules for d in (m._forward_hooks, m._forward_pre_hooks)]
    return hooks, any(getattr(t, "model_shard", None) is not None for t in tensors)


def _rule(state, eager, images) -> str | None:
    hooks, split = state.listed
    if split:
        return "split_over_ranks"
    if any(map(_training, state.submodules)):
        return "grad_or_training"
    if any(hooks) or _nn_module._global_forward_hooks or _nn_module._global_forward_pre_hooks:
        return "hooks"
    return None


def _signature(state, eager, images: torch.Tensor) -> tuple:
    return (images.shape, images.stride(), images.dtype, images.device,
            torch.is_inference_mode_enabled(), torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, state.attrs_id)


def _capture(state, eager, images: torch.Tensor) -> _Graph:
    """Warm ``eager`` up on the capture stream, then capture it on a static
    copy of ``images``, the kernels' launch counters left as they were."""
    device = images.device
    static_in = torch.empty_like(images).copy_(images)
    with cuda_graphs.on_capture_stream(device):
        eager(static_in)
    before = [m.LAUNCHES for m in kernels.MODULES]
    try:
        graph, static_out = cuda_graphs.capture_graph(state, device, lambda: eager(static_in))
    finally:
        launches = [(m, m.LAUNCHES - b) for m, b in zip(kernels.MODULES, before)]
        for m, b in zip(kernels.MODULES, before):
            m.LAUNCHES = b
    return _Graph(graph, static_in, static_out, [(m, n) for m, n in launches if n])


CACHE = cuda_graphs.Cache(
    "forward", 4, _listing, _rule, _signature, _capture,
    lambda graph, eager, images: graph.replay(images), "pf.graph_replay", "pf.graph_capture")
COUNTS = CACHE.counts


def forward(model: torch.nn.Module, eager, images: torch.Tensor, generator=None, rows=None):
    """``eager(images, generator, rows)``, or a graph's replay where the rules allow."""
    if model.training or torch.is_grad_enabled():
        reason = "grad_or_training"
    elif generator is not None or rows is not None:
        reason = "generator_or_rows"
    else:
        reason = cuda_graphs.device_reason(images)
    if reason is None:
        out, reason = CACHE.call(model, eager, images)
        if reason is None:
            return out
    COUNTS.eager[reason] += 1
    return eager(images, generator, rows)
