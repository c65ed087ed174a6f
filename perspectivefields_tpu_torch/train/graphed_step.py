"""CUDA-graph replay of the single-process train step, one graph per batch
signature, as a client of ``utils.cuda_graphs`` (the shared rules).
``step(state, batch, body, seed, key)`` runs ``body`` (zero-grad, forward
under autocast, losses, remat backward, clip) or replays a graph of it; the
caller's AdamW update runs eager after it, so a replayed step's numbers are
the eager step's on every path. The step adds:

* its rule: the batch and the model's tensors on the current device, no
  forward or backward (pre-)hook on the model, a submodule or globally, no
  hook on a parameter (the optimizer's run: its step is eager). The caller
  runs a mesh's step eager, counted under ``"mesh"``;
* its signature: the batch's keys, shapes, strides and dtypes, the caller's
  ``key`` (config, loss, compute dtype, clip), the grad, autocast, TF32 and
  deterministic modes and the modules' training flags;
* its warm-up: the first step is a real step, eager on the capture stream;
  a capture first frees the device cache's blocks (the warm-up's) for the
  pool, which then holds a step's intermediates and gradients;
* two graphs a model (the full batch and one more);
* a replay copies the batch in, seeds the graph's own generator (it draws
  the stochastic-depth masks) with the eager step's ``seed``, points each
  ``.grad`` at the graph's gradients and clones the metrics.

Counters: ``COUNTS``. Spans: ``train.graph_replay`` (copy in, replay,
gradients, clones) and ``train.graph_capture``, in ``train.step`` in place
of ``train.forward``, ``.loss``, ``.backward`` and ``.clip``.
"""

from __future__ import annotations

from operator import attrgetter

import torch
from torch.nn.modules import module as _nn_module

from ..utils import cuda_graphs

_training = attrgetter("training")


class _Graph:
    """A captured step: its static batch and metrics, gradients and generator."""

    def __init__(self, graph, static_in: dict, static_out: dict, grads: list, generator):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.grads, self.generator = grads, generator

    def replay(self, batch: dict, seed: int) -> dict[str, torch.Tensor]:
        for key, t in self.static_in.items():
            t.copy_(batch[key])
        self.generator.manual_seed(seed)
        self.graph.replay()
        for p, g in self.grads:
            p.grad = g
        return {key: t.clone() for key, t in self.static_out.items()}


def _listing(model, submodules: list, tensors: list) -> tuple:
    """The hook registries of the model and its submodules; its parameters."""
    hooks = [d for m in (model, *submodules) for d in (
        m._forward_hooks, m._forward_pre_hooks, m._backward_hooks, m._backward_pre_hooks)]
    return hooks, list(model.parameters())


def _rule(st, state, batch, body, seed, key, device) -> str | None:
    hooks, params = st.listed
    if (any(hooks)
            or _nn_module._global_forward_hooks or _nn_module._global_forward_pre_hooks
            or _nn_module._global_backward_hooks or _nn_module._global_backward_pre_hooks
            or any(p._backward_hooks or p._post_accumulate_grad_hooks for p in params)):
        return "hooks"
    if st.devices != {device} or any(not isinstance(t, torch.Tensor) or t.device != device
                                     for t in batch.values()):
        return "other_device"
    return None


def _signature(st, state, batch: dict, body, seed, key: tuple, device) -> tuple:
    return (tuple((k, t.shape, t.stride(), t.dtype) for k, t in batch.items()), key,
            state.model.training, tuple(map(_training, st.submodules)), st.attrs_id,
            torch.is_grad_enabled(),
            torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda"),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.are_deterministic_algorithms_enabled())


def _capture(st, state, batch: dict, body, seed, key, device) -> _Graph:
    """Capture ``body`` on a static copy of ``batch``; the caller replays it."""
    static_in = {k: torch.empty_like(t).copy_(t) for k, t in batch.items()}
    state.optimizer.zero_grad(set_to_none=True)  # the last step's gradients are freed outside
    torch.cuda.empty_cache()  # the warm-up's free blocks, so the pool takes their place
    generator = torch.Generator(device=device)
    params = st.listed[1]
    graph, (static_out, grads) = cuda_graphs.capture_graph(
        st, device, lambda: (body(state, static_in, generator), [p.grad for p in params]),
        (generator,))
    return _Graph(graph, static_in, static_out,
                  [(p, g) for p, g in zip(params, grads) if g is not None], generator)


CACHE = cuda_graphs.Cache(
    "train step", 2, _listing, _rule, _signature, _capture,
    lambda graph, state, batch, body, seed, key, device: graph.replay(batch, seed),
    "train.graph_replay", "train.graph_capture")
COUNTS = CACHE.counts


def step(state, batch: dict, body, seed: int, key: tuple) -> dict[str, torch.Tensor]:
    """The metrics of ``body(state, batch, generator)``, ``generator`` seeded
    with ``seed``, or of the replay of a graph of it where the rules allow."""
    device = batch["image"].device
    reason = cuda_graphs.device_reason(batch["image"])
    if reason is None:
        out, reason = CACHE.call(state.model, state, batch, body, seed, key, device)
        if reason is None:
            return out
    COUNTS.eager[reason] += 1
    generator = torch.Generator(device=device).manual_seed(seed)
    if reason == cuda_graphs.FIRST:  # a real step, and the capture's warm-up
        with cuda_graphs.on_capture_stream(device):
            out = body(state, batch, generator)
        return {k: t.clone() for k, t in out.items()}
    return body(state, batch, generator)
