"""CUDA-graph replay of the single-process train step, one graph per batch
signature.

An eager step of the trainer makes ~8,900 kernel launches from Python,
most of them for the forward under autocast, the losses, the remat
backward and the clip; a replay of a captured CUDA graph of that work
makes one. ``step(state, batch, body, seed, key)`` runs ``body`` (the
train step's work up to the AdamW update) as it is, or replays a graph of
it captured earlier. The update runs eager after it, as the caller builds
it, so a replayed step's numbers are the eager step's on every path.
The JAX package runs its step as one ``jax.jit`` program per shape; this is
the same idea on the card. ``models.graphed`` does it for the inference
forward, under rules that exclude training.

A step replays only if all of these hold, each read from the call:

* the batch's tensors and the model's parameters and buffers are on the
  current CUDA device, the current stream is that device's default stream
  and no stream capture is in progress;
* no mesh: the caller runs a data- or tensor-parallel step eager, since
  its collectives stay eager, and counts it under ``"mesh"``;
* no forward or backward hook or pre-hook is registered on the model or a
  submodule, or globally, and no hook on a parameter (a replay would skip
  them; the optimizer's hooks run, since its step stays eager).

Any other step runs ``body`` unchanged: the CPU path, a mesh and a hooked
model are what they were. Of the steps that may replay, the first of a
signature runs eager on the capture stream: a real step, and the warm-up
that ``torch.cuda.graphs`` asks for (it also warms cuDNN's choice and the
heads' caches). The second captures a graph and replays it; later ones
replay. A signature is the batch's keys, shapes, strides and dtypes, the
caller's ``key`` (the config, loss function, compute dtype and clip), the
numeric modes the step runs under (grad, autocast, TF32, deterministic
algorithms), the modules' training flags and the plain attributes of the
port's own submodules, which pick the forward's route (``remat``,
``use_kernels``, the heads' ``fuse_*``, ...; as ``models.graphed`` reads
them). A model keeps at most two graphs (``MAX_GRAPHS``, fixed), least
recently used first out, in one memory pool, which holds a step's
intermediates and gradients. A capture first empties the device's cache of
PyTorch's free blocks (the warm-up's, which nothing reuses), so the pool
takes their place; a dead model's pool stays reserved until the next
``torch.cuda.empty_cache``, as the cache's free blocks do.

Each replay copies the batch into the graph's static inputs (one ``copy_``
a key), seeds the graph's own generator, which draws the stochastic-depth
masks, with ``seed`` (the seed the eager step's generator takes, so the
masks are the eager step's bit for bit), replays, points each parameter's
``.grad`` at the gradients the graph wrote, for the update, and clones the
metrics, so a result a caller keeps is never written by a later step.

Correctness:

* the graphs belong to a model (by identity) and to the storage of its
  parameters and buffers. In-place writes, the update's and a model's
  ``load_state_dict`` among them, are read by the next replay; a tensor
  moved to new storage (``.to`` another device or dtype, a tensor
  assigned anew) drops the model's graphs, and its signatures capture
  again. The optimizer's state is not the graph's: its
  ``load_state_dict`` changes nothing here;
* a capture that raises marks its signature eager for good, with one
  warning a process, counted in ``CAPTURE_FAILURES``.

Counters, as ``models.graphed``'s: ``REPLAYS``, ``CAPTURES``,
``CAPTURE_FAILURES`` and ``EAGER``, the eager steps by reason. The spans
``train.graph_replay`` (copy in, replay, gradients, clones) and
``train.graph_capture`` (a capture) sit inside the caller's ``train.step``.
A replay opens no ``train.forward``, ``train.loss``, ``train.backward`` or
``train.clip``: that device work is the graph's. The caller's
``train.optimizer`` follows it.
"""

from __future__ import annotations

import collections
import warnings
import weakref

import torch
from torch.nn.modules import module as _nn_module

from ..models import graphed
from ..utils.profiling import trace

MAX_GRAPHS = 2  # captured signatures a model keeps: the full batch and one more

REPLAYS = 0
CAPTURES = 0
CAPTURE_FAILURES = 0
# eager steps by reason: "cpu" (not a CUDA batch), "other_device",
# "capturing", "side_stream", "mesh", "hooks", "first_of_signature",
# "capture_failed"
EAGER: collections.Counter = collections.Counter()

_warned = False


class _Graph:
    """One captured step: the graph, its static batch and metrics, the
    gradients it writes and the generator it draws the masks from."""

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


class _State(graphed._State):
    """One model's step graphs. Lists its modules, tensors and route
    attributes as ``models.graphed`` does, with the model's own hooks and
    the backward hooks besides."""

    def __init__(self):
        super().__init__()
        self.params: list = []
        self.on_device = False

    def _list(self, model) -> None:
        super()._list(model)
        self.hook_dicts = [d for m in (model, *self.submodules) for d in (
            m._forward_hooks, m._forward_pre_hooks, m._backward_hooks, m._backward_pre_hooks)]
        self.params = list(model.parameters())

    def reason(self, model, device) -> str | None:
        """Why the model's state keeps this step eager; None if it may
        replay. Drops the graphs when a tensor has moved to new storage."""
        if self.generation != graphed._generation:
            self._list(model)
        if _hooked(self):
            return "hooks"
        ptrs = tuple(map(graphed._data_ptr, self.tensors))
        if ptrs != self.ptrs:
            self.drop()
            self.ptrs = ptrs
            self.on_device = all(t.device == device for t in self.tensors)
        if not self.on_device:
            return "other_device"
        attrs = list(map(dict.get, self.attr_dicts, self.attr_keys))
        if attrs != self.attrs:
            self._name_attrs(attrs)
        return None

    def add(self, sig, graph: _Graph) -> None:
        self.graphs[sig] = graph
        if len(self.graphs) > MAX_GRAPHS:
            graphed._sync(self.device)
            self.graphs.popitem(last=False)


def _hooked(state: _State) -> bool:
    return bool(
        any(state.hook_dicts)
        or _nn_module._global_forward_hooks or _nn_module._global_forward_pre_hooks
        or _nn_module._global_backward_hooks or _nn_module._global_backward_pre_hooks
        or any(p._backward_hooks or p._post_accumulate_grad_hooks for p in state.params))


def _signature(batch: dict, key: tuple, model, state: _State) -> tuple:
    return (tuple((k, t.shape, t.stride(), t.dtype) for k, t in batch.items()), key,
            model.training, tuple(map(graphed._training, state.submodules)), state.attrs_id,
            torch.is_grad_enabled(),
            torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda"),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.are_deterministic_algorithms_enabled())


_states: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _side_stream(device) -> torch.cuda.Stream:
    """The device's capture stream, the one ``models.graphed`` captures on."""
    side = graphed._capture_streams.get(device.index)
    if side is None:
        side = graphed._capture_streams[device.index] = torch.cuda.Stream(device)
    return side


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _warm_up(body, state, batch: dict, seed: int, device) -> dict:
    """The signature's first step, eager on the capture stream; its metrics
    cloned on the caller's stream."""
    current, side = torch.cuda.current_stream(), _side_stream(device)
    side.wait_stream(current)
    try:
        with torch.cuda.stream(side):
            out = body(state, batch, _generator(device, seed))
    finally:
        current.wait_stream(side)
    return {key: t.clone() for key, t in out.items()}


def _capture(body, state, batch: dict, st: _State, device) -> _Graph:
    """Capture ``body`` on a static copy of ``batch`` into the model's pool,
    with a generator of the graph's own for the masks. Nothing runs: the
    caller replays the graph for this step."""
    if st.pool is None:
        st.pool = torch.cuda.graph_pool_handle()
    st.device = device
    static_in = {key: torch.empty_like(t).copy_(t) for key, t in batch.items()}
    state.optimizer.zero_grad(set_to_none=True)  # the last step's gradients are freed outside
    # the warm-up's intermediates and gradients, now free in the device's
    # cache, are never used again (the graph's pool holds a step's own):
    # give them back, so the pool takes their place and does not add to them
    torch.cuda.empty_cache()
    generator = torch.Generator(device=device)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    default = torch.cuda.default_generators[device.index]
    rng = default.clone_state()
    current, side = torch.cuda.current_stream(), _side_stream(device)
    side.wait_stream(current)
    # capture_begin/end, not torch.cuda.graph, as models.graphed: that one
    # also empties the device's and the pinned host memory's caches
    with torch.cuda.stream(side):
        graph.capture_begin(pool=st.pool, capture_error_mode="thread_local")
        try:
            static_out = body(state, static_in, generator)
        finally:
            try:
                graph.capture_end()
            except BaseException:
                graphed._abandon(device, st.pool, default, rng)
                st.pool = None
                raise
    current.wait_stream(side)
    grads = [(p, p.grad) for p in st.params if p.grad is not None]
    return _Graph(graph, static_in, static_out, grads, generator)


def _state(model) -> _State:
    state = _states.get(model)
    if state is None:
        state = _states[model] = _State()
    return state


def step(state, batch: dict, body, seed: int, key: tuple) -> dict[str, torch.Tensor]:
    """``body(state, batch, generator)`` with ``generator`` seeded with
    ``seed``, or the replay of a graph of it where the rules of this module
    allow one. Returns the step's metrics."""
    global REPLAYS, CAPTURES, CAPTURE_FAILURES, _warned
    images = batch["image"]
    device = images.device
    reason = graphed._device_reason(images)
    if reason is None and any(not isinstance(t, torch.Tensor) or t.device != device
                              for t in batch.values()):
        reason = "other_device"
    if reason is None:
        st = _state(state.model)
        reason = st.reason(state.model, device)
    if reason is None:
        sig = _signature(batch, key, state.model, st)
        graph = st.graphs.get(sig)
        if graph is not None:
            st.graphs.move_to_end(sig)
        elif sig in st.failed:
            reason = "capture_failed"
        elif sig not in st.seen:
            EAGER["first_of_signature"] += 1
            out = _warm_up(body, state, batch, seed, device)
            st.seen[sig] = None
            if len(st.seen) > graphed._MAX_SEEN:
                st.seen.popitem(last=False)
            return out
        else:
            try:
                with trace("train.graph_capture"):
                    graph = _capture(body, state, batch, st, device)
            except Exception as exc:  # noqa: BLE001 - any failure keeps the signature eager
                CAPTURE_FAILURES += 1
                st.failed.add(sig)
                if not _warned:
                    _warned = True
                    warnings.warn(
                        f"CUDA graph capture of the train step failed ({exc!r}); batches of "
                        f"shape {tuple(images.shape)} train eager", RuntimeWarning, stacklevel=3)
                reason = "capture_failed"
            else:
                CAPTURES += 1
                st.add(sig, graph)
        if graph is not None:
            with trace("train.graph_replay"):
                out = graph.replay(batch, seed)
            REPLAYS += 1
            return out
    EAGER[reason] += 1
    return body(state, batch, _generator(device, seed))
