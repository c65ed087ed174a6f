"""CUDA-graph replay of a model's inference forward, one graph per input
signature.

An eager forward of the flagship issues ~1,120 kernel launches from Python;
a replay of a captured CUDA graph issues one. ``forward(model, eager, ...)``
runs ``eager`` (the model's own forward) as it is, or replays a graph of it
captured earlier. The JAX package runs its forward as one ``jax.jit``
program per shape; this is the same idea on the card.

A call replays only if all of these hold, each read from the call:

* the model is in eval mode, every submodule too, and grad mode is off;
* no ``generator`` or ``rows`` is given (stochastic depth's draws);
* the input is a CUDA tensor on the current device, the current stream is
  that device's default stream and no stream capture is in progress;
* no forward hook or pre-hook is registered on a submodule, or globally (a
  replay would skip them; hooks on the model itself still run around it);
* no parameter is split over ranks (its forward runs collectives).

Any other call runs ``eager`` unchanged: the CPU path, training and a
hooked forward are what they were. Of the calls that may replay, the first
of a signature runs eager (it warms cuDNN's choice and the kernels' and
heads' caches); the second captures a graph, after one more eager run on
the capture stream as ``torch.cuda.graphs`` asks, and replays it; later
ones replay. A signature is the input's shape, strides, dtype and device,
the numeric modes the call runs under (inference mode, autocast, TF32) and
the plain attributes of the port's own submodules (``use_kernels``,
``fuse_block``, the heads' ``fuse_*``, ...), which pick the forward's
route: flipping one on a built model is a new signature, and flipping it
back replays the graph captured before. A model keeps at most four graphs
(``MAX_GRAPHS``, fixed), least recently used first out, in one memory
pool: they replay on one stream, and each keeps its static input and
outputs alive, so none reads what another wrote. What a graph holds there
is its forward's peak of intermediates and its outputs.

Threads: one model's calls that may replay hold the model's lock from the
check of its state to the clones, so two threads calling one model each
get their own result; their eager calls run outside it, as before. A
capture ends with an error only for the capturing thread's own unsafe
calls (``capture_error_mode="thread_local"``), so other threads' work on
the card goes on meanwhile.

Correctness:

* the graphs belong to a model (by identity) and to the storage of its
  parameters and buffers. An in-place write (``load_state_dict``, an
  optimizer's step) is read by the next replay; a parameter or buffer
  moved to new storage (a new tensor, ``.data =``, ``.to``) drops the
  model's graphs, and its signatures capture again on their next call;
* the input is copied into the graph's static input with one ``copy_``,
  and each output is cloned after the replay, so a result a caller keeps
  is never written by a later call;
* a capture that raises marks its signature eager for good, with one
  warning a process, counted in ``CAPTURE_FAILURES``;
* each kernel module's (``kernels.MODULES``) ``LAUNCHES`` counts under
  replay as it does eager: a capture's increments are taken back and
  added on every replay. (A thread that launches the port's kernels eager
  while another captures has its launches counted in that graph's.)

Counters, as the kernels' ``LAUNCHES``: ``REPLAYS``, ``CAPTURES``,
``CAPTURE_FAILURES`` and ``EAGER``, the eager calls by reason. The spans
``pf.graph_replay`` (a replay: copy in, replay, clones) and
``pf.graph_capture`` (a capture) are opened with ``utils.profiling.trace``.
"""

from __future__ import annotations

import collections
import threading
import warnings
import weakref
from operator import attrgetter

import torch
from torch.nn.modules import module as _nn_module

from .. import kernels
from ..utils.profiling import trace

MAX_GRAPHS = 4  # captured signatures a model keeps: full batch, tail batch, B=1, one more
_MAX_SEEN = 64  # signatures (and sets of attributes) a model remembers

REPLAYS = 0
CAPTURES = 0
CAPTURE_FAILURES = 0
# eager calls by reason: "cpu" (not a CUDA tensor), "grad_or_training",
# "generator_or_rows", "other_device", "capturing", "side_stream", "hooks",
# "split_over_ranks", "first_sight", "capture_failed"
EAGER: collections.Counter = collections.Counter()

_training = attrgetter("training")
_data_ptr = torch.Tensor.data_ptr
_warned = False
# nn.Module's own entries in a module's __dict__ (registries, hooks,
# ``training``): not among the attributes that pick a forward's route
_BOOKKEEPING = frozenset(vars(torch.nn.Module()))
_PACKAGE = __name__.split(".")[0]

# Bumped whenever any module registers a parameter, buffer or submodule
# (``__setattr__``, ``register_*``): a model then lists its submodules and
# tensors again before its next replay.
_generation = 0


def _registered(module, name, value):
    global _generation
    _generation += 1


for _register in (_nn_module.register_module_parameter_registration_hook,
                  _nn_module.register_module_buffer_registration_hook,
                  _nn_module.register_module_module_registration_hook):
    _register(_registered)


class _Graph:
    """One captured forward: the graph, its static input and outputs, and
    each kernel module's launches in it."""

    def __init__(self, graph, static_in, static_out: dict, launches: list):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.launches = launches

    def replay(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        self.static_in.copy_(images)
        self.graph.replay()
        for mod, n in self.launches:
            mod.LAUNCHES += n
        clones: dict[int, torch.Tensor] = {}  # an output under two keys stays one tensor
        out = {}
        for key, t in self.static_out.items():
            c = clones.get(id(t))
            if c is None:
                c = clones[id(t)] = t.clone()
            out[key] = c
        return out


class _State:
    """One model's graphs and what its calls are checked against. Holds the
    submodules, not the model, so a model no longer used is collected."""

    def __init__(self):
        self.lock = threading.Lock()
        self.generation = -1
        self.submodules: list = []
        self.hook_dicts: list = []
        self.tensors: list = []
        self.split = False
        self.ptrs: tuple | None = None
        self.attr_dicts: list = []
        self.attr_keys: list = []
        self.attrs: list | None = None
        self.attrs_id = 0
        self.attr_sets: list = []  # [(attribute values, their id)], oldest first
        self.next_attrs_id = 0
        self.graphs: collections.OrderedDict = collections.OrderedDict()  # LRU
        self.seen: collections.OrderedDict = collections.OrderedDict()
        self.failed: set = set()
        self.pool = None
        self.device = None

    def _list(self, model) -> None:
        self.submodules = list(model.modules())[1:]
        self.hook_dicts = [d for m in self.submodules
                           for d in (m._forward_hooks, m._forward_pre_hooks)]
        seen, tensors = set(), []
        for m in (model, *self.submodules):
            for t in (*m._parameters.values(), *m._buffers.values()):
                if t is not None and id(t) not in seen:
                    seen.add(id(t))
                    tensors.append(t)
        self.tensors = tensors
        self.split = any(getattr(t, "model_shard", None) is not None for t in tensors)
        # the plain attributes of the port's own modules, which its forwards
        # read to pick their route (torch's layers keep their constructor's)
        pairs = [(m.__dict__, k) for m in (model, *self.submodules)
                 if type(m).__module__.startswith(_PACKAGE)
                 for k in m.__dict__ if k not in _BOOKKEEPING]
        self.attr_dicts = [d for d, _ in pairs]
        self.attr_keys = [k for _, k in pairs]
        self.generation = _generation

    def reason(self, model) -> str | None:
        """Why the model's state keeps this call eager; None if it may
        replay. Drops the graphs when a tensor has moved to new storage."""
        if self.generation != _generation:
            self._list(model)
        if self.split:
            return "split_over_ranks"
        if any(map(_training, self.submodules)):
            return "grad_or_training"
        if (any(self.hook_dicts) or _nn_module._global_forward_hooks
                or _nn_module._global_forward_pre_hooks):
            return "hooks"
        ptrs = tuple(map(_data_ptr, self.tensors))
        if ptrs != self.ptrs:
            self.drop()
            self.ptrs = ptrs
        attrs = list(map(dict.get, self.attr_dicts, self.attr_keys))
        if attrs != self.attrs:
            self._name_attrs(attrs)
        return None

    def _name_attrs(self, attrs: list) -> None:
        """Set ``attrs_id`` to the id of this set of attribute values, the
        one it had if it was seen before (so its graphs replay again)."""
        self.attrs = attrs
        for values, i in self.attr_sets:
            if values == attrs:
                self.attrs_id = i
                return
        self.attrs_id = self.next_attrs_id
        self.next_attrs_id += 1
        self.attr_sets.append((attrs, self.attrs_id))
        if len(self.attr_sets) > _MAX_SEEN:
            self.attr_sets.pop(0)

    def drop(self) -> None:
        """Forget every graph (after the device has finished with them)."""
        if self.graphs:
            _sync(self.device)
            self.graphs.clear()
        self.pool = None

    def add(self, sig, graph: _Graph) -> None:
        self.graphs[sig] = graph
        if len(self.graphs) > MAX_GRAPHS:
            _sync(self.device)
            self.graphs.popitem(last=False)


_states: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_states_lock = threading.Lock()
_capture_streams: dict = {}  # device index -> the stream captures run on


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_reason(images: torch.Tensor) -> str | None:
    """Why the device or stream keeps a call on ``images`` eager; None if
    it may replay."""
    if not images.is_cuda:
        return "cpu"
    if images.device.index != torch.cuda.current_device():
        return "other_device"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    if torch.cuda.current_stream() != torch.cuda.default_stream():
        return "side_stream"
    return None


def _signature(images: torch.Tensor) -> tuple:
    return (images.shape, images.stride(), images.dtype, images.device,
            torch.is_inference_mode_enabled(), torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _capture(eager, images: torch.Tensor, state: _State) -> _Graph:
    """Warm ``eager`` up on the capture stream, then capture it on a static
    copy of ``images`` into the model's pool. The kernels' launch counters
    are left as they were before the capture (it launched nothing)."""
    device = images.device
    if state.pool is None:
        state.pool = torch.cuda.graph_pool_handle()
    state.device = device
    static_in = torch.empty_like(images).copy_(images)
    current = torch.cuda.current_stream()
    side = _capture_streams.get(device.index)
    if side is None:
        side = _capture_streams[device.index] = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        eager(static_in)
    before = [m.LAUNCHES for m in kernels.MODULES]
    generator = torch.cuda.default_generators[device.index]
    rng = generator.clone_state()
    graph = torch.cuda.CUDAGraph()
    try:
        # capture_begin/end, not torch.cuda.graph: that one also empties the
        # device's and the pinned host memory's caches, which the caller's
        # later calls would then allocate again
        with torch.cuda.stream(side):
            graph.capture_begin(pool=state.pool, capture_error_mode="thread_local")
            try:
                static_out = eager(static_in)
            finally:
                try:
                    graph.capture_end()
                except BaseException:
                    _abandon(device, state.pool, generator, rng)
                    state.pool = None
                    raise
    finally:
        counts = [m.LAUNCHES - b for m, b in zip(kernels.MODULES, before)]
        for m, b in zip(kernels.MODULES, before):
            m.LAUNCHES = b
    current.wait_stream(side)
    return _Graph(graph, static_in, static_out,
                  [(m, n) for m, n in zip(kernels.MODULES, counts) if n])


def _abandon(device, pool, generator, rng) -> None:
    """Undo what a ``capture_end`` that raised leaves behind, since it stops
    at the failed end of the stream's capture: the default generator's
    state, left in capture mode (the copy taken before is put back), and the
    pool, still taking the capture stream's allocations (ended, and the
    capture's hold on it released, which a graph that never ended does not
    do when it is destroyed)."""
    generator.graphsafe_set_state(rng)
    for step in (torch._C._cuda_endAllocateToPool, torch._C._cuda_releasePool):
        try:
            step(device.index, pool)
        except RuntimeError:  # this version's capture_end already did it
            pass


def _state(model) -> _State:
    state = _states.get(model)
    if state is None:
        with _states_lock:
            state = _states.get(model)
            if state is None:
                state = _states[model] = _State()
    return state


def forward(model: torch.nn.Module, eager, images: torch.Tensor, generator=None, rows=None):
    """``eager(images, generator, rows)``, or the replay of a graph of it
    where the rules of this module allow one."""
    global REPLAYS, CAPTURES, CAPTURE_FAILURES, _warned
    if model.training or torch.is_grad_enabled():
        reason = "grad_or_training"
    elif generator is not None or rows is not None:
        reason = "generator_or_rows"
    else:
        reason = _device_reason(images)
    if reason is not None:
        EAGER[reason] += 1
        return eager(images, generator, rows)

    state = _state(model)
    with state.lock:
        reason = state.reason(model)
        if reason is None:
            sig = _signature(images) + (state.attrs_id,)
            graph = state.graphs.get(sig)
            if graph is not None:
                state.graphs.move_to_end(sig)
            elif sig in state.failed:
                reason = "capture_failed"
            elif sig not in state.seen:
                state.seen[sig] = None
                if len(state.seen) > _MAX_SEEN:
                    state.seen.popitem(last=False)
                reason = "first_sight"
            else:
                try:
                    with trace("pf.graph_capture"):
                        graph = _capture(eager, images, state)
                except Exception as exc:  # noqa: BLE001 - any failure keeps the signature eager
                    CAPTURE_FAILURES += 1
                    state.failed.add(sig)
                    if not _warned:
                        _warned = True
                        warnings.warn(
                            f"CUDA graph capture of the forward failed ({exc!r}); inputs of "
                            f"shape {tuple(images.shape)} run eager", RuntimeWarning,
                            stacklevel=3)
                    reason = "capture_failed"
                else:
                    CAPTURES += 1
                    state.add(sig, graph)
            if graph is not None:
                with trace("pf.graph_replay"):
                    out = graph.replay(images)
                REPLAYS += 1
                return out
    EAGER[reason] += 1
    return eager(images)
