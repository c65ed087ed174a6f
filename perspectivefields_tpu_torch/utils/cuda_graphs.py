"""A cache of CUDA graphs, one per call signature of a model, under the
port's two replayed entry points: the inference forward (``models.graphed``;
~1,120 launches a flagship forward eager) and the single-process train step
(``train.graphed_step``; ~8,900). A replay is one launch; the JAX package
runs each as one ``jax.jit`` program per shape. A client is a ``Cache``
built from what differs: its rule, signature, capture with its warm-up,
replay, cap and spans. Both follow these rules:

* a call may replay only on a CUDA tensor of the current device, on its
  default stream, outside any stream capture (``device_reason``), where the
  client's rule finds nothing a replay would skip; any other call runs
  eager, as it was, counted by its reason;
* a signature's first call runs eager (``FIRST``, the warm-up), the second
  captures a graph and replays it, later ones replay. A signature is the
  client's plus the plain attributes of the port's own modules, which pick
  the route (``use_kernels``, ``remat``, ``fuse_*``): flipping one is a new
  signature, flipping it back replays the graph captured before;
* a model keeps at most the client's cap of graphs, least recently used
  out, in one pool of the client's; its state, keyed weakly by the model,
  holds the submodules, not the model, so a dead model is collected;
* an in-place write to a parameter or buffer (``load_state_dict``, an
  optimizer's step) is read by the next replay; a tensor moved to new
  storage (``.data =``, ``.to``) drops the model's graphs, after a
  synchronize, and its signatures capture again;
* a capture (``capture_graph``, on the device's capture stream) fails only
  on its own thread's unsafe calls; one that raises keeps its signature
  eager for good, with one warning a process a client;
* calls that may replay hold the model's lock from the check of its state
  to the replay's results; eager calls run outside it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import warnings
import weakref

import torch
from torch.nn.modules import module as _nn_module

from .profiling import trace

FIRST = "first_of_signature"  # the eager reason of a signature's first call
MAX_SEEN = 64  # signatures (and sets of route attributes) a model remembers

# nn.Module's own entries in a module's __dict__ (registries, hooks,
# ``training``): not among the attributes that pick a forward's route
_BOOKKEEPING = frozenset(vars(torch.nn.Module()))
_PACKAGE = __name__.split(".")[0]

# Bumped whenever any module registers a parameter, buffer or submodule
# (``__setattr__``, ``register_*``): a model is then listed again.
_generation = 0


def _registered(module, name, value):
    global _generation
    _generation += 1


for _register in (_nn_module.register_module_parameter_registration_hook,
                  _nn_module.register_module_buffer_registration_hook,
                  _nn_module.register_module_module_registration_hook):
    _register(_registered)

_capture_streams: dict = {}  # device index -> the stream captures run on


class Counts:
    """A client's replays, captures, failed captures and eager calls by reason."""

    def __init__(self):
        self.replays = self.captures = self.capture_failures = 0
        self.eager: collections.Counter = collections.Counter()


class State:
    """One model's graphs, pool and lock, and what its calls are checked
    against (``listed``: what the client's ``listing`` took from it)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.generation, self.devices, self.failed = -1, frozenset(), set()
        self.submodules, self.tensors, self.attr_dicts, self.attr_keys = [], [], [], []
        self.listed = self.ptrs = self.attrs = self.pool = self.device = None
        self.attrs_id, self.ids = 0, itertools.count()
        self.attr_sets: list = []  # [(attribute values, their id)], oldest first
        self.graphs: collections.OrderedDict = collections.OrderedDict()  # LRU
        self.seen: collections.OrderedDict = collections.OrderedDict()

    def refresh(self, model, listing) -> None:
        """List the model again after a registration, drop the graphs when a
        tensor has moved to new storage and name the route attributes' set."""
        if self.generation != _generation:
            self.submodules = list(model.modules())[1:]
            self.tensors = tensors = list({
                id(t): t for m in (model, *self.submodules)
                for t in (*m._parameters.values(), *m._buffers.values()) if t is not None}.values())
            pairs = [(m.__dict__, k) for m in (model, *self.submodules)
                     if type(m).__module__.startswith(_PACKAGE)
                     for k in m.__dict__ if k not in _BOOKKEEPING]
            self.attr_dicts = [d for d, _ in pairs]
            self.attr_keys = [k for _, k in pairs]
            self.listed = listing(model, self.submodules, tensors)
            self.generation = _generation
        ptrs = tuple(map(torch.Tensor.data_ptr, self.tensors))
        if ptrs != self.ptrs:
            if self.graphs:
                _sync(self.device)
                self.graphs.clear()
            self.pool = None
            self.ptrs = ptrs
            self.devices = frozenset(t.device for t in self.tensors)
        attrs = list(map(dict.get, self.attr_dicts, self.attr_keys))
        if attrs != self.attrs:
            self.attrs = attrs
            for values, i in self.attr_sets:
                if values == attrs:
                    self.attrs_id = i
                    return
            self.attrs_id = next(self.ids)
            self.attr_sets.append((attrs, self.attrs_id))
            if len(self.attr_sets) > MAX_SEEN:
                self.attr_sets.pop(0)


class Cache:
    """One client's graphs. ``call(model, *args)`` passes ``args`` on to the
    client's functions: ``listing(model, submodules, tensors)`` when the
    model is listed, ``rule(state, *args)`` (a reason the call runs eager,
    or None), ``signature(state, *args)``, ``capture(state, *args)`` (a
    graph, on a signature's second call) and ``replay(graph, *args)``."""

    def __init__(self, name: str, max_graphs: int, listing, rule, signature, capture, replay,
                 replay_span: str, capture_span: str):
        self.name, self.max_graphs = name, max_graphs
        self.listing, self.rule, self.signature = listing, rule, signature
        self.capture, self.replay = capture, replay
        self.replay_span, self.capture_span = replay_span, capture_span
        self.counts = Counts()
        self.warned = False
        self.states: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._lock = threading.Lock()

    def state(self, model) -> State:
        state = self.states.get(model)
        if state is None:
            with self._lock:
                state = self.states.get(model)
                if state is None:
                    state = self.states[model] = State()
        return state

    def call(self, model, *args):
        """``(outputs, None)`` after a replay, or ``(None, reason)`` for a call
        the client runs eager and counts (``FIRST``: a signature's first)."""
        state = self.state(model)
        with state.lock:
            state.refresh(model, self.listing)
            reason = self.rule(state, *args)
            if reason is not None:
                return None, reason
            sig = self.signature(state, *args)
            graph = state.graphs.get(sig)
            if graph is not None:
                state.graphs.move_to_end(sig)
            elif sig in state.failed:
                return None, "capture_failed"
            elif sig not in state.seen:
                state.seen[sig] = None
                if len(state.seen) > MAX_SEEN:
                    state.seen.popitem(last=False)
                return None, FIRST
            else:
                try:
                    with trace(self.capture_span):
                        graph = self.capture(state, *args)
                except Exception as exc:  # noqa: BLE001 - any failure keeps the signature eager
                    self.counts.capture_failures += 1
                    state.failed.add(sig)
                    if not self.warned:
                        self.warned = True
                        warnings.warn(f"CUDA graph capture of the {self.name} failed ({exc!r}); "
                                      "its signature runs eager", RuntimeWarning, stacklevel=4)
                    return None, "capture_failed"
                self.counts.captures += 1
                state.graphs[sig] = graph
                if len(state.graphs) > self.max_graphs:
                    _sync(state.device)
                    state.graphs.popitem(last=False)
            with trace(self.replay_span):
                out = self.replay(graph, *args)
            self.counts.replays += 1
            return out, None


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def device_reason(t: torch.Tensor) -> str | None:
    """Why the device or stream keeps a call on ``t`` eager, or None."""
    if not t.is_cuda:
        return "cpu"
    if t.device.index != torch.cuda.current_device():
        return "other_device"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    if torch.cuda.current_stream() != torch.cuda.default_stream():
        return "side_stream"
    return None


@contextlib.contextmanager
def on_capture_stream(device):
    """Run the block on the device's capture stream, in order with the caller's."""
    side = _capture_streams.get(device.index)
    if side is None:
        side = _capture_streams[device.index] = torch.cuda.Stream(device)
    current = torch.cuda.current_stream()
    side.wait_stream(current)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        current.wait_stream(side)


def capture_graph(state: State, device, fn, generators=()):
    """``(graph, fn())``: ``fn`` captured (not run) on the device's capture
    stream into the state's pool, with ``generators`` registered."""
    if state.pool is None:
        state.pool = torch.cuda.graph_pool_handle()
    state.device = device
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    default = torch.cuda.default_generators[device.index]
    rng = default.clone_state()
    with on_capture_stream(device):
        graph.capture_begin(pool=state.pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            try:
                graph.capture_end()
            except BaseException:
                # a failed end stops there: put back the default generator's
                # state, left in capture mode, and end the pool's taking of
                # the stream's allocations and the capture's hold on it
                default.graphsafe_set_state(rng)
                for step in (torch._C._cuda_endAllocateToPool, torch._C._cuda_releasePool):
                    try:
                        step(device.index, state.pool)
                    except RuntimeError:  # this version's capture_end already did it
                        pass
                state.pool = None
                raise
    return graph, out
