"""The CUDA-graph cache shared by the inference forward and the train step
(``utils.cuda_graphs``), on the CPU, through a client of its own whose
"graph" is the function it captured: the state machine, the cap its client
passes, the storage check, a failed capture, a dead model, and the seam
between the cache and its two clients (``models.graphed``,
``train.graphed_step``), read from the port's source."""

import ast
import gc
import weakref
from pathlib import Path

import pytest
import torch
from torch import nn

from perspectivefields_tpu_torch.models import graphed
from perspectivefields_tpu_torch.train import graphed_step
from perspectivefields_tpu_torch.utils import cuda_graphs
from perspectivefields_tpu_torch.utils.cuda_graphs import FIRST

PORT = Path(cuda_graphs.__file__).parents[1]


def _cache(cap=2, fail=False, listed=None):
    """A client whose rule lets every call replay, whose signature is the
    input's shape and whose "graph" holds what a graph holds, the model's
    tensors, not the model. Each listing appends to ``listed``."""
    listed = [] if listed is None else listed

    def capture(state, model, x):
        if fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        tensors = list(model.parameters())
        return lambda x: x.sum(-1) + sum(t.sum() for t in tensors)

    return cuda_graphs.Cache(
        "test call", cap, lambda model, submodules, tensors: listed.append(len(submodules)),
        lambda state, model, x: None, lambda state, model, x: (x.shape, state.attrs_id),
        capture, lambda graph, model, x: graph(x), "test.replay", "test.capture")


def _call(cache, model, b=1):
    """The cache's answer for a call on a batch of ``b``: "replay" or the
    eager reason."""
    out, reason = cache.call(model, model, torch.ones(b, 3))
    return "replay" if reason is None else reason


def test_a_signature_runs_eager_then_captures_and_replays():
    cache, model = _cache(), nn.Linear(3, 2)
    assert [_call(cache, model) for _ in range(3)] == [FIRST, "replay", "replay"]
    assert _call(cache, model, b=2) == FIRST
    c = cache.counts
    assert (c.replays, c.captures, c.capture_failures, dict(c.eager)) == (2, 1, 0, {})


@pytest.mark.parametrize("cap", [1, 2, 4])
def test_a_model_keeps_the_clients_cap_of_graphs_least_recently_used_out(cap):
    cache, model = _cache(cap), nn.Linear(3, 2)
    for b in range(1, cap + 2):
        _call(cache, model, b)
        _call(cache, model, b)
    graphs = cache.states[model].graphs
    assert [sig[0][0] for sig in graphs] == list(range(2, cap + 2))
    _call(cache, model, 2)  # used again: now the newest
    _call(cache, model, 1)  # evicted but seen: captured again, evicting the oldest
    assert cache.counts.captures == cap + 2
    assert [sig[0][0] for sig in graphs] == [*range(3, cap + 2), 2, 1][-cap:]


def test_a_new_storage_drops_the_graphs_and_an_in_place_write_keeps_them():
    cache, model = _cache(), nn.Linear(3, 2)
    _call(cache, model)
    _call(cache, model)
    with torch.no_grad():
        model.weight.mul_(2)
    assert _call(cache, model) == "replay" and cache.counts.captures == 1
    model.weight.data = model.weight.data.clone()
    assert _call(cache, model) == "replay" and cache.counts.captures == 2  # seen: captured at once
    assert len(cache.states[model].graphs) == 1


def test_a_registration_lists_the_model_again():
    listed, model = [], nn.Sequential(nn.Linear(3, 2))
    cache = _cache(listed=listed)
    _call(cache, model)
    _call(cache, model)
    assert len(listed) == 1
    model.append(nn.Identity())  # a submodule registered
    _call(cache, model)
    assert len(listed) == 2 and len(cache.states[model].submodules) == 2


def test_a_failed_capture_stays_eager_and_each_client_warns_once(monkeypatch):
    first, second, model = _cache(fail=True), _cache(fail=True), nn.Linear(3, 2)
    with pytest.warns(RuntimeWarning, match="capture of the test call failed") as caught:
        for cache in (first, second):
            answers = [_call(cache, model, b) for b in (1, 1, 1, 2, 2)]
            assert answers == [FIRST, "capture_failed", "capture_failed", FIRST, "capture_failed"]
            assert cache.counts.capture_failures == 2 and cache.counts.replays == 0
    assert len(caught) == 2


def test_a_model_no_longer_used_is_collected():
    cache, model = _cache(), nn.Linear(3, 2)
    _call(cache, model)
    _call(cache, model)
    ref = weakref.ref(model)
    del model
    gc.collect()
    assert ref() is None and len(cache.states) == 0


def test_a_cpu_tensor_runs_eager_with_reason_cpu():
    assert cuda_graphs.device_reason(torch.ones(1)) == "cpu"


def test_each_client_keeps_its_own_cap_counters_and_spans():
    assert (graphed.CACHE.max_graphs, graphed_step.CACHE.max_graphs) == (4, 2)
    assert graphed.COUNTS is graphed.CACHE.counts is not graphed_step.COUNTS
    assert (graphed.CACHE.replay_span, graphed.CACHE.capture_span) == (
        "pf.graph_replay", "pf.graph_capture")
    assert (graphed_step.CACHE.replay_span, graphed_step.CACHE.capture_span) == (
        "train.graph_replay", "train.graph_capture")


# ---------------------------------------------------------------------------
# the seam, read from the port's source
# ---------------------------------------------------------------------------


def _private_uses(tree: ast.Module) -> list:
    """The private names of ``utils.cuda_graphs`` a module imports or reads
    as attributes of the module."""
    private = {n for n in vars(cuda_graphs) if n.startswith("_") and not n.startswith("__")}
    aliases, uses = {"cuda_graphs"}, []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            aliases |= {a.asname or a.name for a in node.names if a.name == "cuda_graphs"}
            if (node.module or "").endswith("cuda_graphs"):
                uses += [a.name for a in node.names if a.name in private]
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id in aliases and node.attr in private):
            uses.append(node.attr)
    return uses


def _port_sources():
    return [(path, ast.parse(path.read_text())) for path in sorted(PORT.rglob("*.py"))]


def test_no_module_but_the_cache_names_a_private_attribute_of_it():
    probe = ast.parse("from ..utils import cuda_graphs\ncuda_graphs._sync(None)\n"
                      "from ..utils.cuda_graphs import _capture_streams\n")
    assert sorted(_private_uses(probe)) == ["_capture_streams", "_sync"]  # the check sees them
    shared = PORT / "utils" / "cuda_graphs.py"
    found = {str(path.relative_to(PORT)): uses for path, tree in _port_sources()
             if path != shared and (uses := _private_uses(tree))}
    assert found == {}


def test_train_imports_nothing_of_the_inference_client_and_no_class_subclasses_a_clients():
    for path, tree in _port_sources():
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for base in node.bases:
                    assert not (isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name)
                                and base.value.id in ("graphed", "graphed_step")), (path, node.name)
            if path.parent.name != "train":
                continue
            if isinstance(node, ast.ImportFrom):
                module = node.module or ""
                assert not module.endswith("graphed"), (path, module)
                assert not (module.endswith("models") and any(
                    a.name == "graphed" for a in node.names)), (path, module)
            if isinstance(node, ast.Import):
                assert not any(a.name.endswith("models.graphed") for a in node.names), path
