"""The CUDA-graph replay of the inference forward (``models.graphed``, a
client of ``utils.cuda_graphs``) on the CPU: when a call replays and when
it runs eager, the per-model cache of graphs and the counters. The device
check and the capture primitive are stubbed (``_cuda_graph_stub``: a "graph"
that reruns the eager forward into its static outputs); the real capture
and replay are tested on the card in tests/test_torch_cuda.py."""

import ast
import copy
import importlib
import pkgutil
import re
import threading

import pytest
import torch
from pathlib import Path
from torch import nn

from perspectivefields_tpu_torch import config as tc
from perspectivefields_tpu_torch import kernels
from perspectivefields_tpu_torch.kernels import build
from perspectivefields_tpu_torch.models import PersNet, graphed
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.utils.cuda_graphs import FIRST
from _cuda_graph_stub import counts, delta, fail_captures, stub

CFG = tc.ModelConfig(
    version="custom",
    backbone=tc.BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4)),
    gravity=tc.GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    latitude=tc.LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    param=tc.ParamNetConfig(name="ParamNet"),
    recover_rpf=True,
    resize=(32, 32),
)


@pytest.fixture(scope="module")
def persnet():
    """A tiny PersNet with random weights, built once: tests take a copy."""
    return init_random_(PersNet(CFG), seed=0).eval()


class Tiny(nn.Module):
    """Two Linears behind ``graphed.forward``, as PersNet's forward is; two
    keys share one output tensor, as ParamNet's vfov keys do."""

    def __init__(self):
        super().__init__()
        self.a, self.b = nn.Linear(3, 4), nn.Linear(4, 2)

    def forward(self, x, generator=None, rows=None):
        return graphed.forward(self, self._eager, x, generator, rows)

    def _eager(self, x, generator=None, rows=None):
        y = self.b(torch.relu(self.a(x)))
        s = y.sum(-1)
        return {"y": y, "s": s, "s_alias": s}


def _record_shapes(monkeypatch) -> list:
    """The shapes of the inputs the forward's cache captures, in order."""
    captured, capture = [], graphed.CACHE.capture

    def recording(state, eager, images):
        captured.append(tuple(images.shape))
        return capture(state, eager, images)

    monkeypatch.setattr(graphed.CACHE, "capture", recording)
    return captured


@pytest.fixture
def stubbed(monkeypatch):
    """The shared stub (``_cuda_graph_stub.stub``). Yields the list of
    captured inputs' shapes."""
    stub(monkeypatch)
    return _record_shapes(monkeypatch)


def _counts():
    return counts(graphed.COUNTS)


def _delta(before):
    return delta(graphed.COUNTS, before)


def _x(seed=0, shape=(2, 3)):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def test_cpu_input_runs_eager():
    model, before = Tiny().eval(), _counts()
    with torch.inference_mode():
        for _ in range(3):
            model(_x())
    assert _delta(before) == (0, 0, 0, {"cpu": 3})


@pytest.mark.parametrize("case", ["training", "submodule_training", "grad"])
def test_training_or_grad_runs_eager(stubbed, case):
    model = Tiny().eval()
    if case == "training":
        model.train()
    elif case == "submodule_training":
        model.b.train()
    before = _counts()
    with torch.set_grad_enabled(case == "grad"):
        for _ in range(3):
            model(_x())
    assert _delta(before) == (0, 0, 0, {"grad_or_training": 3}) and not stubbed


@pytest.mark.parametrize("arg", ["generator", "rows"])
def test_generator_or_rows_runs_eager(stubbed, arg):
    model, before = Tiny().eval(), _counts()
    kw = {"generator": torch.Generator()} if arg == "generator" else {"rows": (0, 2)}
    with torch.no_grad():
        for _ in range(3):
            model(_x(), **kw)
    assert _delta(before) == (0, 0, 0, {"generator_or_rows": 3}) and not stubbed


@pytest.mark.parametrize("kind", ["forward_hook", "pre_hook", "global_hook"])
def test_a_forward_hook_keeps_the_call_eager_and_fires(stubbed, kind):
    model, fired = Tiny().eval(), []
    with torch.no_grad():
        model(_x())
        model(_x())  # captured: a hook registered later must still stop replays
        if kind == "forward_hook":
            handle = model.a.register_forward_hook(lambda *a: fired.append(1))
        elif kind == "pre_hook":
            handle = model.b.register_forward_pre_hook(lambda *a: fired.append(1))
        else:
            handle = nn.modules.module.register_module_forward_hook(lambda *a: fired.append(1))
        before = _counts()
        try:
            for _ in range(3):
                model(_x())
        finally:
            handle.remove()
        hooked = _delta(before)
        model(_x())
    assert hooked == (0, 0, 0, {"hooks": 3})
    assert len(fired) == (9 if kind == "global_hook" else 3)  # the global hook fires per module
    assert graphed.COUNTS.replays == before[0] + 1  # removed: the graph replays again


def test_eager_on_first_sight_capture_on_second_then_replay(stubbed):
    model = Tiny().eval()
    x = _x()
    with torch.no_grad():
        want = model._eager(x)
        before = _counts()
        first = model(x)
        assert _delta(before) == (0, 0, 0, {FIRST: 1}) and stubbed == []
        second = model(x)
        assert _delta(before) == (1, 1, 0, {FIRST: 1}) and stubbed == [(2, 3)]
        third = model(x)
        kept = {k: v.clone() for k, v in third.items()}
        model(_x(seed=1))  # a later call on other inputs
        assert _delta(before) == (3, 1, 0, {FIRST: 1})
        model(_x(shape=(5, 3)))  # another signature: its first call again
        assert _delta(before) == (3, 1, 0, {FIRST: 2})
    for out in (first, second, third):
        assert set(out) == {"y", "s", "s_alias"}
        for k in out:
            torch.testing.assert_close(out[k], want[k], rtol=0, atol=0)
    assert third["s"] is third["s_alias"]  # one tensor under two keys stays one
    assert third["y"] is not second["y"]  # fresh tensors each call
    for k in kept:
        assert torch.equal(third[k], kept[k])  # not written by the later call


class _Cast(Tiny):
    def _eager(self, x, generator=None, rows=None):
        return super()._eager(x.float())


def test_signature_is_shape_strides_and_dtype(stubbed):
    model = _Cast().eval()
    with torch.no_grad():
        for x in (_x(), _x(shape=(5, 3)), _x().double(), _x(shape=(3, 2)).t()):
            model(x)
            model(x)
    assert stubbed == [(2, 3), (5, 3), (2, 3), (2, 3)]


def test_at_most_max_graphs_least_recently_used_out(stubbed):
    model = Tiny().eval()
    n = graphed.CACHE.max_graphs + 1
    with torch.no_grad():
        for b in range(1, n + 1):
            model(_x(shape=(b, 3)))
            model(_x(shape=(b, 3)))
        state = graphed.CACHE.states[model]
        assert [sig[0][0] for sig in state.graphs] == list(range(2, n + 1))
        model(_x(shape=(1, 3)))  # evicted, but seen: captured again
    assert stubbed == [(b, 3) for b in range(1, n + 1)] + [(1, 3)]
    assert len(state.graphs) == graphed.CACHE.max_graphs == 4


@pytest.mark.parametrize("how", ["new_parameter", "data", "new_submodule"])
def test_a_parameter_on_new_storage_forces_a_recapture(stubbed, how):
    model = Tiny().eval()
    x = _x()
    with torch.no_grad():
        model(x)
        model(x)
        if how == "new_parameter":
            model.a.weight = nn.Parameter(torch.ones(4, 3))
        elif how == "data":
            model.a.weight.data = torch.ones(4, 3)
        else:
            model.b = nn.Linear(4, 2).eval()
        got = model(x)
        want = model._eager(x)
    assert len(stubbed) == 2  # the signature was seen: captured again at once
    for k in want:
        assert torch.equal(got[k], want[k])


def test_an_in_place_weight_load_is_replayed_without_a_recapture(stubbed):
    model = Tiny().eval()
    x = _x()
    new = {k: torch.randn_like(v) for k, v in Tiny().state_dict().items()}
    with torch.no_grad():
        model(x)
        model(x)
        model.load_state_dict(new)
        got = model(x)
        want = model._eager(x)
    assert len(stubbed) == 1
    for k in want:
        assert torch.equal(got[k], want[k])


def test_a_failed_capture_stays_eager_and_warns_once(monkeypatch):
    model = Tiny().eval()
    stub(monkeypatch)
    fail_captures(monkeypatch)
    monkeypatch.setattr(graphed.CACHE, "warned", False)
    before = _counts()
    with torch.no_grad(), pytest.warns(RuntimeWarning, match="capture of the forward failed") as rec:
        outs = [model(_x()) for _ in range(4)]
        model(_x(shape=(3, 3)))
        model(_x(shape=(3, 3)))  # a second failure, of another signature: no second warning
    assert len(rec) == 1
    assert _delta(before) == (0, 0, 2, {FIRST: 2, "capture_failed": 4})
    for out in outs:
        assert torch.equal(out["y"], model._eager(_x())["y"])


def test_a_replay_adds_each_kernel_modules_launches():
    class Kernel:
        LAUNCHES = 7

    class NoGraph:
        def replay(self):
            pass

    g = graphed._Graph(NoGraph(), torch.zeros(2), {"y": torch.ones(2)}, [(Kernel, 25)])
    g.replay(torch.ones(2))
    g.replay(torch.ones(2))
    assert Kernel.LAUNCHES == 57


def test_persnet_forward_replays_and_a_copy_keeps_its_own_graphs(stubbed, persnet):
    model = copy.deepcopy(persnet)
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    before = _counts()
    with torch.inference_mode():
        want = model._eager_forward(x)
        outs = [model(x) for _ in range(3)]
        replica = copy.deepcopy(model)
        replica(x)
    assert _delta(before)[:2] == (2, 1)
    assert graphed.CACHE.states[replica].graphs == {}  # seen once, not captured
    for out in outs:
        assert set(out) == set(want)
        for k in want:
            assert torch.equal(out[k], want[k])


@pytest.mark.parametrize("flag", ["fuse_embed", "fuse_conv0", "fuse_tail"])
def test_flipping_a_route_flag_is_a_new_signature_and_flipping_back_replays(
        stubbed, persnet, flag):
    """The heads' rewrites are plain attributes that the forward reads:
    flipped on a built model, the call must not replay the graph of the
    other route; flipped back, that graph replays again."""
    model = copy.deepcopy(persnet)
    heads = list(model.persformer_heads.values())
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        model(x)
        model(x)  # captured on the rewrites' route
        before = _counts()
        for head in heads:
            setattr(head, flag, False)
        flipped = [model(x) for _ in range(2)]  # eager, then captured and replayed
        assert _delta(before) == (1, 1, 0, {FIRST: 1})
        want_flipped = model._eager_forward(x)
        for head in heads:
            setattr(head, flag, True)
        back = model(x)
        want = model._eager_forward(x)
    assert _delta(before) == (2, 1, 0, {FIRST: 1})  # no capture on the way back
    assert stubbed == [(1, 32, 32, 3)] * 2
    for got, ref in [(out, want_flipped) for out in flipped] + [(back, want)]:
        for k in ref:
            assert torch.equal(got[k], ref[k])


def test_two_threads_calling_one_model_each_get_their_own_result(monkeypatch):
    """A replay copies into the graph's one static input: the model's lock
    keeps another thread's copy from landing between it and the replay (the
    fake's replay lets other threads run between the two)."""
    stub(monkeypatch, delay=0.001)
    model = Tiny().eval()
    xs = [_x(seed=10), _x(seed=11)]
    with torch.no_grad():
        wants = [model._eager(x)["y"] for x in xs]
    got = [[], []]
    start = threading.Barrier(2)

    def run(i):
        start.wait()
        with torch.no_grad():
            got[i] = [model(xs[i])["y"] for _ in range(20)]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    replays = graphed.COUNTS.replays
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert graphed.COUNTS.replays - replays >= 30
    for i in range(2):
        assert len(got[i]) == 20
        for y in got[i]:
            assert torch.equal(y, wants[i])


def test_kernels_modules_lists_every_module_that_counts_its_launches():
    """A replay adds to the launch counters of ``kernels.MODULES`` alone."""
    counting = {info.name for info in pkgutil.iter_modules(kernels.__path__)
                if isinstance(getattr(importlib.import_module(
                    f"{kernels.__name__}.{info.name}"), "LAUNCHES", None), int)}
    assert {m.__name__.rsplit(".", 1)[1] for m in kernels.MODULES} == counting
    assert len(kernels.MODULES) == len(counting)


def _chip_smoke_device_kernels() -> dict:
    """chip_smoke.py's DEVICE_KERNELS, read from its source (importing it
    takes seconds)."""
    tree = ast.parse((Path(__file__).parents[1] / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "DEVICE_KERNELS":
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no DEVICE_KERNELS")


def test_chip_smokes_device_kernel_names_are_kernels_of_the_sources():
    """chip_smoke.py holds the launch counters, replays included, to the
    kernels the profiler sees run, by these names: one a module, each a
    kernel of its module's source."""
    names = _chip_smoke_device_kernels()
    assert set(names) == {m.__name__.rsplit(".", 1)[1] for m in kernels.MODULES}
    for name, kernel in names.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        assert re.search(rf"__global__ void __launch_bounds__\([^)]*\)\s*{kernel}\(", src), name
