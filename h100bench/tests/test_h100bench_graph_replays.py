"""The ``graph_replays_per_forward`` reader on the synthetic Chrome-trace
events of ``test_h100bench_spans``: ``pf.graph_replay`` spans over
``pf.forward`` spans, 0.0 where forwards ran eager, None with no forward."""

from __future__ import annotations

import pytest

from h100bench import harness
from h100bench.tests.test_h100bench_spans import STEP, _call, _ev, _trace
from h100bench.yardstick import trace

NAMES = ("graph_replays_per_forward.single", "graph_replays_per_forward.stream")


def _replays(*t0s):
    """A ``pf.graph_replay`` inside the ``pf.forward`` of the call at each t0."""
    return [_ev("user_annotation", "pf.graph_replay", t0 + 21, 30) for t0 in t0s]


@pytest.mark.parametrize("name", NAMES)
def test_reads_zero_on_eager_forwards_and_none_without_them(name):
    read = harness.reader(name)
    assert read({"host_trace": _trace()}) == 0.0  # the parent: forwards, none replayed
    assert read({}) is None
    assert read({"host_trace": trace.Trace(STEP)}) is None  # no pf.forward


def test_is_declared_for_its_cells():
    declared = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    assert [declared[n]["workloads"] for n in NAMES] == [["flagship.single"], ["flagship.stream"]]
    for name in NAMES:
        assert declared[name]["source"] == "program_span"
        assert declared[name]["layer"] == "models: the device forward"


def test_counts_the_forwards_that_replayed():
    read = harness.reader("graph_replays_per_forward.single")
    calls = [_ev("user_annotation", trace.WINDOW, 0, 400)] + _call(10, 100) + _call(200, 200)
    assert read({"host_trace": trace.Trace(calls + _replays(10, 200))}) == pytest.approx(1.0)
    assert read({"host_trace": trace.Trace(calls + _replays(10))}) == pytest.approx(0.5)
    assert read({"host_trace": trace.Trace(calls)}) == 0.0
