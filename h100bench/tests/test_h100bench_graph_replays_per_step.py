"""The ``graph_replays_per_step`` reader on the synthetic Chrome-trace
events of ``test_h100bench_spans``: ``train.graph_replay`` spans over
``train.step`` spans, 0.0 where steps ran eager, None with no step."""

from __future__ import annotations

import pytest

from h100bench import harness
from h100bench.tests.test_h100bench_spans import STEP, _ev, _trace
from h100bench.yardstick import trace

NAME = "graph_replays_per_step.train"


def _steps(*t0s):
    """A ``train.step`` of 100 µs at each t0, in a window that holds them."""
    return [_ev("user_annotation", trace.WINDOW, 0, 1000)] + [
        _ev("user_annotation", "train.step", t0, 100) for t0 in t0s]


def _replays(*t0s):
    """A ``train.graph_replay`` inside the step at each t0."""
    return [_ev("user_annotation", "train.graph_replay", t0 + 5, 40) for t0 in t0s]


def test_reads_zero_on_eager_steps_and_none_without_them():
    read = harness.reader(NAME)
    assert read({"host_trace": trace.Trace(STEP)}) == 0.0  # the parent: steps, none replayed
    assert read({}) is None
    assert read({"host_trace": _trace()}) is None  # an inference trace: no train.step


def test_counts_the_steps_that_replayed():
    read = harness.reader(NAME)
    steps = _steps(10, 200, 400)
    assert read({"host_trace": trace.Trace(steps + _replays(10, 200, 400))}) == pytest.approx(1.0)
    assert read({"host_trace": trace.Trace(steps + _replays(200))}) == pytest.approx(1 / 3)
    assert read({"host_trace": trace.Trace(steps)}) == 0.0


def test_is_declared_for_the_trainer_cell():
    declared = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    m = declared[NAME]
    assert m["workloads"] == ["trainer.b16"]
    assert (m["source"], m["layer"], m["moves"], m["unit"], m["better"]) == (
        "program_span", "train.train_step", "train_images_per_s", "replays/step", "higher")
