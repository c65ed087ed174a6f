"""The readers of the program's spans (``spans.py`` and the metrics that use
it) on a ``Trace`` built from a small synthetic Chrome-trace event list."""

from __future__ import annotations

import pytest

from h100bench import harness, spans
from h100bench.yardstick import trace


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def _launch(ts, corr, tid=1):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, correlation=corr)


def _call(t0, corr0):
    """One call: pf.call [t0, t0 + 100] holding pf.preprocess, pf.forward
    (three kernels: one launched after a child span inside it closed, on
    another thread too) and pf.wait; a copy launched in the forward; a
    kernel launched in pf.call outside the forward."""
    c = corr0
    return [
        _ev("user_annotation", "pf.call", t0, 100),
        _ev("user_annotation", "pf.preprocess", t0 + 1, 9),
        _ev("user_annotation", "pf.forward", t0 + 10, 50),
        _ev("user_annotation", "inner", t0 + 11, 5),  # a child range of the forward
        _launch(t0 + 12, c),  # in the child
        _launch(t0 + 20, c + 1),  # in the forward, after the child closed
        _launch(t0 + 30, c + 2, tid=2),  # another thread, inside the forward's interval
        _ev("cuda_runtime", "cudaMemcpyAsync", t0 + 40, 2, correlation=c + 3),
        _ev("kernel", "k_a", t0 + 15, 4, correlation=c),
        _ev("kernel", "k_b", t0 + 25, 6, correlation=c + 1),
        _ev("kernel", "k_c", t0 + 35, 8, correlation=c + 2),
        _ev("gpu_memcpy", "Memcpy HtoD", t0 + 45, 10, correlation=c + 3),
        _launch(t0 + 65, c + 4),  # in pf.call, after the forward
        _ev("kernel", "k_post", t0 + 70, 3, correlation=c + 4),
        _ev("user_annotation", "pf.wait", t0 + 80, 16),
    ]


def _trace():
    return trace.Trace([_ev("user_annotation", trace.WINDOW, 0, 400)]
                       + _call(10, 100) + _call(200, 200))


def test_launches_device_and_host_time_per_span():
    tr = _trace()
    assert spans.intervals(tr, "pf.forward") == [(20.0, 70.0), (210.0, 260.0)]
    assert spans.launches(tr, "pf.forward") == pytest.approx(3.0)
    assert spans.device_ms(tr, "pf.forward") == pytest.approx((4 + 6 + 8 + 10) * 1e-3)
    assert spans.host_ms(tr, "pf.forward") == pytest.approx(50e-3)
    # the parent counts what its children launched and what it launched after them
    assert spans.launches(tr, "pf.call") == pytest.approx(4.0)
    assert spans.device_ms(tr, "pf.call") == pytest.approx((4 + 6 + 8 + 10 + 3) * 1e-3)
    assert spans.host_ms(tr, "pf.wait") == pytest.approx(16e-3)


def test_a_kernel_launched_in_the_parent_after_a_child_closed_counts():
    tr = _trace()
    by_span = spans.launched(tr, "pf.forward")
    assert [sorted(op["name"] for op in ops) for ops in by_span] == 2 * [
        ["Memcpy HtoD", "k_a", "k_b", "k_c"]]
    # the nearest-range reading drops k_b (launched after "inner" closed)
    assert set(tr.kernel_s_by_range("inner")) == {"inner"}
    assert tr.kernel_s_by_range("inner")["inner"] == pytest.approx(2 * 4e-6)


def test_no_matching_span_gives_none():
    tr = _trace()
    for fn in (spans.launches, spans.device_ms, spans.host_ms):
        assert fn(tr, "train.step") is None
        assert fn(None, "pf.forward") is None
    assert spans.launched(tr, "pf.forwar") is None  # exact names only


def test_a_span_with_nothing_launched_counts_zero():
    tr = _trace()
    assert spans.launches(tr, "pf.preprocess") == 0.0
    assert spans.device_ms(tr, "pf.preprocess") == 0.0


STEP = [_ev("user_annotation", trace.WINDOW, 0, 300),
        _ev("user_annotation", "train.step", 10, 100),
        _ev("user_annotation", "train.forward", 12, 30),
        _launch(20, 1),
        _ev("user_annotation", "train.backward", 50, 40),
        _launch(60, 2, tid=7),  # the autograd engine's thread
        _launch(95, 3),  # after the phases, still in the step
        _launch(150, 4),  # between steps
        _ev("kernel", "fwd", 25, 5, correlation=1),
        _ev("kernel", "bwd", 65, 7, correlation=2),
        _ev("kernel", "opt", 100, 2, correlation=3),
        _ev("kernel", "copy_next", 155, 9, correlation=4)]

# each new reader, the cell group it reads in, and what it reads from
# _trace() (inference) or STEP (training)
READS = {
    "launches_per_forward.batch": 3.0,
    "launches_per_forward.single": 3.0,
    "launches_per_forward.stream": 3.0,
    "forward_device_ms.batch": 28e-3,
    "forward_device_ms.single": 28e-3,
    "forward_device_ms.stream": 28e-3,
    "forward_issue_ms.batch": 50e-3,
    "forward_issue_ms.single": 50e-3,
    "readback_wait_ms.batch": 16e-3,
    "readback_wait_ms.single": 16e-3,
    "launches_per_step.train": 3.0,
    "step_device_ms.train": 14e-3,
    "step_issue_ms.train": 100e-3,
}


@pytest.mark.parametrize("name", sorted(READS))
def test_each_reader_reads_its_span_and_gives_none_without_it(name):
    read = harness.reader(name)
    tr = trace.Trace(STEP) if name.endswith(".train") else _trace()
    assert read({"host_trace": tr}) == pytest.approx(READS[name])
    assert read({}) is None
    other = _trace() if name.endswith(".train") else trace.Trace(STEP)
    assert read({"host_trace": other}) is None  # the parent's trace: no such span


def test_every_new_reader_is_declared_for_its_cells():
    declared = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    for name in READS:
        m = declared[name]
        assert m["source"] == "program_span" and len(m["workloads"]) == 1
