"""Whole runs at a tiny size on the CPU: a well-formed last line, and
``correct`` false with the timed path broken underneath."""

from __future__ import annotations

import json

import pytest

from h100bench import harness
from h100bench.tests import tiny

BENCH = harness.load_benchmark()


def _well_formed(line: dict, workload: str, trace: bool):
    text = json.dumps(line)
    back = json.loads(text)
    assert list(back)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(back)
    assert set(back["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in harness.cell_metrics(BENCH, workload, trace)}
    assert set(back["metrics"]) <= set(want)
    for name, m in back["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    for name, c in back["checks"].items():
        assert set(c) == {"value", "limit"} and isinstance(c["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(back["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(back["breakdown"][key]) <= 10


@pytest.mark.parametrize("workload", sorted(c["name"] for c in BENCH["workloads"]))
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_a_well_formed_line(workload, trace):
    run, line = tiny.run(workload, seconds=1.0, trace=trace)
    _well_formed(line, workload, trace)
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in harness.cell_metrics(BENCH, workload, False)}
    assert line["attempted"] > 0 and line["failed"] == 0


def _alter_first_roll(results):
    results[0]["pred_roll"] = results[0]["pred_roll"] + 30.0
    return results


def _drop_first_roll(results):
    del results[0]["pred_roll"]
    return results


@pytest.mark.parametrize("workload", ["flagship.batch32", "flagship.single"])
@pytest.mark.parametrize("fault", [_alter_first_roll, _drop_first_roll], ids=["altered", "dropped"])
def test_an_answer_altered_where_it_is_produced_fails(workload, fault, monkeypatch):
    from perspectivefields_tpu_torch.api import PerspectiveFields

    package = PerspectiveFields._package_results
    monkeypatch.setattr(PerspectiveFields, "_package_results",
                        lambda self, *a, **k: fault(package(self, *a, **k)))
    run, line = tiny.run(workload)
    assert not line["correct"]


def test_a_streamed_answer_altered_where_it_is_produced_fails(monkeypatch):
    from perspectivefields_tpu_torch.serving import BatchPredictor

    decode = BatchPredictor._decode_host

    def altered(self, key, v):
        out = decode(self, key, v)
        if key == "pred_roll":
            out = out.copy()
            out[0] += 30.0
        return out

    monkeypatch.setattr(BatchPredictor, "_decode_host", altered)
    run, line = tiny.run("flagship.stream")
    assert not line["correct"]


def _broken_step(monkeypatch, fault):
    import perspectivefields_tpu_torch.train as train

    if fault == "lr_x1.5":
        create = train.create_train_state
        monkeypatch.setattr(train, "create_train_state", lambda model, learning_rate, **k: create(
            model, learning_rate=1.5 * learning_rate, **k))
        return
    make = train.make_train_step

    def make_broken(*a, **k):
        step = make(*a, **k)

        def broken(state, batch):
            if fault == "half_batch":
                half = batch["image"].shape[0] // 2
                return step(state, {key: v[:half] for key, v in batch.items()})
            saved = [p.detach().clone() for p in state.model.parameters()]
            opt_state = state.optimizer.state_dict()
            state, metrics = step(state, batch)
            for p, s in zip(state.model.parameters(), saved):
                p.data.copy_(s)
            state.optimizer.load_state_dict(opt_state)
            state.step -= 1
            return state, metrics

        return broken

    monkeypatch.setattr(train, "make_train_step", make_broken)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "lr_x1.5"])
def test_a_broken_training_step_fails(fault, monkeypatch):
    _broken_step(monkeypatch, fault)
    run, line = tiny.run("trainer.b16")
    assert not line["correct"], run.checks
