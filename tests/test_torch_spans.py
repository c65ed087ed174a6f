"""The port's spans (``utils.profiling.trace``) on the CPU: the names and
nesting of ``inference_batch``'s, ``BatchPredictor``'s and the train step's
spans under ``torch.profiler``, and nothing recorded with no profiler on.

The nesting is read from the profiler's Chrome trace, the form the H100
benchmark reads: a span's parent is the innermost span on its thread whose
interval holds it.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from perspectivefields_tpu_torch import PerspectiveFields
from perspectivefields_tpu_torch import config as tc
from perspectivefields_tpu_torch.models import PersNet
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.serving import BatchPredictor
from perspectivefields_tpu_torch.train import create_train_state, make_train_step
from perspectivefields_tpu_torch.utils import profiling
from perspectivefields_tpu_torch.utils.profiling import StageTimer, trace

CFG = tc.ModelConfig(
    version="custom",
    backbone=tc.BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4)),
    gravity=tc.GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    latitude=tc.LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    param=tc.ParamNetConfig(name="ParamNet"),
    recover_rpf=True,
    resize=(32, 32),
)
PREFIXES = ("pf.", "serving.", "train.")
CALL = ["pf.preprocess", "pf.forward", "pf.postprocess", "pf.copy_out", "pf.wait", "pf.unpack"]
STEP = ["train.forward", "train.loss", "train.backward", "train.clip", "train.optimizer"]


@pytest.fixture(scope="module")
def model():
    return PerspectiveFields("custom", config=CFG, params=init_random_(PersNet(CFG), seed=0).state_dict(),
                             device="cpu")


def _frames(n, h=48, w=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _spans(fn, tmp_path):
    """The port's spans of one call of ``fn()`` under the CPU profiler,
    each as (name, parent's name or None), in order of start."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((float(e["ts"]), -float(e["dur"]), e["name"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith(PREFIXES)))
    out, open_ = [], []
    for ts, neg_dur, name in spans:
        while open_ and open_[-1][1] < ts - neg_dur - 1e-3:  # closed before this one ends
            open_.pop()
        out.append((name, open_[-1][0] if open_ else None))
        open_.append((name, ts - neg_dur))
    return out


def test_inference_batch_gives_its_spans_under_one_call_in_order(model, tmp_path):
    spans = _spans(lambda: model.inference_batch(_frames(2)), tmp_path)
    assert spans == [("pf.call", None)] + [(name, "pf.call") for name in CALL]


def test_inference_gives_one_call_each_and_mixed_sizes_take_the_same_spans(model, tmp_path):
    spans = _spans(lambda: [model.inference(f) for f in _frames(2)], tmp_path)
    assert spans == 2 * ([("pf.call", None)] + [(name, "pf.call") for name in CALL])
    mixed = _frames(1) + _frames(1, 40, 56, seed=1)
    assert _spans(lambda: model.inference_batch(mixed), tmp_path) == spans[:7]


def test_device_preprocess_and_a_split_forward_keep_the_spans(tmp_path):
    sd = init_random_(PersNet(CFG), seed=0).state_dict()
    dp = PerspectiveFields("custom", config=CFG, params=sd, device="cpu", device_preprocess=True)
    assert _spans(lambda: dp.inference_batch(_frames(2)), tmp_path) == (
        [("pf.call", None)] + [(name, "pf.call") for name in CALL])
    split = PerspectiveFields("custom", config=CFG, params=sd, device="cpu")
    split.replica_devices = ["cpu", "cpu"]
    spans = _spans(lambda: split.inference_batch(_frames(3)), tmp_path)
    assert [n for n, _ in spans].count("pf.forward") == 2  # one a replica
    assert all(parent == "pf.call" for _, parent in spans[1:])


def test_batch_predictor_gives_the_serving_spans_and_keeps_its_summary(model, tmp_path):
    bp = BatchPredictor(model, batch_size=2, depth=1)
    spans = _spans(lambda: bp.predict(_frames(3)), tmp_path)
    batch = [("serving.preprocess", None), ("serving.dispatch", None),
             ("pf.forward", "serving.dispatch"), ("pf.copy_out", "serving.dispatch")]
    drain = [("serving.device_wait", None), ("serving.decode", None)]
    assert spans == batch + batch + drain + drain  # depth 1: the second batch, then the drains
    assert set(bp.timer.summary()) == {"preprocess", "dispatch", "device_wait", "decode"}
    assert all(set(v) == {"seconds", "items_per_sec"} for v in bp.timer.summary().values())


def test_train_step_holds_its_five_phases(tmp_path):
    cfg = dataclasses.replace(CFG, param=None)
    state = create_train_state(init_random_(PersNet(cfg), seed=0))
    rng = np.random.default_rng(0)
    batch = {"image": torch.tensor(rng.normal(size=(1, 32, 32, 3)), dtype=torch.float32),
             "gt_gravity": torch.tensor(rng.normal(size=(1, 32, 32, 2)), dtype=torch.float32),
             "gt_latitude": torch.tensor(rng.uniform(-1, 1, (1, 32, 32, 1)), dtype=torch.float32)}
    step = make_train_step(cfg)
    spans = _spans(lambda: step(state, batch), tmp_path)
    assert spans == [("train.step", None)] + [(name, "train.step") for name in STEP]
    assert state.step == 1


def test_no_profiler_no_record_function(model, monkeypatch):
    """With no profiler active, no span enters record_function: not trace(),
    not a stage, not a call, a batch or a step."""

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with trace("pf.anything"):
        pass
    timer = StageTimer()
    with timer.stage("preprocess", 2):
        pass
    assert timer.summary()["preprocess"]["items_per_sec"] > 0
    assert len(model.inference_batch(_frames(2))) == 2
    assert len(BatchPredictor(model, batch_size=2).predict(_frames(3))) == 3


def test_trace_reads_whether_a_profiler_is_on_at_each_entry(monkeypatch):
    entered = []

    class Recorded:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Recorded)
    on = [False]
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: on[0])
    with trace("a"):
        pass
    on[0] = True
    with trace("b"):
        with trace("c"):
            pass
    assert entered == ["b", "c"]


def test_trace_pushes_no_nvtx_range_of_its_own(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("an NVTX range pushed")

    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # as on a machine with a card
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace("pf.something"):
                torch.ones(2).sum()
    assert any(e.key == "pf.something" for e in prof.key_averages())


def test_a_span_closes_when_its_block_raises(tmp_path):
    def fail():
        with pytest.raises(ValueError):
            with trace("pf.call"):
                raise ValueError("inside")
        with trace("pf.forward"):
            pass

    assert _spans(fail, tmp_path) == [("pf.call", None), ("pf.forward", None)]
