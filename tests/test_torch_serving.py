"""The port's serving path against the JAX package's, on CPU in f32.

A tiny MiT (dims 8/16/24/32, depth 1 per stage) with narrow regression heads
and the "ParamNet" branch at a 64^2 network input. The weights are drawn
once in the port (seeded), carried to JAX with its own torch-name
converter, and the same seeded uint8 images go through both packages'
``BatchPredictor`` (both input wires, ``select``, both compact output wires)
and ``PerspectiveFields(device_preprocess=True)``. The cases of
tests/test_serving.py run on the port as well, except the mesh case (the
port has no mesh).
"""

import json
import warnings

import numpy as np
import pytest
import torch

from perspectivefields_tpu import PerspectiveFields as JaxPerspectiveFields
from perspectivefields_tpu.api import _LRUCache as JaxLRUCache
from perspectivefields_tpu.checkpoint.torch_convert import convert_torch_state_dict
from perspectivefields_tpu.config import (
    BackboneConfig,
    GravityHeadConfig,
    LatitudeHeadConfig,
    ModelConfig,
    ParamNetConfig,
)
from perspectivefields_tpu.serving import BatchPredictor as JaxBatchPredictor
from perspectivefields_tpu.utils.profiling import StageTimer as JaxStageTimer
from perspectivefields_tpu_torch import PerspectiveFields
from perspectivefields_tpu_torch.api import _LRUCache
from perspectivefields_tpu_torch.models import PersNet
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.serving import BatchPredictor
from perspectivefields_tpu_torch.utils.profiling import StageTimer, guard_nans, profile_to, trace

CFG = ModelConfig(
    version="custom",
    backbone=BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4)),
    gravity=GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    latitude=LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    param=ParamNetConfig(name="ParamNet"),
    recover_rpf=True,
    resize=(64, 64),
)
PARAM_KEYS = ("pred_roll", "pred_pitch", "pred_general_vfov", "pred_rel_cx", "pred_rel_cy")
FIELD_KEYS = ("pred_gravity", "pred_latitude")
# tests/test_reference_parity.py's tolerances: fields, then degrees and
# camera parameters
FIELD_TOL, PARAM_TOL = 5e-4, 1e-3
# the u8 output wire's step: half of 2/255 a channel, plus f32 rounding
U8_BOUND = 1 / 255 + 1e-6
# (wire, select, out_wire) of each BatchPredictor case held against JAX's
CASES = {
    "u8": ("u8", None, None),
    "f32": ("f32", None, None),
    "select_params": ("u8", PARAM_KEYS, None),
    "f16o": ("u8", FIELD_KEYS, "f16"),
    "u8o": ("f32", None, "u8"),
}


@pytest.fixture(scope="module")
def state_dict():
    sd = init_random_(PersNet(CFG), seed=0).state_dict()
    # Random init drives sin-latitude far past its clamp at +-1, where
    # asin's slope makes the degree comparison ill-posed: shrink the
    # latitude head's prediction conv (both packages get these weights).
    sd["persformer_heads.latitude_head.linear_pred_latitude.weight"] *= 0.01
    return sd


@pytest.fixture(scope="module")
def model(state_dict):
    return PerspectiveFields("custom", config=CFG, params=state_dict, device="cpu")


@pytest.fixture(scope="module")
def jax_params(state_dict):
    return convert_torch_state_dict({k: v.numpy() for k, v in state_dict.items()}, strict=True)


@pytest.fixture(scope="module")
def jax_model(jax_params):
    return JaxPerspectiveFields("custom", config=CFG, params=jax_params)


def _images(seed, n=5, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8) for _ in range(n)]


def _tol(key):
    return FIELD_TOL if key in FIELD_KEYS else PARAM_TOL


def _quantum(mode, ref):
    """One step of an output wire's encoding at the values ``ref``: the two
    packages may round a value that sits on a step's edge either way."""
    if mode == "u8":
        return 2 / 255
    if mode == "f16":
        return 2.0 ** -10 * np.maximum(np.abs(ref), 2.0 ** -14)
    return 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_batch_predictor_matches_jax(model, jax_model, case):
    wire, select, out_wire = CASES[case]
    imgs = _images(0)
    got = BatchPredictor(model, batch_size=2, wire=wire, select=select, out_wire=out_wire)
    outs = got.predict(imgs)
    want = JaxBatchPredictor(
        jax_model, batch_size=2, use_mesh=False, wire=wire, select=select, out_wire=out_wire
    ).predict(imgs)
    assert len(outs) == len(want) == 5  # tail padding dropped
    for o, w in zip(outs, want):
        assert set(o) == set(w) == set(select or o)
        for key, wv in w.items():
            wv = np.asarray(wv, np.float32)
            assert o[key].dtype == np.float32 and o[key].shape == wv.shape, key
            mode = got._pack_modes[key] if out_wire else "f32"
            bound = _tol(key) + _quantum(mode, wv)
            assert np.all(np.abs(o[key] - wv) <= bound), (key, np.abs(o[key] - wv).max())


@pytest.mark.parametrize("wire", ["u8", "f32"])
def test_streaming_matches_batch_api(model, wire):
    imgs = _images(0)
    pred = BatchPredictor(model, batch_size=2, wire=wire)
    outs = pred.predict(imgs)
    assert len(outs) == 5  # tail padding dropped
    ref = model.inference_batch(imgs)
    for i in range(5):
        for key in FIELD_KEYS + PARAM_KEYS:
            np.testing.assert_allclose(outs[i][key], ref[i][key], atol=1e-5, err_msg=key)
    summary = pred.timer.summary()
    assert "preprocess" in summary and "device_wait" in summary


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_keeps_results_and_order(model, depth):
    imgs = _images(3, n=7)
    outs = BatchPredictor(model, batch_size=3, depth=depth, select=FIELD_KEYS).predict(imgs)
    ref = model.inference_batch(imgs)
    assert len(outs) == 7
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(o["pred_gravity"], r["pred_gravity"], atol=1e-5)


def test_select_limits_readback(model):
    imgs = _images(2, n=3)
    keys = ("pred_gravity",)
    pred = BatchPredictor(model, batch_size=2, select=keys)
    outs = pred.predict(imgs)
    assert all(tuple(o.keys()) == keys for o in outs)
    full = BatchPredictor(model, batch_size=2).predict(imgs)
    np.testing.assert_array_equal(outs[1]["pred_gravity"], full[1]["pred_gravity"])


def test_bad_arguments_rejected(model):
    with pytest.raises(ValueError, match="wire"):
        BatchPredictor(model, wire="f64")
    with pytest.raises(ValueError, match="out_wire"):
        BatchPredictor(model, out_wire="bf16")
    with pytest.raises(ValueError, match="depth"):
        BatchPredictor(model, depth=0)


@pytest.mark.parametrize("out_wire,atol", [("f16", 2e-3), ("u8", U8_BOUND)])
def test_out_wire_compact_readback(model, out_wire, atol):
    """The compact encodings decode back to float32 within their bound: f16
    within 2e-3, u8 within its step of 1/255 a channel (about 0.23 degrees
    of up-vector angle, above the 0.1-degree field tolerance)."""
    imgs = _images(7)
    pred = BatchPredictor(model, batch_size=2, out_wire=out_wire)
    outs = pred.predict(imgs)
    assert len(outs) == 5
    ref = BatchPredictor(model, batch_size=2).predict(imgs)
    for i in range(5):
        for k in FIELD_KEYS:
            got = outs[i][k]
            assert got.dtype == np.float32  # decoded, not raw wire bytes
            assert np.abs(got - ref[i][k]).max() <= atol, k
        for k in PARAM_KEYS:  # f16 on both compact wires
            np.testing.assert_allclose(outs[i][k], ref[i][k], rtol=2.0 ** -11, atol=1e-7)
    if out_wire == "u8":
        assert pred._pack_modes["pred_gravity"] == pred._pack_modes["pred_latitude"] == "u8"
        assert pred._pack_modes["pred_roll"] == "f16"
        assert np.all(np.abs(outs[0]["pred_latitude"]) <= 1.0 + 1e-6)


def test_out_wire_u8_params_fall_back_to_f16(model):
    """Unbounded outputs are never u8-packed; with select on a bounded key
    only, the pack map is exactly u8."""
    imgs = _images(8, n=1)
    pred = BatchPredictor(model, batch_size=2, out_wire="u8", select=("pred_gravity",))
    outs = pred.predict(imgs)
    assert pred._pack_modes == {"pred_gravity": "u8"}
    assert outs[0]["pred_gravity"].dtype == np.float32


def test_select_missing_key_fails_fast(model):
    bp = BatchPredictor(model, batch_size=2, select=("no_such_output",))
    with pytest.raises(ValueError, match="no_such_output"):
        list(bp.predict_iter(_images(11, n=1, hw=(40, 40))))


@pytest.mark.parametrize("path", ["inference_batch", "batch_predictor"])
def test_results_are_not_aliased_across_calls(model, path):
    """A caller who keeps one call's results sees them unchanged after the
    next call."""
    if path == "inference_batch":
        run = model.inference_batch
    else:
        run = BatchPredictor(model, batch_size=2, depth=1).predict
    first = run(_images(20, n=3))
    kept = [{k: np.array(v) for k, v in r.items()} for r in first]
    run(_images(21, n=3))
    for r, k in zip(first, kept):
        for key, val in k.items():
            np.testing.assert_array_equal(r[key], val, err_msg=key)


@pytest.mark.parametrize("hw", [(96, 80), (64, 64)])
def test_device_preprocess_matches_jax(state_dict, jax_params, hw):
    """device_preprocess=True in both packages: the uint8 batch resized on
    the device with the float PIL taps, then normalized in the forward."""
    got_model = PerspectiveFields("custom", config=CFG, params=state_dict, device="cpu",
                                  device_preprocess=True)
    want_model = JaxPerspectiveFields("custom", config=CFG, params=jax_params,
                                      device_preprocess=True)
    imgs = _images(4, n=2, hw=hw)
    got, want = got_model.inference_batch(imgs), want_model.inference_batch(imgs)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, wv in w.items():
            if key == "pred_latitude_original_mode":
                assert g[key] == wv == "deg"
                continue
            atol = FIELD_TOL if key in FIELD_KEYS + ("pred_gravity_original",) else PARAM_TOL
            np.testing.assert_allclose(g[key], np.asarray(wv, np.float32), atol=atol, rtol=1e-4,
                                       err_msg=key)
    assert list(got_model._resize_cache._d) == [hw]
    # mixed sizes take the host path, as in JAX
    mixed = [imgs[0], _images(5, n=1, hw=(40, 52))[0]]
    host_model = PerspectiveFields("custom", config=CFG, params=state_dict, device="cpu")
    for g, w in zip(got_model.inference_batch(mixed), host_model.inference_batch(mixed)):
        np.testing.assert_array_equal(g["pred_gravity"], w["pred_gravity"])


def test_lru_cache_matches_jax():
    got, want = _LRUCache(maxsize=3), JaxLRUCache(maxsize=3)
    made = []
    for key in [1, 2, 3, 1, 4, 2, 5, 1]:
        for cache in (got, want):
            cache.get(key, lambda k=key: made.append(k) or k)
        assert list(got._d) == list(want._d) and len(got) == len(want) <= 3
    assert made[::2] == made[1::2]  # both rebuilt the same evicted keys


def test_stage_timer_summary_matches_jax(monkeypatch):
    import time

    clock = iter(np.arange(0.0, 100.0, 0.125))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    summaries = []
    for timer in (StageTimer(), JaxStageTimer()):
        with timer.stage("preprocess", 4):
            pass
        with timer.stage("device_wait"):
            pass
        with timer.stage("preprocess", 2):
            pass
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["preprocess"] == {"seconds": 0.25, "items_per_sec": 24.0}


def test_guard_nans_raises_on_non_finite_outputs(model):
    guarded = guard_nans(model.forward)
    out = guarded(np.zeros((1, 64, 64, 3), np.uint8))
    assert set(FIELD_KEYS) <= set(out)
    bad = guard_nans(lambda: {"a": torch.ones(2), "b": [torch.tensor([1.0, float("nan")])]})
    with pytest.raises(FloatingPointError, match=r"output\['b'\]\[0\]"):
        bad()
    assert guard_nans(lambda: {"i": torch.tensor([1, 2])})()["i"].tolist() == [1, 2]


def test_trace_and_profile_to_write_a_chrome_trace(model, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile_to(str(tmp_path)) as prof:
            with trace("serving_batch"):
                model.forward(np.zeros((1, 64, 64, 3), np.uint8))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any(e.key == "serving_batch" for e in prof.key_averages())
    # the forward's own span, inside the caller's, in the written trace
    keys = {e.key for e in prof.key_averages()}
    assert "pf.forward" in keys
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    outer, inner = spans["serving_batch"], spans["pf.forward"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
