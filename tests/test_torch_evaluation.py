"""The port's evaluation against the JAX package's, on CPU in float32.

``evaluate_pairs`` of both packages over the same batches (JAX's synthetic
stream) and the same weights (drawn in the port, carried to JAX by its
torch-name converter), for regression heads with a ParamNet and for
classification heads; the metric functions on the same tensors; and the
cases of tests/test_evaluation.py and tests/test_compat.py: a perfect
predictor scores 0, batches are weighted by size, the median is the global
one, an empty iterable raises.

Tolerances: metrics 1e-3 degrees (camera errors too); per-pixel metric
functions 1e-5 degrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu import PerspectiveFields as JaxPerspectiveFields
from perspectivefields_tpu import evaluation as jax_eval
from perspectivefields_tpu.checkpoint.torch_convert import convert_torch_state_dict
from perspectivefields_tpu import config as jax_config
from perspectivefields_tpu.data import data_iterator as jax_data_iterator
from perspectivefields_tpu_torch import PerspectiveFields, evaluation
from perspectivefields_tpu_torch import config as tc
from perspectivefields_tpu_torch.data import data_iterator
from perspectivefields_tpu_torch.models import PersNet
from perspectivefields_tpu_torch.models.common import init_random_


METRIC_TOL, PIXEL_TOL = 1e-3, 1e-5


def _cfg(m, kind):
    """The trainer's --tiny model at 64^2 (m: either package's config
    module); "classification" has PersNet-360Cities's heads and no
    ParamNet."""
    if kind == "regression":
        heads = dict(
            gravity=m.GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
            latitude=m.LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
            param=m.ParamNetConfig(name="ParamNetConvNextRegress",
                                   predict_params=("roll", "pitch", "vfov"), input_size=32),
            recover_rpf=True)
    else:
        heads = dict(
            gravity=m.GravityHeadConfig(loss_type="classification", num_classes=73, embed_dim=16,
                                        fusion_dim=16),
            latitude=m.LatitudeHeadConfig(loss_type="classification", num_classes=180,
                                          embed_dim=16, fusion_dim=16),
            param=None)
    return m.ModelConfig(
        version="custom",
        backbone=m.BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 1, 1),
                                  num_heads=(1, 2, 3, 4)),
        resize=(64, 64), **heads,
    )


def _models(kind):
    """The same seeded weights in both packages. The regression latitude
    head's prediction conv is shrunk 100x, as chip_smoke.seeded_state_dict
    does: random init drives it into its clamp, where asin's slope makes a
    degree comparison ill-posed."""
    pcfg = _cfg(tc, kind)
    sd = init_random_(PersNet(pcfg), seed=0).state_dict()
    if kind == "regression":
        for key in ("weight", "bias"):
            sd[f"persformer_heads.latitude_head.linear_pred_latitude.{key}"] *= 0.01
    params = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, strict=True)
    jm = JaxPerspectiveFields("custom", config=_cfg(jax_config, kind), params=params,
                              compute_dtype="float32")
    pm = PerspectiveFields("custom", config=pcfg, params=sd, device="cpu")
    return jm, pm


def _to_torch(batch):
    out = {k: torch.tensor(np.asarray(v)) for k, v in batch.items() if k != "cams"}
    out["cams"] = {k: torch.tensor(np.asarray(v)) for k, v in batch["cams"].items()}
    return out


@pytest.mark.parametrize("kind", ["regression", "classification"])
def test_evaluate_pairs_matches_jax(kind):
    jm, pm = _models(kind)
    it = jax_data_iterator(jax.random.PRNGKey(0), batch_size=3, im_hw=(64, 64))
    batches = [next(it) for _ in range(3)]
    want = jax_eval.evaluate_pairs(jm, iter(batches), max_samples=7)
    got = evaluation.evaluate_pairs(pm, (_to_torch(b) for b in batches), max_samples=7)
    assert set(got) == set(want) and got["samples"] == want["samples"] == 9
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=METRIC_TOL), k
    if kind == "regression":
        assert {"roll_abs_err", "pitch_abs_err", "vfov_abs_err"} <= set(got)


def test_metric_functions_match_jax():
    rng = np.random.default_rng(3)
    up = rng.normal(size=(2, 8, 9, 2)).astype(np.float32)
    gt = rng.normal(size=(2, 8, 9, 2)).astype(np.float32)
    gt[0, :3] = 0.0  # invalid pixels
    lat_p, lat_g = (rng.uniform(-80, 80, (2, 8, 9)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(evaluation.up_angular_error(torch.tensor(up), torch.tensor(gt)),
                               np.asarray(jax_eval.up_angular_error(up, gt)), atol=PIXEL_TOL)
    got = evaluation.field_metrics(*(torch.tensor(a) for a in (up, gt, lat_p, lat_g)))
    want = jax_eval.field_metrics(up, gt, lat_p, lat_g)
    assert set(got) == set(want)
    for k in want:  # medians: numpy's (mean of the two middle values)
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=PIXEL_TOL, err_msg=k)
    pred = {"pred_roll": np.array([4.0]), "pred_pitch": np.array([50.0])}
    gt_p = {"roll": np.array([4.5]), "vfov": np.array([52.0])}
    out = evaluation.param_errors(pred, gt_p)
    assert set(out) == set(jax_eval.param_errors(pred, gt_p)) == {"roll_abs_err"}
    np.testing.assert_allclose(out["roll_abs_err"].numpy(), [0.5])


def test_err_hist_and_median_match_jax():
    rng = np.random.default_rng(4)
    err = rng.uniform(-5, 200, (3, 17, 19)).astype(np.float32)  # clipped to [0, 180]
    w = (rng.uniform(size=err.shape) > 0.3).astype(np.float32)
    got = evaluation._err_hist(torch.tensor(err), torch.tensor(w))
    want = np.asarray(jax_eval._err_hist(jnp.asarray(err), jnp.asarray(w)))
    assert got.dtype == torch.float32 and got.shape == (1800,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert evaluation._hist_median(got) == jax_eval._hist_median(want)
    assert evaluation._hist_median(torch.zeros(1800)) == 0.0


def test_up_angular_error_basics():
    a, b = torch.tensor([[0.0, 1.0]]), torch.tensor([[1.0, 0.0]])
    np.testing.assert_allclose(evaluation.up_angular_error(a, a), [0.0], atol=1e-5)
    np.testing.assert_allclose(evaluation.up_angular_error(a, b), [90.0], atol=1e-4)
    np.testing.assert_allclose(evaluation.up_angular_error(a, torch.zeros(1, 2)), [0.0], atol=1e-6)


class _Oracle:
    """A stand-in for PerspectiveFields that returns given predictions."""

    def __init__(self, cfg, preds):
        self.cfg, self.device, self._preds, self._i = cfg, torch.device("cpu"), preds, 0

    def _forward_prenormalized_fn(self, images):
        out = self._preds[self._i]
        self._i += 1
        return out


def _stream(seed, n, batch_size=4):
    it = data_iterator(seed, batch_size=batch_size, im_hw=(32, 32), device="cpu")
    return [next(it) for _ in range(n)]


def test_evaluate_pairs_perfect_predictor_scores_zero():
    """The GT fed back as the prediction scores 0 on every metric (catches
    sign, encoding and aggregation faults in evaluate_pairs itself)."""
    batches = _stream(1, 2)
    preds = [{
        "pred_gravity": b["gt_gravity"], "pred_latitude": b["gt_latitude"],
        "pred_roll": torch.rad2deg(b["cams"]["roll"]),
        "pred_pitch": torch.rad2deg(b["cams"]["elevation"]),
        "pred_vfov": torch.rad2deg(b["cams"]["vfov"]),
    } for b in batches]
    res = evaluation.evaluate_pairs(_Oracle(_cfg(tc, "regression"), preds), iter(batches))
    assert res["samples"] == 8
    for k, v in res.items():
        if k != "samples":
            assert abs(v) < 1e-3, (k, v)


def test_evaluate_pairs_batch_weighting_and_empty():
    _, pm = _models("regression")
    with pytest.raises(ValueError):
        evaluation.evaluate_pairs(pm, iter(()))
    # max_samples stops mid-iterable, and batches weigh by their size: a
    # batch of 1 after a batch of 3 counts a quarter of the mean
    batches = _stream(2, 3, batch_size=3)
    assert evaluation.evaluate_pairs(pm, iter(batches), max_samples=4)["samples"] == 6
    one = {k: (v[:1] if k != "cams" else {c: x[:1] for c, x in v.items()})
           for k, v in batches[1].items()}
    r3 = evaluation.evaluate_pairs(pm, [batches[0]])
    r1 = evaluation.evaluate_pairs(pm, [one])
    both = evaluation.evaluate_pairs(pm, [batches[0], one])
    for k in ("roll_abs_err", "pitch_abs_err", "vfov_abs_err", "lat_mean_deg"):
        assert both[k] == pytest.approx((3 * r3[k] + r1[k]) / 4, rel=1e-5), k


def test_evaluate_pairs_global_median():
    """The reported median is the dataset's over all pixels, not the mean of
    per-batch medians: three exact batches and one 40 degrees off give a
    median of ~0 (a mean of medians would give 10)."""
    batches = [dict(b) for b in _stream(4, 2) for _ in (0, 1)]
    preds = []
    for i, b in enumerate(batches):
        lat = torch.rad2deg(torch.arcsin(b["gt_latitude"][..., 0]))
        shifted = (lat + (40.0 if i == 3 else 0.0)).clamp(-90, 90)
        preds.append({"pred_gravity": b["gt_gravity"],
                      "pred_latitude": torch.sin(torch.deg2rad(shifted))[..., None]})
    cfg = dataclasses.replace(_cfg(tc, "regression"), param=None, recover_rpf=False)
    res = evaluation.evaluate_pairs(_Oracle(cfg, preds), iter(batches))
    assert res["samples"] == 16
    assert res["lat_median_deg"] < 0.5 and res["lat_mean_deg"] > 1.0


def test_evaluate_pairs_counts_are_float32_as_in_jax(monkeypatch):
    # the histogram counts are float32 (exact per bin up to 2^24, JAX's
    # limit too); the means' sums are float64
    _, pm = _models("regression")
    seen = []
    real = evaluation._err_hist

    def spy(err, w):
        h = real(err, w)
        seen.append(h.dtype)
        return h

    monkeypatch.setattr(evaluation, "_err_hist", spy)
    evaluation.evaluate_pairs(pm, _stream(5, 1))
    assert seen == [torch.float32, torch.float32]
