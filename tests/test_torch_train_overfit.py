"""The port's trainer learns: tests/test_train.py's single-batch overfit
probe (its bars) on the port, on CPU in float32.

Overfitting one fixed synthetic batch with the production step (AdamW, the
global-norm clip, total_loss, stochastic depth on as in training) must take
the per-pixel up error on that batch from random to nearly memorized. It is
also the guard of the saturated latitude head (the overflow penalty on
``latitude_raw``): without it the latitude head cannot leave its clamp.
Its own file, because its 300 steps take about half a minute.
"""

import numpy as np
import torch

from perspectivefields_tpu_torch.config import (
    BackboneConfig,
    GravityHeadConfig,
    LatitudeHeadConfig,
    ModelConfig,
)
from perspectivefields_tpu_torch.data import data_iterator
from perspectivefields_tpu_torch.evaluation import field_metrics
from perspectivefields_tpu_torch.models import PersNet
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.train import create_train_state, make_train_loop

CFG = ModelConfig(
    backbone=BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4)),
    gravity=GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    latitude=LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    param=None,
    resize=(64, 64),
)


def test_single_batch_overfit_learns():
    batch = next(data_iterator(7, batch_size=2, im_hw=(64, 64), device="cpu"))
    batch = {k: v for k, v in batch.items() if k not in ("cams", "gt_params")}
    batch["image"] = batch["image"] - torch.tensor(CFG.pixel_mean)
    state = create_train_state(init_random_(PersNet(CFG), seed=0), learning_rate=1e-3)

    def metrics_of(model):
        with torch.no_grad():
            out = model.eval()(batch["image"])
        pred_lat = torch.rad2deg(torch.arcsin(out["pred_latitude"][..., 0].clamp(-1, 1)))
        gt_lat = torch.rad2deg(torch.arcsin(batch["gt_latitude"][..., 0]))
        m = field_metrics(out["pred_gravity"], batch["gt_gravity"], pred_lat, gt_lat)
        return {k: float(v) for k, v in m.items()}

    before = metrics_of(state.model)
    # 300 steps in 6 loop calls on the same batch (batch_fn ignores the step)
    loop = make_train_loop(CFG, lambda step: batch, chunk=50)
    first_loss = None
    for _ in range(6):
        state, m = loop(state)
        if first_loss is None:
            first_loss = float(m["loss"][0])
    last_loss = float(m["loss"][-1])
    after = metrics_of(state.model)
    # JAX's bars: a large relative fall and a small absolute error
    assert np.isfinite(last_loss)
    assert last_loss < first_loss / 5, (first_loss, last_loss)
    assert after["up_mean_deg"] < 20.0, (before, after)
    assert after["up_mean_deg"] < before["up_mean_deg"] / 2, (before, after)
