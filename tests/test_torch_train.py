"""The port's training path against the JAX package's, on CPU in float32.

* losses (perspectivefields_tpu_torch/train/losses.py) against JAX's on the
  same seeded tensors, and the cases of tests/test_train.py: all-invalid
  gives 0, ignore_index, invalid gravity pixels masked, the exact latitude
  clamp and the saturated head's restoring gradient;
* training mode of the models: ``latitude_raw``, ``DropPath`` (identity in
  eval and at rate 0, one mask per sample, x / keep scaling) and ``remat``
  (the same loss and gradients), with no change to the state dict;
* the train step: optax's global-norm clip, and one and three AdamW steps
  of the trainer's --tiny config against JAX's ``make_train_step`` from
  the same weights (a JAX param tree read by ``checkpoint.state_dict_from_jax``)
  on JAX's own batches, stochastic depth off: losses, the first step's
  clipped gradients (Adam's first moments) and the parameters;
* the kernels' inference-only guard (F1), which a training step relies on.

Tolerances: losses 1e-5 relative; clipped gradients 1e-5 (their global
norm is 1; measured 2.7e-6); parameters after k Adam steps 0.1 * lr * k (Adam's first updates are
about lr * sign(g), so a gradient near its eps moves a parameter by a
fraction of lr between two frameworks; measured 0.024 * lr after one step).
"""

import dataclasses
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from perspectivefields_tpu import config as jax_config
from perspectivefields_tpu.data import data_iterator as jax_data_iterator
from perspectivefields_tpu.models import PersNet as JaxPersNet
from perspectivefields_tpu.train import losses as jax_losses
from perspectivefields_tpu.train import TrainState as JaxTrainState
from perspectivefields_tpu.train import make_train_step as jax_make_train_step
from perspectivefields_tpu_torch import config as tc
from perspectivefields_tpu_torch.checkpoint import state_dict_from_jax, state_dict_to_jax
from perspectivefields_tpu_torch.kernels.build import check_inference_only
from perspectivefields_tpu_torch.models import PersNet
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.models.mit import DropPath
from perspectivefields_tpu_torch.tools.train import model_config
from perspectivefields_tpu_torch.train import (
    clip_by_global_norm_,
    create_train_state,
    losses,
    make_train_loop,
    make_train_step,
)

LOSS_RTOL = 1e-5
LR = 1e-4


def t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_msgil_matches_jax():
    rng = np.random.default_rng(0)
    pred, gt = (rng.normal(size=(2, 33, 29, 2)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(2, 33, 29, 2)) > 0.2
    want = float(jax_losses.msgil_norm_loss(pred, gt, mask))
    np.testing.assert_allclose(float(losses.msgil_norm_loss(t(pred), t(gt), t(mask))), want,
                               rtol=LOSS_RTOL)


def test_meanstd_tanh_matches_jax_and_drops_small_items():
    rng = np.random.default_rng(7)
    pred, gt = (rng.normal(size=(3, 24, 27, 1)).astype(np.float32) * 30 for _ in range(2))
    mask = rng.uniform(size=(3, 24, 27, 1)) > 0.3
    mask[1] = False
    mask[1, :4, :10] = True  # 40 valid pixels < 100 -> item dropped
    want = float(jax_losses.meanstd_tanh_norm_loss(pred, gt, mask))
    got = float(losses.meanstd_tanh_norm_loss(t(pred), t(gt), t(mask)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_meanstd_tanh_all_invalid_is_zero():
    pred = torch.ones(2, 8, 8, 1)
    assert float(losses.meanstd_tanh_norm_loss(pred, torch.zeros_like(pred),
                                               torch.zeros_like(pred, dtype=torch.bool))) == 0.0


def test_cross_entropy_matches_jax_and_torch_ignore_index():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 8, 8, 73)).astype(np.float32)
    labels = rng.integers(0, 73, size=(2, 8, 8))
    labels[0, :2] = 72  # ignored
    got = float(losses.cross_entropy_loss(t(logits), t(labels), ignore_index=72))
    np.testing.assert_allclose(got, float(jax_losses.cross_entropy_loss(logits, labels, 72)),
                               rtol=LOSS_RTOL)
    want = float(F.cross_entropy(t(np.moveaxis(logits, -1, 1)), t(labels), ignore_index=72))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_gravity_loss_matches_jax_and_masks_invalid():
    rng = np.random.default_rng(2)
    pred, gt = (rng.normal(size=(1, 16, 16, 2)).astype(np.float32) for _ in range(2))
    gt[0, :4] = 0.0  # invalid rows
    got = losses.gravity_regression_loss(t(pred), t(gt), 0.5)
    want = jax_losses.gravity_regression_loss(pred, gt, 0.5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL)
    # matching gt on the valid pixels zeroes the l2 term
    pred2 = gt.copy()
    pred2[0, :4] = 5.0
    assert float(losses.gravity_regression_loss(t(pred2), t(gt))["gravity-l2-loss"]) < 1e-10


def test_latitude_loss_matches_jax_and_is_zero_at_perfect():
    rng = np.random.default_rng(3)
    gt = rng.uniform(-1, 1, size=(2, 16, 16, 1)).astype(np.float32)
    raw = (gt * 3).astype(np.float32)
    pred = np.clip(raw, -1, 1)
    got = losses.latitude_regression_loss(t(pred), t(gt), 2.0, raw=t(raw))
    want = jax_losses.latitude_regression_loss(pred, gt, 2.0, raw=raw)
    assert set(got) == set(want) == {"latitude-msg-normal-loss", "latitude-l2-loss",
                                     "latitude-sat-loss"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL)
    perfect = losses.latitude_regression_loss(t(gt), t(gt))
    assert float(sum(perfect.values())) < 1e-10


@pytest.mark.parametrize("kind", ["mse", "l1"])
def test_param_loss_matches_jax(kind):
    rng = np.random.default_rng(4)
    pred, target = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(losses.param_loss(t(pred), t(target), 0.3, kind)),
                               float(jax_losses.param_loss(pred, target, 0.3, kind)),
                               rtol=LOSS_RTOL)


def _cfg_pair(kind):
    def mk(m):
        if kind == "regression":
            return m.ModelConfig(
                gravity=m.GravityHeadConfig(loss_type="regression"),
                latitude=m.LatitudeHeadConfig(loss_type="regression"),
                param=m.ParamNetConfig(name="ParamNetConvNextRegress",
                                       predict_params=("roll", "pitch", "vfov"), loss_weight=0.5),
                recover_rpf=True,
            )
        return m.ModelConfig(
            gravity=m.GravityHeadConfig(loss_type="classification", num_classes=73),
            latitude=m.LatitudeHeadConfig(loss_type="classification", num_classes=180),
        )

    return mk(jax_config), mk(tc)


@pytest.mark.parametrize("kind", ["regression", "classification"])
def test_total_loss_matches_jax(kind):
    jcfg, pcfg = _cfg_pair(kind)
    rng = np.random.default_rng(5)
    b, h, w = 2, 12, 10
    if kind == "regression":
        lat_raw = rng.normal(size=(b, h, w, 1)).astype(np.float32) * 2
        out = {
            "pred_gravity": rng.normal(size=(b, h, w, 2)).astype(np.float32),
            "pred_latitude": np.clip(lat_raw, -1, 1), "latitude_raw": lat_raw,
            "pred_roll": rng.normal(size=b).astype(np.float32) * 30,
            "pred_pitch": rng.normal(size=b).astype(np.float32) * 30,
            "pred_vfov": rng.normal(size=b).astype(np.float32) * 30 + 60,
        }
        gt_g = rng.normal(size=(b, h, w, 2)).astype(np.float32)
        gt_g[0, :3] = 0.0
        batch = {"gt_gravity": gt_g,
                 "gt_latitude": rng.uniform(-1, 1, (b, h, w, 1)).astype(np.float32),
                 "gt_params": rng.normal(size=(b, 3)).astype(np.float32) * 0.3}
    else:
        out = {"pred_gravity": rng.normal(size=(b, h, w, 73)).astype(np.float32),
               "pred_latitude": rng.normal(size=(b, h, w, 180)).astype(np.float32)}
        g_lab = rng.integers(0, 73, (b, h, w))
        g_lab[1, :2] = 72
        batch = {"gt_gravity": g_lab, "gt_latitude": rng.integers(0, 180, (b, h, w))}
    total_j, parts_j = jax_losses.total_loss(out, batch, jcfg)
    total, parts = losses.total_loss({k: t(v) for k, v in out.items()},
                                     {k: t(v) for k, v in batch.items()}, pcfg)
    assert set(parts) == set(parts_j)
    for k in parts_j:
        np.testing.assert_allclose(float(parts[k]), float(parts_j[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(total), float(total_j), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# training mode of the models (F2)
# ---------------------------------------------------------------------------

SMALL = tc.ModelConfig(
    version="custom",
    backbone=tc.BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 2, 1, 1), num_heads=(1, 2, 3, 4)),
    gravity=tc.GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    latitude=tc.LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    param=None,
    resize=(32, 32),
)


def test_latitude_clamp_exact_and_saturated_trainable():
    """Training mode gives the head's pre-clamp output as latitude_raw and
    pred_latitude is exactly its clamp; eval mode has no latitude_raw; the
    overflow penalty pulls a saturated pixel back with a gradient that grows
    with the drift, at any magnitude (tests/test_train.py's case)."""
    net = init_random_(PersNet(SMALL), seed=0).train()
    x = torch.tensor(np.random.default_rng(0).normal(size=(1, 32, 32, 3)), dtype=torch.float32)
    out = net(x)
    raw = out["latitude_raw"]
    torch.testing.assert_close(out["pred_latitude"], raw.clamp(-1, 1), rtol=0, atol=0)
    with torch.no_grad():
        assert "latitude_raw" not in net.eval()(x)

    gt = torch.zeros(1, 4, 4, 1)

    def grad_of(value):
        r = torch.full((1, 4, 4, 1), value, requires_grad=True)
        loss = losses.latitude_regression_loss(r.clamp(-1, 1), gt, raw=r)["latitude-sat-loss"]
        loss.backward()
        return loss, r.grad

    for mag in (1.5, 2.0**22, 2.0**26):
        assert float(grad_of(mag)[1].min()) > 0.0, mag  # pulls back toward the range
    assert float(grad_of(8.0)[1].min()) > float(grad_of(2.0)[1].max())  # grows with drift
    loss_in, g_in = grad_of(0.5)  # in range: no penalty, no gradient
    assert float(loss_in) == 0.0 and float(g_in.abs().max()) == 0.0


def test_drop_path_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 3, 5, 6)
    dp = DropPath(0.3)
    g = torch.Generator().manual_seed(0)
    assert dp.eval().sample(x, g) is None and dp(x, None) is x
    assert DropPath(0.0).train().sample(x, g) is None


def test_drop_path_mask_is_per_sample_and_scales_by_keep():
    dp = DropPath(0.25).train()
    x = torch.ones(4096, 3, 2, 2)
    mask = dp.sample(x, torch.Generator().manual_seed(1))
    assert mask.shape == (4096, 1, 1, 1)
    y = dp(x, mask)
    kept = y.flatten(1)
    # each sample is all kept (x / 0.75) or all dropped (0)
    per = kept.unique(dim=1)
    assert per.shape[1] == 1 and set(per.flatten().tolist()) <= {0.0, float(np.float32(1 / 0.75))}
    # keep rate ~ 0.75 and the mean preserved (binomial sd 0.0068 at n=4096)
    assert abs(float(mask.float().mean()) - 0.75) < 0.03
    assert abs(float(y.mean()) - 1.0) < 0.04
    # the caller's generator makes it reproducible
    again = dp.sample(x, torch.Generator().manual_seed(1))
    assert torch.equal(mask, again)


def test_drop_path_rates_follow_jax_schedule():
    spec = tc.BackboneConfig()  # MiT-b3, drop_path_rate 0.1, 28 blocks
    net = PersNet(dataclasses.replace(SMALL, backbone=spec))
    blocks = [b for s in range(1, 5) for b in getattr(net.backbone, f"block{s}")]
    want = [0.1 * i / 27 for i in range(28)]
    np.testing.assert_allclose([b.drop_path1.rate for b in blocks], want, rtol=1e-12)
    assert all(b.drop_path1.rate == b.drop_path2.rate for b in blocks)


def test_training_after_inference_in_one_process():
    """Operands a head caches on first use (its phase matrices) are made
    outside inference mode, so a model can train after an inference call
    (under torch.inference_mode) has filled the cache."""
    from perspectivefields_tpu_torch.models.heads import _phase_matrices

    _phase_matrices.cache_clear()
    net = init_random_(PersNet(SMALL), seed=0)
    x = torch.zeros(1, 32, 32, 3)
    with torch.inference_mode():
        net.eval()(x)
    out = net.train()(x)
    (out["pred_gravity"].sum() + out["pred_latitude"].sum()).backward()
    assert all(p.grad is not None for p in net.persformer_heads.parameters())


def test_train_step_uses_deterministic_cudnn_and_restores_it():
    """The step's forward and backward run with cuDNN's deterministic
    algorithms (a seeded run repeats on the card); the caller's setting
    comes back after the step."""
    from perspectivefields_tpu_torch.data import make_step_batch_fn

    cfg = model_config(True, 64)
    net = init_random_(PersNet(cfg), seed=0)
    seen = []
    net.register_forward_hook(lambda *_: seen.append(torch.backends.cudnn.deterministic))
    batch = make_step_batch_fn(1, 2, cfg.resize, device="cpu")(0)
    batch = dict(batch, image=batch["image"] - torch.tensor(cfg.pixel_mean))
    batch.pop("cams")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        make_train_step(cfg)(create_train_state(net), batch)
        assert seen == [True] and torch.backends.cudnn.deterministic is False
    finally:
        torch.backends.cudnn.deterministic = saved


def test_training_mode_keeps_the_state_dict():
    # DropPath has no parameters and remat wraps calls only: the same names
    # and shapes as an inference PersNet, strict loads both ways
    cfg = model_config(True, 64)
    plain = PersNet(cfg).state_dict()
    trained = PersNet(cfg, remat=True).train().state_dict()
    assert list(plain) == list(trained)
    assert all(plain[k].shape == trained[k].shape for k in plain)
    PersNet(cfg, remat=True).load_state_dict(plain, strict=True)


@pytest.mark.parametrize("drop_rate", [0.0, 0.3])
def test_remat_identical_loss_and_grads(drop_rate):
    """remat is a memory trade only: the same loss and gradients as without
    it, with stochastic depth on too (the masks are drawn before the
    recomputed block)."""
    cfg = dataclasses.replace(
        SMALL, resize=(64, 64),
        backbone=dataclasses.replace(SMALL.backbone, drop_path_rate=drop_rate))
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(2, 64, 64, 3)), dtype=torch.float32)
    batch = {"gt_gravity": torch.tensor(rng.normal(size=(2, 64, 64, 2)), dtype=torch.float32),
             "gt_latitude": torch.tensor(rng.uniform(-1, 1, (2, 64, 64, 1)), dtype=torch.float32)}

    def run(remat):
        net = init_random_(PersNet(cfg, remat=remat), seed=0).train()
        loss, _ = losses.total_loss(net(x, generator=torch.Generator().manual_seed(3)), batch, cfg)
        loss.backward()
        return loss, {n: p.grad for n, p in net.named_parameters()}

    l0, g0 = run(False)
    l1, g1 = run(True)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-6, msg=n)


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(6)
    for scale in (0.01, 1.0, 50.0):  # below, near and above the limit
        grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (7,), (2, 2, 5))]
        tx = optax.clip_by_global_norm(1.0)
        want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(grads))
        got = [t(g) for g in grads]
        norm = clip_by_global_norm_(got, 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
        if scale == 0.01:  # under the limit: untouched, bit for bit
            for a, g in zip(got, grads):
                np.testing.assert_array_equal(a.numpy(), g)


def _tiny_pair():
    """The trainer's --tiny config at 64^2 in both packages, stochastic
    depth off."""
    pcfg = model_config(True, 64)
    pcfg = dataclasses.replace(pcfg, backbone=dataclasses.replace(pcfg.backbone,
                                                                  drop_path_rate=0.0))
    jcfg = jax_config.ModelConfig(
        backbone=jax_config.BackboneConfig(**dataclasses.asdict(pcfg.backbone)),
        gravity=jax_config.GravityHeadConfig(**dataclasses.asdict(pcfg.gravity)),
        latitude=jax_config.LatitudeHeadConfig(**dataclasses.asdict(pcfg.latitude)),
        param=jax_config.ParamNetConfig(**dataclasses.asdict(pcfg.param)),
        recover_rpf=True, resize=(64, 64),
    )
    return jcfg, pcfg


def _opt_moments(opt_state):
    """(mu, nu) of the ScaleByAdamState inside an optax state."""
    for node in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda n: hasattr(n, "mu")):
        if hasattr(node, "mu"):
            return node.mu, node.nu
    raise AssertionError("no Adam state")


@pytest.fixture(scope="module")
def three_steps():
    """Three train steps of both packages from the same weights on JAX's
    batches. The weights are drawn in the port (JAX's init scheme; JAX's
    own init costs a 20 s compile here), written as a JAX param tree by
    ``state_dict_to_jax`` and read back by ``state_dict_from_jax``; JAX's
    optimizer is create_train_state's (clip 1.0, then adamw). The latitude
    head's prediction conv is shrunk 100x (as chip_smoke.seeded_state_dict
    does): at random init the head sits deep in its clamp, where the
    overflow penalty's 300-fold loss turns Adam's lr-scale noise on
    near-zero gradients into loss noise."""
    jcfg, pcfg = _tiny_pair()
    sd = init_random_(PersNet(pcfg), seed=0).state_dict()
    for key in ("weight", "bias"):
        sd[f"persformer_heads.latitude_head.linear_pred_latitude.{key}"] *= 0.01
    params = state_dict_to_jax(sd)
    jm = JaxPersNet(jcfg)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR, weight_decay=1e-2))
    state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    net = PersNet(pcfg)
    net.load_state_dict(state_dict_from_jax(params), strict=True)
    ps = create_train_state(net, learning_rate=LR)
    jstep, pstep = jax_make_train_step(jm, tx, jcfg), make_train_step(pcfg)
    mean = jnp.asarray(jcfg.pixel_mean)
    it = jax_data_iterator(jax.random.PRNGKey(1), batch_size=2, im_hw=(64, 64))
    rows = []
    for _ in range(3):
        b = next(it)
        b = {k: v for k, v in dict(b, image=b["image"] - mean).items() if k != "cams"}
        state, mj = jstep(state, b)
        ps, mp = pstep(ps, {k: t(v) for k, v in b.items()})
        mu, nu = (state_dict_from_jax(jax.device_get({"params": m["params"]}))
                  for m in _opt_moments(state.opt_state))
        opt = ps.optimizer
        names = {id(p): n for n, p in net.named_parameters()}
        moments = {names[id(p)]: (opt.state[p]["exp_avg"].clone(), opt.state[p]["exp_avg_sq"].clone())
                   for p in net.parameters()}
        rows.append((
            {k: float(v) for k, v in mj.items()}, {k: float(v) for k, v in mp.items()},
            state_dict_from_jax(jax.device_get(state.params)),
            {k: v.detach().clone() for k, v in net.state_dict().items()},
            (mu, nu), moments,
        ))
    return rows


def test_first_step_clipped_gradients_match_jax(three_steps):
    """After the first step Adam's moments are m = 0.1 g and v = 0.001 g^2
    of the clipped gradient g: both packages' g within 1e-5 of its global
    norm (1 after the clip)."""
    (mu, nu), moments = three_steps[0][4], three_steps[0][5]
    assert set(moments) == set(mu)
    for n, (m, v) in moments.items():
        np.testing.assert_allclose(m.numpy() / 0.1, mu[n].numpy() / 0.1, rtol=0, atol=1e-5,
                                   err_msg=n)
        np.testing.assert_allclose(np.sqrt(v.numpy() / 1e-3), np.sqrt(nu[n].numpy() / 1e-3),
                                   rtol=0, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("steps", [1, 3])
def test_tiny_train_steps_match_jax(three_steps, steps):
    mj, mp, pj, pp = three_steps[steps - 1][:4]
    assert set(mp) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mp[k], mj[k], rtol=LOSS_RTOL, err_msg=k)
    for k in pj:
        np.testing.assert_allclose(pp[k].numpy(), pj[k].numpy(), rtol=0,
                                   atol=0.1 * LR * steps, err_msg=k)


def test_learning_rate_schedule_and_train_loop():
    """A callable learning rate is read at each step (optax's count: step k
    updates with lr(k)); make_train_loop stacks chunk steps' metrics and
    feeds batch_fn the absolute step."""
    cfg = dataclasses.replace(SMALL, resize=(32, 32))
    net = init_random_(PersNet(cfg), seed=0)
    seen, lrs = [], []
    state = create_train_state(net, learning_rate=lambda k: lrs.append(k) or 1e-3 / (k + 1))
    rng = np.random.default_rng(0)
    batch = {"image": torch.tensor(rng.normal(size=(1, 32, 32, 3)), dtype=torch.float32),
             "gt_gravity": torch.tensor(rng.normal(size=(1, 32, 32, 2)), dtype=torch.float32),
             "gt_latitude": torch.tensor(rng.uniform(-1, 1, (1, 32, 32, 1)), dtype=torch.float32)}
    loop = make_train_loop(cfg, lambda step: seen.append(step) or batch, chunk=3)
    state, metrics = loop(state)
    state, metrics = loop(state)
    assert state.step == 6 and seen == list(range(6))
    assert metrics["loss"].shape == (3,) and torch.isfinite(metrics["loss"]).all()
    assert lrs[-6:] == list(range(6))
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3 / 6)


# ---------------------------------------------------------------------------
# F1: the kernels refuse to run under autograd
# ---------------------------------------------------------------------------

KERNEL_WRAPPERS = {
    "fused_attention": lambda m, x: m.fused_attention(x, x, x, x, x, x, x, x, 1, 0.125),
    "stage1_attention": lambda m, x: m.stage1_attention(x, x, x, x, x, x, x, x, 0.125),
    "mixffn": lambda m, x: m.mixffn(x, x, x, x, x, x, x),
    "convnext_block": lambda m, x: m.convnext_block(x, x, x, x, x, x, x, x, x, x),
    "decoder_tail": lambda m, x: m.decoder_tail(x, x, x, x, x, x, x, x),
    "fused_block": lambda m, x: m.fused_block(x, x, x, x, x, x, x, x, x, x, x, x, x, x, x, x, x,
                                              1, 0.125, 1, 1),
}


def test_check_inference_only_helper():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        check_inference_only("k", torch.zeros(2), x)
    check_inference_only("k", torch.zeros(2), None)  # nothing needs a gradient
    with torch.no_grad():
        check_inference_only("k", x)
    with torch.inference_mode():
        check_inference_only("k", torch.zeros(2))


@pytest.mark.parametrize("name", sorted(KERNEL_WRAPPERS))
def test_kernel_wrappers_refuse_autograd_off_the_cpu(name):
    """Every non-CPU tensor goes through the guard before any launch: a
    tensor that needs a gradient raises (meta tensors stand in for CUDA
    ones here); without grad mode the wrapper goes on (to its device
    check on meta)."""
    mod = importlib.import_module(f"perspectivefields_tpu_torch.kernels.{name}")
    x = torch.zeros(1, 4, 4, 64, device="meta", requires_grad=True)
    launches = mod.LAUNCHES
    with pytest.raises(RuntimeError, match="inference-only"):
        KERNEL_WRAPPERS[name](mod, x)
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel for device"):
        KERNEL_WRAPPERS[name](mod, x)
    assert mod.LAUNCHES == launches


def test_kernel_plain_versions_stay_differentiable_on_the_cpu():
    """The CPU path is the plain version, unchanged: a backbone with every
    kernel flag on trains on the CPU and gives the plain backbone's
    gradients (a well-conditioned objective: the stage outputs' mean
    squares)."""
    cfg = dataclasses.replace(SMALL, backbone=tc.BackboneConfig(
        dims=(64, 128, 128, 128), depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2),
        drop_path_rate=0.0))
    x = torch.tensor(np.random.default_rng(0).normal(size=(1, 32, 32, 3)), dtype=torch.float32)
    grads = []
    for flags in ({}, dict(use_kernels=True, fuse_ffn=True, fuse_block=True)):
        net = init_random_(PersNet(cfg, **flags), seed=0).train()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            feats = net.backbone(x)
        sum(f.square().mean() for f in feats).backward()
        grads.append({n: p.grad for n, p in net.backbone.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=1e-4, atol=1e-6, msg=n)
