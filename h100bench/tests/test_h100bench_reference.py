"""The plain reference against the port at a tiny size on the CPU, with the
same weights and inputs, and the configuration files against the port's
own configurations."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from h100bench import harness
from h100bench.drivers import common
from h100bench.reference import model as ref_model
from h100bench.reference import preprocess as ref_pre
from h100bench.tests import tiny

CONFIGS = {c["name"]: json.loads((harness.ROOT / c["file"]).read_text())
           for c in harness.load_benchmark()["configs"]}


def test_flagship_file_is_the_ports_zoo_entry():
    from perspectivefields_tpu_torch.config import model_zoo

    name = "Paramnet-360Cities-edina-centered"
    got = common.port_config(CONFIGS[name])
    assert got == model_zoo[name]["config"].__class__(
        **{**model_zoo[name]["config"].__dict__, "version": name})


def test_trainer_file_is_the_trainers_model():
    from perspectivefields_tpu_torch.tools.train import model_config

    got = common.port_config(CONFIGS["trainer-mitb3-regress320"])
    want = model_config(tiny=False, size=320)
    assert got.__class__(**{**got.__dict__, "version": "custom"}) == want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weights_carry_the_ports_state_dict_names(name):
    from perspectivefields_tpu_torch.models import PersNet

    cfg = CONFIGS[name]
    with torch.device("meta"):
        port = PersNet(common.port_config(cfg)).state_dict()
        ref = ref_model.PersNet(cfg["model"]).state_dict()
    assert {k: tuple(v.shape) for k, v in port.items()} == {k: tuple(v.shape) for k, v in ref.items()}


@pytest.mark.parametrize("hw", [(96, 128), (480, 640), (37, 53), (200, 150)])
def test_pillow_resize_is_the_ports_bit_for_bit(hw):
    from perspectivefields_tpu_torch import native

    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    for out in ((64, 64), (320, 320)):
        want = native.pil_resize_uint8(img, *out)
        got = ref_pre.pil_resize(torch.from_numpy(img), *out).numpy()
        assert np.array_equal(got, want)


def test_postprocess_is_the_ports():
    from perspectivefields_tpu_torch.ops.postprocess import postprocess_gravity, postprocess_latitude

    g = torch.nn.functional.normalize(torch.randn(2, 32, 32, 2), dim=-1)
    lat = torch.rand(2, 32, 32, 1) * 1.8 - 0.9
    rg, rl = ref_pre.postprocess(g, lat, 45, 70)
    assert torch.allclose(rg, postprocess_gravity(g, (32, 32), 45, 70), atol=1e-6)
    assert torch.allclose(rl, postprocess_latitude(lat, (32, 32), 45, 70), atol=1e-4)


@pytest.mark.parametrize("workload", ["flagship.batch32", "flagship.single", "flagship.stream"])
def test_inference_agrees_with_the_reference_in_float32(workload):
    run, line = tiny.run(workload)
    assert run.checks and run.ctx["compared"] > 0
    assert all(v < 1e-3 for v in run.ctx["gaps"].values()), run.ctx["gaps"]
    assert line["correct"], line


def test_training_steps_agree_with_the_reference_in_float32():
    """The same losses, stochastic-depth masks, clip and AdamW."""
    run, line = tiny.run("trainer.b16")
    numbers = {k: c["value"] for k, c in run.checks.items()} | run.ctx["detail"]["not_compared"]
    assert numbers["loss_rel"] < 1e-5 and numbers["loss1_rel"] < 1e-5
    assert numbers["grad_leaf"] < 1e-4 and numbers["grad_median_leaf"] < 1e-4
    assert numbers["change_leaf"] < 1e-3 and numbers["change_median_leaf"] < 1e-3
    assert line["correct"], line


def test_roundings():
    x = torch.randn(1000)
    fp8, bf16 = ref_model.Rounding("fp8")(x), ref_model.Rounding("bf16")(x)
    assert not torch.equal(x, fp8) and not torch.equal(x, bf16)
    assert (fp8 - x).abs().max() <= x.abs().max() / 16
    assert torch.equal(bf16, x.to(torch.bfloat16).float())
    assert torch.equal(ref_model.Rounding()(x), x)


@pytest.mark.parametrize("mode", ["bf16", "fp8"])
def test_rounded_products_keep_their_gradients(mode):
    """The control rounds the gradient that enters each product with a
    scale of its own, so gradients far below 1 are not flushed to 0."""
    torch.manual_seed(0)
    x, w = torch.randn(64, 32), torch.randn(16, 32) / 32**0.5
    grads = []
    for rnd in (ref_model.Rounding(), ref_model.Rounding(mode)):
        lin = ref_model.Linear(rnd, 32, 16)
        with torch.no_grad():
            lin.weight.copy_(w)
            lin.bias.zero_()
        (lin(x).square().sum() * 1e-9).backward()
        grads.append(lin.weight.grad)
    exact, rounded = grads
    assert exact.abs().max() < 1e-6 and rounded.ne(0).float().mean() > 0.99
    assert (rounded - exact).norm() / exact.norm() < (0.05 if mode == "bf16" else 0.3)
