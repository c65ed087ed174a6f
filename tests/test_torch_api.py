"""The port's PerspectiveFields against the JAX package's, end to end on CPU.

A custom config with MiT-b3 widths (dims 64/128/320/512, heads 1/2/5/8) at
depth 1/1/1/1, narrow heads and the "ParamNet" branch at a 64^2 network
input: the same random weights (the JAX init, carried across with
``flax_to_torch_names``) and the same uint8 images go through both, on the
default path, with fuse_ffn + fuse_convnext, and with fuse_block.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from perspectivefields_tpu import PerspectiveFields as JaxPerspectiveFields
from perspectivefields_tpu.checkpoint import torch_convert
from perspectivefields_tpu.config import model_zoo as jax_model_zoo
from perspectivefields_tpu.models import mit as jax_mit
from perspectivefields_tpu.config import (
    BackboneConfig,
    GravityHeadConfig,
    LatitudeHeadConfig,
    ModelConfig,
    ParamNetConfig,
)
from perspectivefields_tpu_torch import PerspectiveFields, checkpoint, native
from perspectivefields_tpu_torch.config import model_zoo
from perspectivefields_tpu_torch.ops.image import pil_resize_uint8
from perspectivefields_tpu_torch.ops.codec import decode_bin
from perspectivefields_tpu_torch.ops.postprocess import (
    pf_postprocess,
    postprocess_gravity,
    postprocess_latitude,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = ModelConfig(
    version="custom",
    backbone=BackboneConfig(depths=(1, 1, 1, 1)),
    gravity=GravityHeadConfig(loss_type="regression", embed_dim=32, fusion_dim=32),
    latitude=LatitudeHeadConfig(loss_type="regression", embed_dim=32, fusion_dim=32),
    param=ParamNetConfig(name="ParamNet"),
    recover_rpf=True,
    resize=(64, 64),
)
PARAM_KEYS = (
    "pred_roll", "pred_pitch", "pred_vfov", "pred_general_vfov",
    "pred_rel_cx", "pred_rel_cy", "pred_rel_focal",
)
# PersNet-360Cities's heads (73 / 180 classes, no ParamNet) at CFG's size
CLS_CFG = dataclasses.replace(
    CFG,
    gravity=GravityHeadConfig(loss_type="classification", num_classes=73, embed_dim=32, fusion_dim=32),
    latitude=LatitudeHeadConfig(loss_type="classification", num_classes=180, embed_dim=32,
                                fusion_dim=32),
    param=None, recover_rpf=False,
)
# the *-uncentered versions' ParamNetConvNextRegress; 32 is the least input
# ConvNeXt's four downsamplings take
REGRESS_CFG = dataclasses.replace(
    CFG,
    param=ParamNetConfig(name="ParamNetConvNextRegress",
                         predict_params=("roll", "pitch", "general_vfov", "rel_cx", "rel_cy"),
                         input_size=32),
    recover_pp=True,
)


@pytest.fixture(scope="module")
def jax_model():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-init warning
        model = JaxPerspectiveFields("custom", config=CFG)
    # Random init drives the latitude head to ~30x past its clamp at +-1,
    # where asin's slope is unbounded and one f32 ulp moves 0.02 degrees.
    # Shrink its prediction conv (in both models) so the degree comparison
    # measures the port rather than that singularity.
    head = model.params["params"]["latitude_head"]["linear_pred"]
    head["kernel"] = head["kernel"] * 0.01  # |sin(lat)| <= ~0.3
    return model


@pytest.fixture(scope="module")
def torch_model(jax_model):
    return PerspectiveFields("custom", config=CFG, params=jax_model.params, device="cpu")


@pytest.fixture(scope="module")
def jax_fused_model(jax_model):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxPerspectiveFields(
            "custom", config=CFG, params=jax_model.params, fuse_ffn=True, fuse_convnext=True
        )


@pytest.fixture(scope="module")
def torch_fused_model(jax_model):
    return PerspectiveFields(
        "custom", config=CFG, params=jax_model.params, device="cpu", fuse_ffn=True,
        fuse_convnext=True,
    )


@pytest.fixture(scope="module")
def torch_block_model(jax_model):
    return PerspectiveFields(
        "custom", config=CFG, params=jax_model.params, device="cpu", fuse_block=True
    )


def _images():
    rng = np.random.default_rng(0)
    return [
        rng.integers(0, 256, size=(96, 96, 3), dtype=np.uint8),
        rng.integers(0, 256, size=(48, 80, 3), dtype=np.uint8),
    ]


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "pred_latitude_original_mode":
            assert got[key] == w == "deg"
            continue
        w = np.asarray(w, np.float32)
        assert got[key].shape == w.shape, key
        # tests/test_reference_parity.py's tolerances: 5e-4 on unit-scale
        # fields, 1e-3 on degrees and camera parameters
        atol = 5e-4 if key in ("pred_gravity", "pred_latitude", "pred_gravity_original") else 1e-3
        np.testing.assert_allclose(got[key], w, atol=atol, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("call", ["mixed_sizes_batch", "single_square", "single_48x80"])
def test_slice_matches_jax(jax_model, torch_model, call):
    square, rect = _images()
    if call == "mixed_sizes_batch":  # host resize per image, grouped postprocess
        got = torch_model.inference_batch([square, rect])
        want = jax_model.inference_batch([square, rect])
    else:  # a uniform uint8 batch: the native fused preprocess
        img = square if call == "single_square" else rect
        got, want = [torch_model.inference(img)], [jax_model.inference(img)]
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_fused_slice_matches_jax(jax_fused_model, torch_fused_model):
    """fuse_ffn + fuse_convnext on both sides: the JAX Pallas kernels run in
    interpret mode off-TPU, the port's wrappers their plain versions; a
    mixed-size batch (host resize per image, grouped postprocess)."""
    model = torch_fused_model.model
    assert all(b.mlp.fused for s in range(1, 5) for b in getattr(model.backbone, f"block{s}"))
    assert all(b.fused for stage in model.param_net.backbone.stages for b in stage)
    imgs = list(_images())
    for g, w in zip(torch_fused_model.inference_batch(imgs), jax_fused_model.inference_batch(imgs)):
        _assert_same(g, w)


def test_fuse_block_slice_matches_jax(jax_model, torch_block_model, monkeypatch):
    """fuse_block on both sides: JAX's Block takes its fused branch (backend
    gate opened; its kernel wrapper runs the XLA composition off-TPU), the
    port's every block (CFG's 64^2 input keeps all four stages under JAX's
    gate) runs fused_block's plain version; a mixed-size batch."""
    monkeypatch.setattr(jax_mit, "_fused_backend_ok", lambda: True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_block = JaxPerspectiveFields(
            "custom", config=CFG, params=jax_model.params, fuse_block=True
        )
    backbone = torch_block_model.model.backbone
    routes = [blk.route(2, 64 // 2 ** (s + 1), 64 // 2 ** (s + 1), torch.device("cpu"))
              for s in range(1, 5) for blk in getattr(backbone, f"block{s}")]
    assert routes == ["fused_block"] * 4
    imgs = list(_images())
    for g, w in zip(torch_block_model.inference_batch(imgs), jax_block.inference_batch(imgs)):
        _assert_same(g, w)


def _version_pair(cfg, param_head_bias=None):
    """A JAX model of ``cfg`` from its seeded init and the port's from the
    same weights. Regression latitude heads are shrunk as in ``jax_model``;
    ``param_head_bias`` sets ParamNet's last layer to a small kernel and
    that bias, so the general vFoV sits inside (0, 180) degrees, where the
    focal is defined."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = JaxPerspectiveFields("custom", config=cfg)
    params = jm.params["params"]
    if cfg.latitude.loss_type == "regression":
        head = params["latitude_head"]["linear_pred"]
        head["kernel"] = head["kernel"] * 0.01
    if param_head_bias is not None:
        head = params["param_net"]["backbone"]["head"]
        head["kernel"] = head["kernel"] * 0.1
        head["bias"] = head["bias"] * 0 + param_head_bias
    return jm, PerspectiveFields("custom", config=cfg, params=jm.params, device="cpu")


@pytest.fixture(scope="module")
def cls_models():
    return _version_pair(CLS_CFG)


@pytest.fixture(scope="module")
def regress_models():
    return _version_pair(REGRESS_CFG, param_head_bias=0.5)


def test_classification_version_matches_jax(cls_models):
    """PersNet-360Cities's heads: the raw logits against JAX's, and the port's
    decode (argmax, bin centre, resize) of JAX's own logits against JAX's
    fields, so that an argmax near-tie cannot flip between the two."""
    jm, tm = cls_models
    imgs = list(_images())
    for img, g, w in zip(imgs, tm.inference_batch(imgs), jm.inference_batch(imgs)):
        assert set(g) == set(w)
        assert g["pred_gravity"].shape == (64, 64, 73) and g["pred_latitude"].shape == (64, 64, 180)
        for key in ("pred_gravity", "pred_latitude"):
            np.testing.assert_allclose(g[key], np.asarray(w[key]), atol=5e-4, rtol=1e-4, err_msg=key)
        oh, ow = img.shape[:2]
        logits = {k: torch.from_numpy(np.array(w[k], np.float32))[None]
                  for k in ("pred_gravity", "pred_latitude")}
        grav = postprocess_gravity(logits["pred_gravity"], CLS_CFG.resize, oh, ow, "classification", 73)
        lat = postprocess_latitude(logits["pred_latitude"], CLS_CFG.resize, oh, ow, "classification", 180)
        # the renormalise divides by the resized field's norm, which nearly
        # vanishes where neighbouring bins point opposite ways (1e-7 here):
        # hold the unit vectors where that norm is at least 1e-3
        vec = decode_bin(logits["pred_gravity"].argmax(-1), 73) * torch.tensor([ow / 64, oh / 64])
        kept = torch.linalg.vector_norm(pf_postprocess(vec, CLS_CFG.resize, oh, ow), dim=-1)[0] >= 1e-3
        assert kept.float().mean() > 0.99
        np.testing.assert_allclose(grav[0][kept].numpy(), w["pred_gravity_original"][kept.numpy()],
                                   atol=5e-4)
        np.testing.assert_allclose(lat[0].numpy(), w["pred_latitude_original"], atol=1e-3)
        assert g["pred_gravity_original"].shape == (oh, ow, 2)
        assert g["pred_latitude_original"].shape == (oh, ow)
        assert g["pred_latitude_original_mode"] == "deg"


def test_regress_paramnet_version_matches_jax(regress_models):
    """The *-uncentered versions' ParamNetConvNextRegress with its backfill:
    the same key set as JAX (general vFoV and principal point, no pred_vfov,
    no pred_rel_pp) and the same values."""
    jm, tm = regress_models
    assert tm.cfg.param.name == "ParamNetConvNextRegress" and tm.cfg.recover_pp
    imgs = list(_images())
    for g, w in zip(tm.inference_batch(imgs), jm.inference_batch(imgs)):
        _assert_same(g, w)
        assert "pred_vfov" not in g and "pred_rel_pp" not in g
        assert {"pred_general_vfov", "pred_rel_cx", "pred_rel_cy", "pred_rel_focal"} <= set(g)


def test_fused_flags_default_off_and_keep_the_state_dict(
    torch_model, torch_fused_model, torch_block_model
):
    assert not torch_model.fuse_ffn and not torch_model.fuse_convnext
    assert not torch_model.fuse_block and torch_block_model.fuse_block
    plain_sd = torch_model.model.state_dict()
    for other in (torch_fused_model, torch_block_model):
        fused_sd = other.model.state_dict()
        assert list(plain_sd) == list(fused_sd)
        assert all(torch.equal(plain_sd[k], fused_sd[k]) for k in plain_sd)


def test_model_zoo_copy_matches_jax():
    assert list(model_zoo) == list(jax_model_zoo)
    for version, entry in model_zoo.items():
        want = jax_model_zoo[version]
        assert entry["description"] == want["description"]
        assert dataclasses.asdict(entry["config"]) == dataclasses.asdict(want["config"]), version


def test_checkpoint_name_maps_match_jax(jax_model):
    """The port's copies of flax_to_torch_names and map_torch_name equal the
    JAX package's on a random tree of the whole model."""
    rng = np.random.default_rng(7)
    tree = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jax_model.params)
    got, want = checkpoint.flax_to_torch_names(tree), torch_convert.flax_to_torch_names(tree)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
        assert checkpoint.map_torch_name(name) == torch_convert.map_torch_name(name)
    for name in ("ll_enc.bn1.num_batches_tracked", "pixel_mean"):
        assert checkpoint.map_torch_name(name) is torch_convert.map_torch_name(name) is None


def test_output_contract(torch_model):
    _, rect = _images()
    pred = torch_model.inference(rect)
    assert pred["pred_gravity"].shape == (64, 64, 2)
    assert pred["pred_latitude"].shape == (64, 64, 1)
    assert pred["pred_gravity_original"].shape == (48, 80, 2)
    assert pred["pred_latitude_original"].shape == (48, 80)
    assert pred["pred_latitude_original_mode"] == "deg"
    for key in PARAM_KEYS:
        assert isinstance(pred[key], np.ndarray) and pred[key].shape == (), key
    np.testing.assert_allclose(
        np.linalg.norm(pred["pred_gravity_original"], axis=-1), 1.0, atol=1e-4
    )
    assert np.abs(pred["pred_latitude_original"]).max() <= 90.0 + 1e-3
    cf = torch_model.inference(rect, channels_first=True)
    assert cf["pred_gravity"].shape == (2, 64, 64)
    assert cf["pred_gravity_original"].shape == (2, 48, 80)
    np.testing.assert_array_equal(cf["pred_gravity"], np.moveaxis(pred["pred_gravity"], -1, 0))


def test_batch_groups_mixed_sizes(torch_model):
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, size=s, dtype=np.uint8) for s in ((40, 60, 3), (30, 30, 3), (40, 60, 3))]
    preds = torch_model.inference_batch(imgs)
    assert [p["pred_gravity_original"].shape for p in preds] == [(40, 60, 2), (30, 30, 2), (40, 60, 2)]
    single = torch_model.inference(imgs[1])
    np.testing.assert_allclose(preds[1]["pred_gravity_original"], single["pred_gravity_original"], atol=1e-5)


def test_forward_raw_matches_inference(torch_model):
    img = np.random.default_rng(3).integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    raw = torch_model.forward(img[None])
    assert isinstance(raw["pred_gravity"], torch.Tensor)
    np.testing.assert_allclose(
        raw["pred_gravity"][0].numpy(), torch_model.inference(img)["pred_gravity"], atol=1e-5
    )


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerspectiveFields("custom", config=CFG)


def test_kernel_default_and_gate_stay_off_the_cpu(jax_model):
    model = PerspectiveFields(
        "custom", config=CFG, params=jax_model.params, device="cpu",
        compute_dtype="bfloat16",
    )
    assert model.use_kernels is False  # default: CUDA device and bf16 only
    forced = PerspectiveFields(
        "custom", config=CFG, params=jax_model.params, device="cpu", use_kernels=True
    )
    from perspectivefields_tpu_torch.kernels import fused_attention as fa

    before = fa.LAUNCHES
    forced.inference(_images()[0])
    assert fa.LAUNCHES == before  # the gate never routes a CPU tensor


def test_bfloat16_stores_bf16_weights_and_tracks_f32(jax_model, torch_model):
    bf = PerspectiveFields(
        "custom", config=CFG, params=jax_model.params, device="cpu",
        compute_dtype="bfloat16",
    )
    floats = [t for t in bf.model.state_dict().values() if t.is_floating_point()]
    assert floats and all(t.dtype == torch.bfloat16 for t in floats)
    img = _images()[0]
    ref, got = torch_model.inference(img), bf.inference(img)
    dot = np.clip(np.sum(ref["pred_gravity_original"] * got["pred_gravity_original"], -1), -1, 1)
    assert np.degrees(np.arccos(dot)).mean() < 5.0  # direction agreement only


def test_released_pth_path_loads_the_same_weights(torch_model, tmp_path):
    path = tmp_path / "release.pth"
    torch.save({"model": torch_model.model.state_dict()}, path)
    loaded = PerspectiveFields("custom", config=CFG, params=str(path), device="cpu")
    img = _images()[1]
    np.testing.assert_array_equal(
        loaded.inference(img)["pred_gravity_original"],
        torch_model.inference(img)["pred_gravity_original"],
    )


def test_unknown_version_raises():
    with pytest.raises(ValueError, match="unknown version"):
        PerspectiveFields("not-a-model", device="cpu")


def test_versions_prints(capsys):
    PerspectiveFields.versions()
    assert "Paramnet-360Cities-edina-centered" in capsys.readouterr().out


def test_native_preprocess_is_bit_exact_pil():
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, size=(3, 96, 120, 3), dtype=np.uint8)
    mean, std = np.array([103.53, 116.28, 123.675], np.float32), np.array([1.0, 2.0, 4.0], np.float32)
    got = native.preprocess_batch(imgs, 64, 64, mean, std)
    want = np.stack([(pil_resize_uint8(im, 64, 64).astype(np.float32) - mean) / std for im in imgs])
    np.testing.assert_array_equal(got, want)
    assert native.backend() in ("native", "numpy")


def test_port_runs_without_jax():
    """The card's machine has no JAX: import the port and chip_smoke's
    imports, and run tiny CPU forwards with the fused flags, with jax,
    flax and the JAX package made unimportable."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'perspectivefields_tpu'): sys.modules[name] = None\n"
        "import numpy as np, warnings\n"
        "import chip_smoke\n"
        "import perspectivefields_tpu_torch.kernels.decoder_tail\n"
        "from perspectivefields_tpu_torch.kernels import decoder_tail\n"
        "from perspectivefields_tpu_torch.config import *\n"
        "from perspectivefields_tpu_torch import PerspectiveFields\n"
        "cfg = ModelConfig(version='custom', backbone=BackboneConfig(dims=(64, 128, 192, 256), "
        "depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4)), "
        "gravity=GravityHeadConfig(loss_type='regression', embed_dim=16, fusion_dim=16), "
        "latitude=LatitudeHeadConfig(loss_type='regression', embed_dim=16, fusion_dim=16), "
        "param=ParamNetConfig(name='ParamNet'), recover_rpf=True, resize=(32, 32))\n"
        "warnings.simplefilter('ignore')\n"
        "m = PerspectiveFields('custom', config=cfg, device='cpu', fuse_ffn=True, fuse_convnext=True)\n"
        "p = m.inference(np.zeros((40, 50, 3), np.uint8))\n"
        "assert p['pred_gravity_original'].shape == (40, 50, 2)\n"
        "m = PerspectiveFields('custom', config=cfg, device='cpu', fuse_block=True)\n"
        "assert m.model.backbone.block4[0].route(1, 1, 1, 'cpu') == 'fused_block'\n"
        "p = m.inference(np.zeros((40, 50, 3), np.uint8))\n"
        "assert np.isfinite(p['pred_gravity_original']).all()\n"
        "import dataclasses\n"
        "cls = dataclasses.replace(cfg, param=None, recover_rpf=False, "
        "gravity=GravityHeadConfig(loss_type='classification', embed_dim=16, fusion_dim=16), "
        "latitude=LatitudeHeadConfig(loss_type='classification', num_classes=180, embed_dim=16, "
        "fusion_dim=16))\n"
        "p = PerspectiveFields('custom', config=cls, device='cpu').inference(np.zeros((40, 50, 3), np.uint8))\n"
        "assert p['pred_latitude'].shape == (32, 32, 180)\n"
        "reg = dataclasses.replace(cfg, param=ParamNetConfig(input_size=32), recover_pp=True)\n"
        "p = PerspectiveFields('custom', config=reg, device='cpu', fuse_convnext=True).inference("
        "np.zeros((40, 50, 3), np.uint8))\n"
        "assert np.isfinite(p['pred_rel_focal'])\n"
        "loaded = [k for k in sys.modules if sys.modules[k] is not None]\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax')) for k in loaded)\n"
        "assert not any(k.split('.')[0] == 'perspectivefields_tpu' for k in loaded)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_jax_stays_on_cpu_here():
    # the parity above ran JAX on the CPU (tests/conftest.py), not a chip
    assert jax.default_backend() == "cpu"
