"""The port's PerspectiveFields against the JAX package's, end to end on CPU.

A custom config with MiT-b3 widths (dims 64/128/320/512, heads 1/2/5/8) at
depth 1/1/1/1, narrow heads and the "ParamNet" branch at a 64^2 network
input: the same random weights (the JAX init, carried across with
``flax_to_torch_names``) and the same uint8 images go through both, on the
default path, with fuse_ffn + fuse_convnext, and with fuse_block.
"""

import dataclasses
import importlib
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from perspectivefields_tpu import PerspectiveFields as JaxPerspectiveFields
from perspectivefields_tpu.checkpoint import io as jax_io
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
from perspectivefields_tpu_torch import api as torch_api
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


@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("cuda")])
def test_cuda_device_raises_without_a_card(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerspectiveFields("custom", config=CFG, device=device)


def test_kernel_default_and_gate_stay_off_the_cpu(jax_model):
    model = PerspectiveFields(
        "custom", config=CFG, params=jax_model.params, device="cpu",
        compute_dtype="bfloat16",
    )
    assert model.use_kernels is False  # default: CUDA device and bf16 only
    forced = PerspectiveFields(
        "custom", config=CFG, params=jax_model.params, device="cpu", use_kernels=True
    )
    fa = importlib.import_module("perspectivefields_tpu_torch.kernels.fused_attention")

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


def _weights_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(torch_api, "_WEIGHTS_DIR", str(tmp_path))
    return tmp_path


def _write_corrupt(path, kind):
    """A file that fails to parse: garbage bytes, or a real archive cut in
    half (a truncated download)."""
    if kind == "garbage":
        path.write_bytes(b"<html>captive portal</html>")
    else:
        full = path.with_name("full" + path.suffix)
        if path.suffix == ".npz":
            np.savez_compressed(full, a=np.arange(4096, dtype=np.float32))
        else:
            torch.save({"model": {"w": torch.arange(4096.0)}}, full)
        data = full.read_bytes()
        path.write_bytes(data[: len(data) // 2])


@pytest.mark.parametrize("kind", ["garbage", "truncated"])
@pytest.mark.parametrize("suffix", [".npz", ".pth"])
def test_corrupt_cached_weights_are_quarantined(monkeypatch, tmp_path, suffix, kind):
    """A corrupt cached <version>.npz or .pth warns, is renamed .corrupt, and
    the constructor falls through to random init (JAX: _init_params)."""
    wdir = _weights_dir(monkeypatch, tmp_path)
    path = wdir / f"custom{suffix}"
    _write_corrupt(path, kind)
    with pytest.warns(UserWarning) as record:
        model = PerspectiveFields("custom", config=CFG, device="cpu")
    text = " ".join(str(w.message) for w in record)
    assert "failed to load" in text and "random initialization" in text
    assert not path.exists() and (wdir / f"custom{suffix}.corrupt").exists()
    seeded = torch_api.PersNet(CFG)
    torch_api.init_random_(seeded, seed=0)
    for name, value in seeded.state_dict().items():
        torch.testing.assert_close(model.model.state_dict()[name], value, rtol=0, atol=0)


def test_corrupt_npz_falls_through_to_the_pth(monkeypatch, tmp_path, torch_model):
    wdir = _weights_dir(monkeypatch, tmp_path)
    _write_corrupt(wdir / "custom.npz", "truncated")
    torch.save({"model": torch_model.model.state_dict()}, wdir / "custom.pth")
    with pytest.warns(UserWarning, match="failed to load"):
        loaded = PerspectiveFields("custom", config=CFG, device="cpu")
    assert (wdir / "custom.npz.corrupt").exists() and (wdir / "custom.pth").exists()
    img = _images()[1]
    np.testing.assert_array_equal(
        loaded.inference(img)["pred_gravity_original"],
        torch_model.inference(img)["pred_gravity_original"],
    )


def test_user_passed_corrupt_path_is_not_guarded(tmp_path):
    path = tmp_path / "mine.npz"
    _write_corrupt(path, "garbage")
    with pytest.raises(ValueError):
        PerspectiveFields("custom", config=CFG, params=str(path), device="cpu")
    assert path.exists()


@pytest.mark.parametrize("how", ["cached", "path"])
def test_jax_npz_loads_and_matches_jax(monkeypatch, tmp_path, jax_model, how):
    """An .npz written by the JAX package's save_params, found in the
    weights directory or passed as a path: the same forward as JAX's from
    the same tree, f32."""
    wdir = _weights_dir(monkeypatch, tmp_path)
    jax_io.save_params(jax_model.params, str(wdir / "custom.npz"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no random-init warning
        model = PerspectiveFields(
            "custom", config=CFG, device="cpu",
            params=None if how == "cached" else str(wdir / "custom.npz"),
        )
    images = _images()
    _assert_same(model.inference_batch(images)[0], jax_model.inference_batch(images)[0])


def test_unflatten_copy_matches_jax():
    flat = {"params/a/kernel": np.ones(2), "params/a/bias": np.zeros(1),
            "params/b/c/scale": np.arange(3), "top": np.float32(1.0)}
    got, want = checkpoint._unflatten(flat), jax_io._unflatten(flat)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g is w


def test_bfloat16_outputs_are_float32(jax_model):
    """In bf16 the port returns every output as float32 numpy, where JAX
    returns the network-size fields and parameters as bfloat16 (the
    documented difference; the _original fields are float32 in both)."""
    bf = PerspectiveFields("custom", config=CFG, params=jax_model.params, device="cpu",
                           compute_dtype="bfloat16")
    pred = bf.inference(_images()[0])
    for key, value in pred.items():
        if key != "pred_latitude_original_mode":
            assert np.asarray(value).dtype == np.float32, key
    assert "pred_roll" in pred and "pred_gravity" in pred


def test_npz_loads_without_jax(tmp_path, jax_model):
    """The card's machine has no JAX: a JAX .npz loads with numpy alone."""
    path = tmp_path / "custom.npz"
    jax_io.save_params(jax_model.params, str(path))
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'orbax', 'perspectivefields_tpu'): sys.modules[name] = None\n"
        "from perspectivefields_tpu_torch import checkpoint\n"
        f"sd = checkpoint.load_npz({str(path)!r})\n"
        "assert len(sd) > 100 and all(v.dtype.is_floating_point for v in sd.values())\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


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
    """The card's machine has no JAX (and no cv2 or PIL): import the port
    (serving, profiling, bench_serving, the pano ops, pano_camera,
    config_yaml, data, train, evaluation, parallel, the drawing modules and
    every tool too) and chip_smoke's imports, run tiny CPU forwards with the
    fused flags and through BatchPredictor, and two ``tools.train --tiny``
    steps, with jax, flax, optax, orbax, the JAX package, cv2, PIL and
    matplotlib made unimportable."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'optax', 'orbax', 'perspectivefields_tpu', 'cv2', 'PIL', "
        "'matplotlib'): sys.modules[name] = None\n"
        "import numpy as np, torch, warnings\n"
        "torch.set_num_threads(1)  # one of six test processes on the cores\n"
        "import chip_smoke\n"
        "import perspectivefields_tpu_torch.kernels.decoder_tail\n"
        "from perspectivefields_tpu_torch import bench_serving, serving\n"
        "from perspectivefields_tpu_torch.utils import profiling\n"
        "from perspectivefields_tpu_torch.kernels import decoder_tail\n"
        "from perspectivefields_tpu_torch.config import *\n"
        "from perspectivefields_tpu_torch import PerspectiveFields\n"
        "from perspectivefields_tpu_torch.ops import pano\n"
        "from perspectivefields_tpu_torch import pano_camera, config_yaml, data, train, evaluation\n"
        "from perspectivefields_tpu_torch.tools import train as ttrain, evaluate as tevaluate\n"
        "from perspectivefields_tpu_torch import parallel\n"
        "from perspectivefields_tpu_torch.parallel import mesh, sharding\n"
        "from perspectivefields_tpu_torch.tools import learning_proof, convert_checkpoint, "
        "export_torch, dryrun_multiprocess, demo\n"
        "from perspectivefields_tpu_torch.utils import draw, visualizer\n"
        "from perspectivefields_tpu_torch import ResizeTransform, PanoCam, model_zoo\n"
        "from perspectivefields_tpu_torch.ops import *\n"
        "from perspectivefields_tpu_torch.utils import *\n"
        "from perspectivefields_tpu_torch.models import *\n"
        "from perspectivefields_tpu_torch.kernels import fused_attention\n"
        "from perspectivefields_tpu_torch.parallel import tensor_parallel\n"
        "assert ResizeTransform(20, 30).apply_image(np.zeros((40, 50), np.uint8)).shape == (20, 30)\n"
        "cfg = ModelConfig(version='custom', backbone=BackboneConfig(dims=(64, 128, 192, 256), "
        "depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4)), "
        "gravity=GravityHeadConfig(loss_type='regression', embed_dim=16, fusion_dim=16), "
        "latitude=LatitudeHeadConfig(loss_type='regression', embed_dim=16, fusion_dim=16), "
        "param=ParamNetConfig(name='ParamNet'), recover_rpf=True, resize=(32, 32))\n"
        "warnings.simplefilter('ignore')\n"
        "m = PerspectiveFields('custom', config=cfg, device='cpu', fuse_ffn=True, fuse_convnext=True)\n"
        "p = m.inference(np.zeros((40, 50, 3), np.uint8))\n"
        "assert p['pred_gravity_original'].shape == (40, 50, 2)\n"
        "bp = serving.BatchPredictor(m, batch_size=2, out_wire='u8')\n"
        "outs = bp.predict([np.zeros((40, 50, 3), np.uint8)] * 3)\n"
        "assert len(outs) == 3 and outs[0]['pred_gravity'].shape == (32, 32, 2)\n"
        "assert 'device_wait' in bp.timer.summary()\n"
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
        "state = ttrain.main(['--tiny', '--steps', '2', '--batch', '2', '--size', '64', "
        "'--device', 'cpu'])\n"
        "assert state.step == 2\n"
        "loaded = [k for k in sys.modules if sys.modules[k] is not None]\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax', 'optax', 'orbax')) for k in loaded)\n"
        "assert not any(k.split('.')[0] in ('perspectivefields_tpu', 'cv2', 'PIL', 'matplotlib') "
        "for k in loaded)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


_RESIZE_CASES = {
    "u8": ((37, 53, 3), np.uint8),
    "u8_2d": ((37, 53), np.uint8),
    "u8_1ch": ((37, 53, 1), np.uint8),
    "f32": ((37, 53, 3), np.float32),
    "f32_2d": ((37, 53), np.float32),
    "f32_1ch": ((37, 53, 1), np.float32),
}


@pytest.mark.parametrize("case", sorted(_RESIZE_CASES))
@pytest.mark.parametrize("hw", [(20, 30), (80, 64)])
def test_resize_transform_matches_jax(case, hw):
    """The port's ResizeTransform against JAX's: uint8 bit-equal (PIL's
    resize), float within 2e-5 (torch bilinear), each in its own shape."""
    from perspectivefields_tpu.api import ResizeTransform as JaxResizeTransform
    from perspectivefields_tpu_torch import ResizeTransform

    shape, dtype = _RESIZE_CASES[case]
    rng = np.random.default_rng(0)
    if dtype == np.uint8:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        img = rng.normal(size=shape).astype(np.float32)
    got = ResizeTransform(*hw).apply_image(img)
    want = np.asarray(JaxResizeTransform(*hw).apply_image(img))
    assert got.shape == want.shape == hw + shape[2:] and got.dtype == want.dtype
    if dtype == np.uint8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


# the JAX package's flax converters: the port reads released .pth natively
_FLAX_ONLY = {("checkpoint", "convert_torch_state_dict"), ("checkpoint", "load_torch_checkpoint")}


@pytest.mark.parametrize(
    "sub", ["", "ops", "models", "utils", "kernels", "train", "parallel", "checkpoint"]
)
def test_jax_public_names_resolve_in_the_port(sub):
    """Every name of a JAX package's ``__all__`` resolves in the port's
    package or module of the same name (the flax converters excepted)."""
    import importlib

    suffix = "." + sub if sub else ""
    jax_mod = importlib.import_module("perspectivefields_tpu" + suffix)
    port = importlib.import_module("perspectivefields_tpu_torch" + suffix)
    missing = [n for n in jax_mod.__all__ if (sub, n) not in _FLAX_ONLY and not hasattr(port, n)]
    assert not missing, missing
    if hasattr(port, "__all__"):
        assert set(port.__all__) >= set(jax_mod.__all__) - {n for s, n in _FLAX_ONLY if s == sub}


def test_jax_stays_on_cpu_here():
    # the parity above ran JAX on the CPU (tests/conftest.py), not a chip
    assert jax.default_backend() == "cpu"
