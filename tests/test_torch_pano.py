"""The port's pano ops, PanoCam and config_yaml against the JAX package's.

Same seeded panos and cameras through both, float32 on CPU:
``grid_sample_equi`` (including coordinates far outside the pano, which
the port must wrap / clamp itself), ``equi2pers`` with (B,) cameras against
JAX's per-camera vmap, ``crop_equi_with_fields``, ``crop_distortion`` (up
field from ``torch.func.jvp`` against ``jax.jvp``), ``PanoCam`` from an
array and from a file, and ``config_yaml`` on tests/test_compat.py's cases.

Tolerances: crops 255 * 1e-4 (bilinear taps of coordinates that differ by
an ulp); fields 1e-5; angles 1e-6 rad; pano pixel maps 1e-4 px. The USM
up field is the exception: it differentiates a round trip (theta -> pano
pixel -> theta) whose float32 rounding reaches 1e-4 on a few pixels. So
the port's float32 field is held within 1e-4 of its own float64
evaluation (measured <= 5.5e-5), and within 1e-5 of JAX's on >= 99% of
pixels and 5e-4 on all (JAX's own float32 field lies up to 2.4e-4 from
float64 in the cases below).
"""

import jax
import numpy as np
import pytest
import torch

from perspectivefields_tpu import pano_camera as jax_pano_camera
from perspectivefields_tpu.config_yaml import from_reference_dict as jax_from_reference_dict
from perspectivefields_tpu.ops import pano as JP
from perspectivefields_tpu_torch import config_yaml, pano_camera
from perspectivefields_tpu_torch.ops import pano as TP
from tests.test_pano import angle_pano


CROP_TOL = 255 * 1e-4
FIELD_TOL, ANGLE_TOL, PIX_TOL = 1e-5, 1e-6, 1e-4


def _pano(seed=0, ph=64, pw=128):
    return np.random.default_rng(seed).uniform(0, 255, (ph, pw, 3)).astype(np.float32)


def _cams(n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [np.radians(rng.uniform(lo, hi, n)).astype(np.float32)
            for lo, hi in ((30, 120), (-180, 180), (-60, 60), (-45, 45))]


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_grid_sample_equi_matches_jax_and_wraps():
    pano = _pano()
    rng = np.random.default_rng(2)
    # far outside the pano on both axes: u wraps (floor modulo), v clamps
    u = rng.uniform(-300, 400, (9, 11)).astype(np.float32)
    v = rng.uniform(-20, 90, (9, 11)).astype(np.float32)
    want = np.asarray(JP.grid_sample_equi(pano, u, v))
    got = TP.grid_sample_equi(t(pano), t(u), t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=CROP_TOL)
    # a whole turn of u samples the same pixels
    np.testing.assert_allclose(TP.grid_sample_equi(t(pano), t(u + 128), t(v)).numpy(), got,
                               atol=CROP_TOL)


def test_equi2pers_batched_matches_jax_vmap():
    pano = _pano()
    vfov, az, el, roll = _cams()
    jpano = jax.numpy.asarray(pano)
    want = np.asarray(jax.vmap(lambda v, a, e, r: JP.equi2pers(jpano, v, 40, 30, a, e, r))(
        vfov, az, el, roll))
    got = TP.equi2pers(t(pano), t(vfov), 40, 30, t(az), t(el), t(roll)).numpy()
    assert got.shape == (6, 30, 40, 3)
    np.testing.assert_allclose(got, want, atol=CROP_TOL)
    one = TP.equi2pers(t(pano), float(vfov[2]), 40, 30, float(az[2]), float(el[2]),
                       float(roll[2])).numpy()
    np.testing.assert_allclose(one, want[2], atol=CROP_TOL)


def test_crop_equi_with_fields_matches_jax():
    pano = angle_pano(64, 128)
    vfov, az, el, roll = _cams(3)
    for i in range(3):
        want = JP.crop_equi_with_fields(pano, vfov[i], 24, 18, az[i], el[i], roll[i])
        got = TP.crop_equi_with_fields(t(pano), t(vfov[i]), 24, 18, t(az[i]), t(el[i]),
                                       t(roll[i]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=FIELD_TOL)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)
    # the pano's own latitude channel at the crop pixels is the analytic
    # latitude: tests/test_pano.py's invariant and bar (interior, 99th
    # percentile under a degree)
    crop, _, lat = TP.crop_equi_with_fields(t(angle_pano()), 1.2, 64, 48, 0.4, 0.3, 0.1)
    err = np.abs(np.degrees(crop[..., 2].numpy()) - lat.numpy())[4:-4, 4:-4]
    assert np.percentile(err, 99) < 1.0, err.max()


@pytest.mark.parametrize("f,xi,az,el,roll", [
    (30.0, 0.4, 20.0, 15.0, -8.0),
    (60.0, 0.0, -40.0, -25.0, 12.0),
    (45.0, 0.8, 100.0, 35.0, 30.0),
])
def test_crop_distortion_matches_jax_jvp(f, xi, az, el, roll):
    pano = _pano(3)
    want = JP.crop_distortion(pano, f, xi, 30, 40, az, el, roll)
    got = TP.crop_distortion(t(pano), f, xi, 30, 40, az, el, roll)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["crop"].numpy(), np.asarray(want["crop"]), atol=CROP_TOL)
    for key in ("lat", "theta", "phi"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ANGLE_TOL)
    np.testing.assert_allclose(got["xy_map"].numpy(), np.asarray(want["xy_map"]), atol=PIX_TOL)
    up, up_j = got["up"].numpy(), np.asarray(want["up"])
    up_64 = TP.crop_distortion(t(pano).double(), f, xi, 30, 40, az, el, roll)["up"].numpy()
    np.testing.assert_allclose(up, up_64, atol=1e-4)
    err = np.abs(up - up_j).max(axis=-1)
    assert (err <= FIELD_TOL).mean() >= 0.99, (err > FIELD_TOL).sum()
    np.testing.assert_allclose(up, up_j, atol=5e-4)
    np.testing.assert_allclose(np.linalg.norm(up, axis=-1), 1.0, atol=1e-5)


def test_min_focal_and_disk_radius_match_jax():
    for xi in (0.5, 1.2, 1.7):
        with np.errstate(invalid="ignore"):
            np.testing.assert_allclose(pano_camera.min_focal(32.0, 24.0, xi),
                                       jax_pano_camera.min_focal(32.0, 24.0, xi), rtol=1e-6)
    np.testing.assert_allclose(pano_camera.disk_radius(1.3, 20.0),
                               jax_pano_camera.disk_radius(1.3, 20.0), rtol=1e-6)


def test_panocam_from_array_and_file_match_jax(tmp_path):
    from PIL import Image

    pano = _pano(4).astype(np.uint8)
    path = str(tmp_path / "pano.png")
    Image.fromarray(pano).save(path)
    want = jax_pano_camera.PanoCam(path).get_image(70, 40, 30, 25, 15, -5, img_format="BGR")
    for cam in (pano_camera.PanoCam(pano, device="cpu"), pano_camera.PanoCam(path, device="cpu")):
        got = cam.get_image(70, 40, 30, 25, 15, -5, img_format="BGR")
        assert got[0].dtype == np.uint8 and got[0].shape == (30, 40, 3)
        # uint8 truncation of values an ulp apart moves a pixel by at most 1
        assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1
        np.testing.assert_allclose(got[1], want[1], rtol=FIELD_TOL, atol=FIELD_TOL)
        np.testing.assert_allclose(got[2], want[2], rtol=FIELD_TOL, atol=FIELD_TOL)


def test_panocam_statics_match_jax():
    P, J = pano_camera.PanoCam, jax_pano_camera.PanoCam
    pano = _pano(5).astype(np.uint8)
    got, want = P.crop_equi(pano, 70.0, 32, 24, 30.0, 20.0, 10.0, 4 / 3), \
        J.crop_equi(pano, 70.0, 32, 24, 30.0, 20.0, 10.0, 4 / 3)
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - want.astype(int)).max() <= 1
    gray = P.crop_equi(pano[..., 0], 70.0, 32, 24, 30.0, 20.0, 10.0, 4 / 3)
    assert gray.shape == (24, 32)
    args = (np.radians(60.0), 32, 24, np.radians(20.0), 0.1)
    np.testing.assert_allclose(P.get_up(*args), J.get_up(*args), atol=FIELD_TOL)
    np.testing.assert_allclose(P.get_lat(*args), J.get_lat(*args), atol=1e-4)
    gen = (0.9, 32, 24, 0.2, -0.1, 0.05, -0.03)
    np.testing.assert_allclose(P.get_up_general(*gen), J.get_up_general(*gen), atol=FIELD_TOL)
    np.testing.assert_allclose(P.get_lat_general(*gen), J.get_lat_general(*gen), atol=1e-4)
    assert P.getRelativeVVP(0.0, 0.1, 1.0, 48, 64) == (np.inf, np.inf)
    np.testing.assert_allclose(P.getRelativeVVP(0.3, 0.1, 1.0, 48, 64),
                               J.getRelativeVVP(0.3, 0.1, 1.0, 48, 64), rtol=FIELD_TOL)
    h = P.getRelativeHorizonLineFromAngles(0.2, 0.1, 1.0, 48, 64)
    np.testing.assert_allclose(h, J.getRelativeHorizonLineFromAngles(0.2, 0.1, 1.0, 48, 64),
                               rtol=FIELD_TOL)
    for vvp in (P.getRelativeVVP(0.3, 0.1, 1.0, 48, 64), P.getRelativeVVP(0.0, 0.1, 1.0, 48, 64)):
        np.testing.assert_allclose(P.getAbsVVP(48, 64, h, vvp), J.getAbsVVP(48, 64, h, vvp),
                                   rtol=FIELD_TOL)
    absvvp = np.array([5.0, -100.0, 1.0])
    np.testing.assert_array_equal(P.getGravityField(10, 10, absvvp),
                                  J.getGravityField(10, 10, absvvp))


def test_panocam_crop_distortion_tuple_and_disk_mask_match_jax():
    P, J = pano_camera.PanoCam, jax_pano_camera.PanoCam
    pano = angle_pano(64, 128)
    got = P.crop_distortion(pano, 30.0, 0.2, 32, 32, 10.0, 0.0, 0.0)
    want = J.crop_distortion(pano, 30.0, 0.2, 32, 32, 10.0, 0.0, 0.0)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=ANGLE_TOL)
    np.testing.assert_allclose(got[2], want[2], atol=ANGLE_TOL)
    np.testing.assert_allclose(got[3], want[3], atol=1e-3)  # horizon row offset, px
    np.testing.assert_allclose(got[4], want[4], atol=1e-4)
    np.testing.assert_allclose(got[6], want[6], atol=PIX_TOL)
    # xi > 1 and f < minfocal: the catadioptric disk mask
    flat = np.full((64, 128, 3), 200, np.uint8)
    fmin = pano_camera.min_focal(16.0, 16.0, 1.2)
    im = P.crop_distortion(flat, 0.5 * fmin, 1.2, 32, 32, 0.0, 0.0, 0.0)[0]
    im_j = J.crop_distortion(flat, 0.5 * fmin, 1.2, 32, 32, 0.0, 0.0, 0.0)[0]
    assert np.all(im[0, 0] == 0) and np.all(im[16, 16] > 0)
    np.testing.assert_array_equal(im == 0, im_j == 0)


CONFIG_CASES = {
    "default_tree": {"MODEL": {"GRAVITY_ON": True, "LATITUDE_ON": True}},
    "regression_paramnet": {
        "INPUT": {"FORMAT": "RGB"},
        "MODEL": {
            "GRAVITY_ON": True, "LATITUDE_ON": True, "RECOVER_RPF": True,
            "BACKBONE": {"NAME": "mitb2"},
            "GRAVITY_DECODER": {"LOSS_TYPE": "regression", "NUM_CLASSES": 2},
            "LATITUDE_DECODER": {"LOSS_TYPE": "regression"},
            "PARAM_DECODER": {"NAME": "ParamNetConvNextRegress", "INPUT_SIZE": 64,
                              "PREDICT_PARAMS": ["roll", "pitch", "vfov"]},
        },
    },
    "principal_point": {
        "DATALOADER": {"RESIZE": [256, 320]},
        "MODEL": {"GRAVITY_ON": True, "LATITUDE_ON": True, "RECOVER_RPF": True,
                  "RECOVER_PP": True, "PARAM_DECODER": {"LOSS_WEIGHT": 0.1},
                  "PIXEL_STD": [57.0, 57.0, 58.0]},
    },
    "fields_off": {},
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_config_yaml_matches_jax(case):
    import dataclasses

    raw = CONFIG_CASES[case]
    got = dataclasses.asdict(config_yaml.from_reference_dict(raw, "v"))
    want = dataclasses.asdict(jax_from_reference_dict(raw, "v"))
    assert got == want
    if case == "default_tree":
        cfg = config_yaml.from_reference_dict(raw)
        assert cfg.gravity.loss_type == "classification" and cfg.gravity.num_classes == 73
        assert cfg.param is None


def test_load_reference_yaml_reads_a_file(tmp_path):
    import yaml

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(CONFIG_CASES["regression_paramnet"]))
    cfg = config_yaml.load_reference_yaml(str(path), "mine")
    assert cfg.version == "mine" and cfg.backbone.name == "mitb2"
    assert cfg.param.name == "ParamNetConvNextRegress" and cfg.input_format == "RGB"
