"""The port's camera geometry against the JAX package's, on CPU in float32.

Every function of perspectivefields_tpu_torch/ops/geometry.py runs on the
same seeded cameras as its JAX counterpart, including the singular ones:
elevation exactly 0 (the VVP at infinity), elevation +-1e-6 (where
``tan_el_safe`` amplifies float32 rounding) and roll +-90 degrees. JAX
vmaps a scalar camera; the port takes (B,) cameras at once.

Tolerances: fields (unit up-vectors, relative horizon and VVP fractions)
1e-5, relative for the VVP's large values near the horizon; degrees 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu.ops import geometry as JG
from perspectivefields_tpu_torch.ops import geometry as TG


FIELD_TOL, DEG_TOL = 1e-5, 1e-4
H, W = 17, 24  # odd x even, so the half-pixel grids are not symmetric


def _cams(n=12, seed=0):
    rng = np.random.default_rng(seed)
    vfov = np.radians(rng.uniform(30, 120, n)).astype(np.float32)
    el = np.radians(rng.uniform(-60, 60, n)).astype(np.float32)
    roll = np.radians(rng.uniform(-45, 45, n)).astype(np.float32)
    el[:3] = (0.0, 1e-6, -1e-6)
    roll[3:5] = (np.pi / 2, -np.pi / 2)
    el[3:5] = (0.3, -0.2)
    cx = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    cy = rng.uniform(-0.2, 0.2, n).astype(np.float32)
    return vfov, el, roll, cx, cy


CAMS = _cams()


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_rotation_matrix_matches_jax():
    vfov, el, roll, _, _ = CAMS
    yaw = vfov - 1.0
    want = np.stack([np.asarray(JG.rotation_matrix(r, p, y)) for r, p, y in zip(roll, el, yaw)])
    got = TG.rotation_matrix(t(roll), t(el), t(yaw)).numpy()
    np.testing.assert_allclose(got, want, atol=FIELD_TOL)
    # orthonormal, and a scalar camera gives one (3, 3) matrix
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-6)
    assert TG.rotation_matrix(0.1, 0.2, 0.3).shape == (3, 3)


def test_vfov_to_focal_rel_matches_jax():
    vfov = CAMS[0]
    np.testing.assert_allclose(TG.vfov_to_focal_rel(t(vfov)).numpy(),
                               np.asarray(JG.vfov_to_focal_rel(vfov)), rtol=1e-6)


@pytest.mark.parametrize("i", range(len(CAMS[0])))
def test_horizon_and_vvp_match_jax(i):
    vfov, el, roll = CAMS[0][i], CAMS[1][i], CAMS[2][i]
    want_vvp = [np.asarray(v) for v in JG.relative_vvp(el, roll, vfov, H, W)]
    got_vvp = [v.numpy() for v in TG.relative_vvp(t(el), t(roll), t(vfov), H, W)]
    np.testing.assert_allclose(got_vvp, want_vvp, rtol=FIELD_TOL, atol=FIELD_TOL)
    if el == 0:
        assert got_vvp[0] == np.inf and got_vvp[1] == np.inf and got_vvp[2] == 0.0
    np.testing.assert_allclose(TG.midpoint_from_angle(t(el), t(roll), t(vfov)).numpy(),
                               np.asarray(JG.midpoint_from_angle(el, roll, vfov)),
                               rtol=FIELD_TOL, atol=FIELD_TOL)
    np.testing.assert_allclose(TG.delta_height_from_roll(t(roll), H, W).numpy(),
                               np.asarray(JG.delta_height_from_roll(roll, H, W)),
                               rtol=FIELD_TOL, atol=FIELD_TOL)
    want_h = JG.relative_horizon_line(el, roll, vfov, H, W)
    got_h = TG.relative_horizon_line(t(el), t(roll), t(vfov), H, W)
    np.testing.assert_allclose([g.numpy() for g in got_h], [np.asarray(w) for w in want_h],
                               rtol=FIELD_TOL, atol=FIELD_TOL)
    want_abs = np.asarray(JG.abs_vvp(H, W, want_h, JG.relative_vvp(el, roll, vfov, H, W)))
    got_abs = TG.abs_vvp(H, W, got_h, TG.relative_vvp(t(el), t(roll), t(vfov), H, W)).numpy()
    np.testing.assert_allclose(got_abs, want_abs, rtol=FIELD_TOL, atol=FIELD_TOL)


def test_abs_vvp_batched_matches_per_camera():
    vfov, el, roll, _, _ = CAMS
    h = TG.relative_horizon_line(t(el), t(roll), t(vfov), H, W)
    got = TG.abs_vvp(H, W, h, TG.relative_vvp(t(el), t(roll), t(vfov), H, W)).numpy()
    for i in range(len(el)):
        hi = TG.relative_horizon_line(t(el[i]), t(roll[i]), t(vfov[i]), H, W)
        one = TG.abs_vvp(H, W, hi, TG.relative_vvp(t(el[i]), t(roll[i]), t(vfov[i]), H, W))
        np.testing.assert_array_equal(got[i], one.numpy())


def test_up_field_general_matches_jax():
    vfov, el, roll, cx, cy = CAMS
    f = np.asarray(JG.vfov_to_focal_rel(vfov))
    want = np.asarray(jax.vmap(lambda *a: JG.up_field_general(a[0], W, H, *a[1:]))(
        f, el, roll, cx, cy))
    got = TG.up_field_general(t(f), W, H, t(el), t(roll), t(cx), t(cy)).numpy()
    assert got.shape == (len(f), H, W, 2)
    np.testing.assert_allclose(got, want, atol=FIELD_TOL)
    # elevation 0: the constant (-sin roll, -cos roll) field
    np.testing.assert_allclose(got[0], np.broadcast_to([-np.sin(roll[0]), -np.cos(roll[0])],
                                                       (H, W, 2)), atol=1e-6)


def test_up_field_matches_jax():
    vfov, el, roll, _, _ = CAMS
    want = np.asarray(jax.vmap(lambda v, e, r: JG.up_field(v, W, H, e, r))(vfov, el, roll))
    got = TG.up_field(t(vfov), W, H, t(el), t(roll)).numpy()
    np.testing.assert_allclose(got, want, atol=FIELD_TOL)
    # a scalar camera gives one field
    one = TG.up_field(float(vfov[5]), W, H, float(el[5]), float(roll[5])).numpy()
    np.testing.assert_allclose(one, want[5], atol=FIELD_TOL)


def test_lat_field_general_matches_jax():
    vfov, el, roll, cx, cy = CAMS
    f = np.asarray(JG.vfov_to_focal_rel(vfov))
    want = np.asarray(jax.vmap(lambda *a: JG.lat_field_general(a[0], W, H, *a[1:]))(
        f, el, roll, cx, cy))
    got = TG.lat_field_general(t(f), W, H, t(el), t(roll), t(cx), t(cy)).numpy()
    assert got.shape == (len(f), H, W)
    np.testing.assert_allclose(got, want, atol=DEG_TOL)


def test_lat_field_matches_jax():
    vfov, el, roll, _, _ = CAMS
    want = np.asarray(jax.vmap(lambda v, e, r: JG.lat_field(v, W, H, e, r))(vfov, el, roll))
    got = TG.lat_field(t(vfov), W, H, t(el), t(roll)).numpy()
    np.testing.assert_allclose(got, want, atol=DEG_TOL)


@pytest.mark.parametrize("num", [1, 2, 17, 320])
def test_linspace_matches_jnp_linspace(num):
    # within 2 ulp of the endpoints' magnitude (XLA's CPU code rounds some
    # elements an ulp apart); the endpoints exactly
    start = np.float32(-160.37)
    stop = np.float32(159.61)
    want = np.asarray(jnp.linspace(start, stop, num))
    got = TG.linspace(t(start), t(stop), num).numpy()
    assert got.shape == want.shape and got[0] == want[0] and got[-1] == want[-1]
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.finfo(np.float32).eps * 160.37)


def test_fields_follow_the_parameters_device():
    # a float camera gives CPU tensors; a tensor camera keeps its device
    up = TG.up_field(t(CAMS[0][:2]), 8, 6, t(CAMS[1][:2]), t(CAMS[2][:2]))
    assert up.device.type == "cpu" and up.shape == (2, 6, 8, 2)
    norm = np.linalg.norm(up.numpy(), axis=-1)
    np.testing.assert_allclose(norm, 1.0, atol=1e-6)
