"""Panorama ops: equirectangular -> perspective or distorted crops + GT fields.

Port of perspectivefields_tpu/ops/pano.py (reference
perspective2d/utils/panocam.py:121-752, which wraps pyequilib): ray grids,
rotation, sphere -> pano mapping and a 4-tap bilinear gather, all tensor
code on the pano's device. ``equi2pers`` takes (B,) cameras where JAX vmaps
a scalar one.

Conventions (as ops.geometry and the reference): camera frame x right, y
down, z out; image frame u right, v down. Azimuth turns about world y
(positive looks right), elevation about camera x (positive looks up), roll
about camera z. The equirect's width spans theta in [-pi, pi), its height
phi in [+pi/2, -pi/2] (top row = north pole), pixel centres at
half-integers.
"""

from __future__ import annotations

import math

import torch

from .geometry import lat_field, up_field

_EPS = 1e-12


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _camera_rays(im_w: int, im_h: int, focal, cx=None, cy=None, device=None):
    """Unit-free camera-frame rays, pixel centres at half-integers; ``focal``
    (...) broadcasts to (..., im_h, im_w)."""
    cx = 0.5 * im_w if cx is None else cx
    cy = 0.5 * im_h if cy is None else cy
    vv, uu = torch.meshgrid(
        torch.arange(im_h, dtype=torch.float32, device=device) + 0.5,
        torch.arange(im_w, dtype=torch.float32, device=device) + 0.5,
        indexing="ij",
    )
    x = (uu - cx) / focal
    y = (vv - cy) / focal
    return x, y, torch.ones_like(x)


def _rotate_cam_to_world(x, y, z, roll, elevation, azimuth):
    """Camera-frame ray -> world-frame ray: roll, then elevation (the
    expressions of ops.geometry.lat_field_general, panocam.py:543-553), then
    a yaw by azimuth about the world y axis."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    ce, se = torch.cos(elevation), torch.sin(elevation)
    ca, sa = torch.cos(azimuth), torch.sin(azimuth)
    xw = x * cr - y * sr
    yw = x * ce * sr + y * ce * cr - z * se
    zw = x * se * sr + y * se * cr + z * ce
    xw2 = xw * ca + zw * sa
    zw2 = -xw * sa + zw * ca
    return xw2, yw, zw2


def _world_to_equi_uv(xw, yw, zw, pano_h: int, pano_w: int):
    """World ray -> fractional pano pixel coordinates (u wraps, v clamps)."""
    theta = torch.atan2(xw, zw)  # [-pi, pi], 0 = forward
    phi = -torch.atan2(yw, torch.sqrt(xw * xw + zw * zw))  # + up
    u = (0.5 + theta / (2.0 * math.pi)) * pano_w - 0.5
    v = (0.5 - phi / math.pi) * pano_h - 0.5
    return u, v, theta, phi


def grid_sample_equi(pano: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W, C) pano at fractional (u, v) grids of any
    shape (...): (..., C). Columns wrap (floor modulo) and rows clamp; every
    index is wrapped or clamped here, since torch's gather raises where
    JAX's clamps."""
    ph, pw = pano.shape[0], pano.shape[1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0i = torch.remainder(u0.to(torch.int64), pw)
    u1i = torch.remainder(u0i + 1, pw)
    v0i = v0.to(torch.int64).clamp(0, ph - 1)
    v1i = (v0i + 1).clamp(0, ph - 1)
    top = pano[v0i, u0i] * (1 - fu) + pano[v0i, u1i] * fu
    bot = pano[v1i, u0i] * (1 - fu) + pano[v1i, u1i] * fu
    return top * (1 - fv) + bot * fv


def equi2pers(pano: torch.Tensor, vfov, im_w: int, im_h: int, azimuth=0.0, elevation=0.0,
              roll=0.0) -> torch.Tensor:
    """Pinhole perspective crops of an (H, W, C) float equirect image:
    (..., im_h, im_w, C) for (...) cameras (radians), one per crop.
    The capability of PanoCam.crop_equi (panocam.py:197-249)."""
    dev = pano.device
    vfov, azimuth, elevation, roll = (
        _f32(a, dev)[..., None, None] for a in (vfov, azimuth, elevation, roll)
    )
    focal = im_h / (2.0 * torch.tan(vfov / 2.0))
    x, y, z = _camera_rays(im_w, im_h, focal, device=dev)
    xw, yw, zw = _rotate_cam_to_world(x, y, z, roll, elevation, azimuth)
    u, v, _, _ = _world_to_equi_uv(xw, yw, zw, pano.shape[0], pano.shape[1])
    return grid_sample_equi(pano, u, v)


def crop_equi_with_fields(pano: torch.Tensor, vfov, im_w: int, im_h: int, azimuth, elevation,
                          roll):
    """Crop + analytic GT for the same camera(s): (crop, up (..., h, w, 2),
    latitude in degrees (..., h, w))."""
    crop = equi2pers(pano, vfov, im_w, im_h, azimuth, elevation, roll)
    dev = pano.device
    vfov, elevation, roll = (_f32(a, dev) for a in (vfov, elevation, roll))
    return crop, up_field(vfov, im_w, im_h, elevation, roll), lat_field(
        vfov, im_w, im_h, elevation, roll
    )


# ---------------------------------------------------------------------------
# Unified Spherical Model (distorted crops)
# ---------------------------------------------------------------------------


def min_focal(u0, v0, xi, xref=1.0, yref=1.0) -> torch.Tensor:
    """Least focal of a catadioptric image for a given xi (panocam.py:64-70);
    NaN for xi <= 1."""
    xi = _f32(xi, None)
    return torch.sqrt(-(1 - xi * xi) * ((xref - u0) ** 2 + (yref - v0) ** 2)) * 1.0001


def disk_radius(xi, f) -> torch.Tensor:
    """Valid-disk radius of a catadioptric image (panocam.py:18-19)."""
    xi, f = _f32(xi, None), _f32(f, None)
    return torch.sqrt(-(f * f) / (1 - xi * xi))


def crop_distortion(pano: torch.Tensor, f, xi, im_h: int, im_w: int, az_deg, el_deg,
                    roll_deg) -> dict:
    """A USM-distorted crop of an (H, W, C) pano + analytic GT fields.

    Unified Spherical Model: image plane -> unit sphere (lift by xi), the
    rotations (elevation, roll^T, then azimuth), then sphere -> equirect
    lookup. The up GT is the image-plane direction in which the viewed pano
    point moves as it steps toward the north pole: the reference takes a
    1e-5 px reprojection in float64 (panocam.py:723-750), which vanishes in
    float32, so this takes the exact derivative with ``torch.func.jvp`` (the
    same construction with eps -> 0, as JAX's ``jax.jvp``).

    f: focal in pixels; xi: USM distortion in [0, 1]; angles in degrees.
    Returns crop (h, w, C), up (h, w, 2), lat (h, w) radians, theta / phi
    (h, w) pano angles and xy_map (h, w, 2) pano pixel coordinates, in
    float32 (float64 for a float64 pano).
    """
    dev = pano.device
    dt = torch.float64 if pano.dtype == torch.float64 else torch.float32

    def cast(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    f, xi = cast(f), cast(xi)
    az, el, ro = (torch.deg2rad(cast(a)) for a in (az_deg, el_deg, roll_deg))
    ph, pw = pano.shape[0], pano.shape[1]
    u0, v0 = im_w / 2.0, im_h / 2.0

    gy, gx = torch.meshgrid(
        torch.arange(im_h, dtype=dt, device=dev), torch.arange(im_w, dtype=dt, device=dev),
        indexing="ij",
    )
    # 1-2. plane -> sphere (the USM lift)
    x_cam = (gx - u0) / f
    y_cam = -(gy - v0) / f
    aux = x_cam * x_cam + y_cam * y_cam
    alpha = xi + torch.sqrt((1.0 + (1.0 - xi * xi) * aux).clamp_min(0.0))
    alpha = alpha / (aux + 1.0)
    xs, ys, zs = x_cam * alpha, y_cam * alpha, alpha - xi

    # 3. rotate the sphere: rot_roll^T @ rot_el @ p, then rot_az
    ce, se = torch.cos(el), torch.sin(el)
    cr, sr = torch.cos(ro), torch.sin(ro)
    ca, sa = torch.cos(az), torch.sin(az)

    def rot_el_fwd(x, y, z):
        return x, ce * y - se * z, se * y + ce * z

    def rot_el_inv(x, y, z):
        return x, ce * y + se * z, -se * y + ce * z

    def rot_roll_fwd(x, y, z):  # rot_roll @ p
        return cr * x - sr * y, sr * x + cr * y, z

    def rot_roll_inv(x, y, z):  # rot_roll^T @ p
        return cr * x + sr * y, -sr * x + cr * y, z

    def rot_az_fwd(x, y, z):  # rot_az @ p
        return ca * x + sa * z, y, -sa * x + ca * z

    def rot_az_inv(x, y, z):
        return ca * x - sa * z, y, sa * x + ca * z

    xs, ys, zs = rot_el_fwd(xs, ys, zs)
    xs, ys, zs = rot_roll_inv(xs, ys, zs)
    xs, ys, zs = rot_az_fwd(xs, ys, zs)

    # 4-5. sphere -> pano coordinates, the reference's linear maps
    # (panocam.py:666-687): theta over [-pi, pi] across [0, W-1], phi over
    # [pi/2, -pi/2] across [0, H-1]
    ntheta = torch.atan2(xs, zs)
    nphi = torch.atan2(ys, torch.sqrt(zs * zs + xs * xs))
    a_x = 2.0 * math.pi / (pw - 1.0)
    b_x = math.pi - a_x * (pw - 1.0)  # = -pi
    nx = (ntheta - b_x) / a_x
    a_y = -math.pi / (ph - 1.0)
    b_y = math.pi / 2.0
    ny = (nphi - b_y) / a_y

    crop = grid_sample_equi(pano, nx, ny)

    ntheta_end = nx * a_x + b_x  # == ntheta (round trip)

    def reproject(phi_end):
        ys2 = torch.sin(nphi)  # the reference keeps sin(nphi) fixed (panocam.py:736)
        xs2 = torch.cos(phi_end) * torch.sin(ntheta_end)
        zs2 = torch.cos(phi_end) * torch.cos(ntheta_end)
        # inverse rotation: rot_el^T @ (rot_roll @ (rot_az^T @ p))
        x3, y3, z3 = rot_az_inv(xs2, ys2, zs2)
        x3, y3, z3 = rot_roll_fwd(x3, y3, z3)
        x3, y3, z3 = rot_el_inv(x3, y3, z3)
        denom = xi * torch.sqrt(x3 * x3 + y3 * y3 + z3 * z3) + z3
        denom = torch.where(denom.abs() < _EPS, torch.full_like(denom, _EPS), denom)
        x_im = x3 * f / denom + u0
        y_im = -y3 * f / denom + v0
        return torch.stack([x_im, y_im])

    # a step of -eps pixels in ny is a step of -eps * a_y in phi; a_y < 0,
    # so toward the pole means phi increasing: differentiate along -a_y
    _, d_im = torch.func.jvp(reproject, (nphi,), (torch.full_like(nphi, -a_y),))
    ux, uy = d_im[0], d_im[1]
    norm = torch.sqrt(ux * ux + uy * uy).clamp_min(_EPS)
    up = torch.stack([ux / norm, uy / norm], dim=-1)

    return {
        "crop": crop,
        "up": up,
        "lat": nphi,
        "theta": ntheta,
        "phi": nphi,
        "xy_map": torch.stack([nx, ny], dim=-1),
    }
