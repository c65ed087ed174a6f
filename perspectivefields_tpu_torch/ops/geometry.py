"""Camera geometry: perspective fields, horizon / VVP helpers and gvfov math.

Port of perspectivefields_tpu/ops/geometry.py (reference
perspective2d/utils/panocam.py:121-556 and perspective2d/utils/utils.py:13-91).
Every function is branch-free tensor code (singularities go through
``torch.where``) on float32, and broadcasts over camera parameters: where
JAX vmaps a scalar camera, the port takes (B,) parameters and returns a
leading batch dimension. Tensors stay on the device of the parameters.

Conventions (the reference's, README.md:136): camera frame x right, y down,
z out; image frame u right, v down, origin top-left; rotations compose as
R_z(roll) @ R_x(pitch) @ R_y(yaw).

The reference's scipy ``fsolve`` root find stays the JAX package's
closed-form quadratic, so the backfill runs on the device without a host
sync.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _device(*vals):
    """The device of the first tensor among ``vals`` (None: the default)."""
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def rotation_matrix(roll, pitch, yaw) -> torch.Tensor:
    """Extrinsic rotation R_z(roll) @ R_x(pitch) @ R_y(yaw); (..., 3, 3) for
    (...) angles. Reference: perspective2d/utils/panocam.py:22-61."""
    dev = _device(roll, pitch, yaw)
    roll, pitch, yaw = torch.broadcast_tensors(_f32(roll, dev), _f32(pitch, dev), _f32(yaw, dev))
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    one, zero = torch.ones_like(roll), torch.zeros_like(roll)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    r_x = mat([[one, zero, zero], [zero, cp, sp], [zero, -sp, cp]])
    r_y = mat([[cy, zero, -sy], [zero, one, zero], [sy, zero, cy]])
    r_z = mat([[cr, sr, zero], [-sr, cr, zero], [zero, zero, one]])
    return (r_z @ r_x) @ r_y


def general_vfov(d_cx, d_cy, h, focal, degree: bool) -> torch.Tensor:
    """Angle at the pinhole subtended by the midpoints of the top and bottom
    image edges (law-of-cosines form, reference utils.py:13-44)."""
    d_cx, d_cy, focal = _f32(d_cx), _f32(d_cy), _f32(focal)
    p_sqr = focal**2 + d_cx**2 + (d_cy + 0.5 * h) ** 2
    q_sqr = focal**2 + d_cx**2 + (d_cy - 0.5 * h) ** 2
    cos_fov = (p_sqr + q_sqr - h**2) / 2.0 / torch.sqrt(p_sqr) / torch.sqrt(q_sqr)
    fov = torch.arccos(cos_fov.clamp(-1.0, 1.0))
    return torch.rad2deg(fov) if degree else fov


def general_vfov_to_focal(rel_cx, rel_cy, h, gvfov, degree: bool) -> torch.Tensor:
    """Invert ``general_vfov``: the focal length from the general vFoV and
    the principal point. With a = cx^2 + (cy+1/2)^2, b = cx^2 + (cy-1/2)^2,
    c = cos(gvfov) and u = (f/h)^2, squaring the law of cosines gives

        4(c^2-1) u^2 + 4(c^2(a+b) - (a+b-1)) u + (4 c^2 a b - (a+b-1)^2) = 0.

    The genuine root is the positive one whose 2u + a + b - 1 has the sign
    of c; else any positive root; else eps."""
    rel_cx, rel_cy, gvfov = _f32(rel_cx), _f32(rel_cy), _f32(gvfov)
    if degree:
        gvfov = torch.deg2rad(gvfov)
    a = rel_cx**2 + (rel_cy + 0.5) ** 2
    b = rel_cx**2 + (rel_cy - 0.5) ** 2
    c = torch.cos(gvfov)
    qa = 4.0 * (c * c - 1.0)
    qb = 4.0 * (c * c * (a + b) - (a + b - 1.0))
    qc = 4.0 * c * c * a * b - (a + b - 1.0) ** 2
    sq = torch.sqrt((qb * qb - 4.0 * qa * qc).clamp_min(0.0))
    qa_safe = torch.where(qa.abs() < _EPS, torch.full_like(qa, -_EPS), qa)
    u1 = (-qb + sq) / (2.0 * qa_safe)
    u2 = (-qb - sq) / (2.0 * qa_safe)

    def genuine(u):
        return (u > 0) & (torch.sign(2.0 * u + a + b - 1.0) == torch.sign(c))

    fallback = torch.maximum(u1, u2).clamp_min(_EPS)
    u = torch.where(genuine(u1), u1, torch.where(genuine(u2), u2, fallback))
    return torch.sqrt(u).abs() * h


def vfov_to_focal_rel(vfov) -> torch.Tensor:
    """Relative focal length (f / image height) of a centred pinhole from its
    vertical FoV in radians: f_rel = 1 / (2 tan(vfov / 2))."""
    return 1.0 / (2.0 * torch.tan(_f32(vfov, _device(vfov)) / 2.0))


# ---------------------------------------------------------------------------
# horizon line / vertical vanishing point
# ---------------------------------------------------------------------------


def relative_vvp(elevation, roll, vfov, im_h: int, im_w: int):
    """Relative vertical vanishing point (divided by the image size):
    (vx, vy, sign), sign +1 where up-vectors point towards the VVP and -1
    where away. At elevation == 0 the VVP is at infinity: (inf, inf, 0), so
    a caller can branch with ``where``. Reference: panocam.py:302-333."""
    dev = _device(elevation, roll, vfov)
    elevation, roll, vfov = _f32(elevation, dev), _f32(roll, dev), _f32(vfov, dev)
    tan_el = torch.tan(elevation)
    tan_el_safe = torch.where(tan_el.abs() < _EPS, torch.full_like(tan_el, _EPS), tan_el)
    vx = 0.5 - 0.5 / im_w - 0.5 * torch.sin(roll) / tan_el_safe / torch.tan(vfov / 2.0) * im_h / im_w
    vy = 0.5 - 0.5 / im_h - 0.5 * torch.cos(roll) / tan_el_safe / torch.tan(vfov / 2.0)
    at_horizon = elevation == 0
    inf = torch.tensor(float("inf"), device=elevation.device)
    return (
        torch.where(at_horizon, inf, vx),
        torch.where(at_horizon, inf, vy),
        torch.where(at_horizon, torch.zeros_like(elevation), torch.sign(elevation)),
    )


def midpoint_from_angle(elevation, roll, vfov) -> torch.Tensor:
    """Horizon-line midpoint as a fraction of the image height.
    Reference: panocam.py:353-367."""
    dev = _device(elevation, roll, vfov)
    elevation, roll, vfov = _f32(elevation, dev), _f32(roll, dev), _f32(vfov, dev)
    vertical = (elevation.abs() - math.pi / 2.0).abs() < _EPS
    mid = 0.5 + 0.5 * torch.tan(elevation) / torch.cos(roll) / torch.tan(vfov / 2.0)
    return torch.where(vertical, math.inf * torch.sign(elevation), mid)


def delta_height_from_roll(roll, im_h: int, im_w: int) -> torch.Tensor:
    """Half the horizon's height difference across the image width.
    Reference: panocam.py:369-382."""
    roll = _f32(roll, _device(roll))
    vertical = (roll.abs() - math.pi / 2.0).abs() < _EPS
    dh = -im_w / im_h * torch.tan(roll) / 2.0
    return torch.where(vertical, math.inf * torch.sign(roll), dh)


def relative_horizon_line(elevation, roll, vfov, im_h: int, im_w: int):
    """Fractions of the image height where the horizon crosses the left and
    right image borders. Reference: panocam.py:335-351."""
    mid = midpoint_from_angle(elevation, roll, vfov)
    dh = delta_height_from_roll(roll, im_h, im_w)
    return mid - dh, mid + dh


def abs_vvp(im_h: int, im_w: int, horizon, vvp) -> torch.Tensor:
    """Absolute VVP in pixels (top-left origin), (..., 3) = (x, y, sign),
    from the relative VVP, with the reference's far point along the horizon
    normal when the VVP is at infinity. Reference: panocam.py:276-300."""
    vx, vy, sign = (_f32(v, _device(*vvp)) for v in vvp)
    h0, h1 = (_f32(v, vx.device) for v in horizon)
    finite = torch.isfinite(vx) & torch.isfinite(vy)
    dx, dy = torch.broadcast_tensors(im_h * (h1 - h0), torch.full_like(h0, -float(im_w)))
    norm = torch.sqrt(dx * dx + dy * dy).clamp_min(_EPS)
    far_x, far_y = 1e8 * (dx / norm), 1e8 * (dy / norm)
    ax = torch.where(finite, vx * im_w, far_x + 0.5 * im_w - 0.5)
    ay = torch.where(finite, vy * im_h, far_y + 0.5 * im_h - 0.5)
    asign = torch.where(finite, sign, torch.ones_like(sign))
    return torch.stack(torch.broadcast_tensors(ax, ay, asign), dim=-1)


# ---------------------------------------------------------------------------
# dense fields
# ---------------------------------------------------------------------------


def _cam(*vals):
    """Float32 camera parameters on one device, each shaped (..., 1, 1) so
    they broadcast against an (H, W) grid."""
    dev = _device(*vals)
    return [_f32(v, dev)[..., None, None] for v in vals]


def up_field_general(focal_rel, im_w: int, im_h: int, elevation, roll, cx_rel, cy_rel):
    """Per-pixel unit up-vector field for any principal point: (..., im_h,
    im_w, 2) float32 for (...) parameters.

    Pixel centres at i + 0.5, as the reference's linspace construction
    (panocam.py:469-482). At elevation == 0 (VVP at infinity) the field is
    the constant (-sin roll, -cos roll), as panocam.py:486-489.
    Reference: panocam.py:451-510."""
    focal_rel, elevation, roll, cx_rel, cy_rel = _cam(focal_rel, elevation, roll, cx_rel, cy_rel)
    dev = elevation.device
    cx = (cx_rel + 0.5) * im_w
    cy = (cy_rel + 0.5) * im_h
    gy, gx = torch.meshgrid(
        torch.arange(im_h, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(im_w, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    focal = focal_rel * im_h
    sin_el = torch.sin(elevation)
    sin_el_safe = torch.where(sin_el.abs() < _EPS, torch.full_like(sin_el, _EPS), sin_el)
    vvp_x = torch.sin(roll) * torch.cos(elevation) * focal / (-sin_el_safe) + cx
    vvp_y = torch.cos(roll) * torch.cos(elevation) * focal / (-sin_el_safe) + cy
    ux = (vvp_x - gx) * torch.sign(elevation)
    uy = (vvp_y - gy) * torch.sign(elevation)
    at_horizon = elevation == 0
    ux = torch.where(at_horizon, -torch.sin(roll), ux)
    uy = torch.where(at_horizon, -torch.cos(roll), uy)
    norm = torch.sqrt(ux * ux + uy * uy).clamp_min(_EPS)
    return torch.stack([ux / norm, uy / norm], dim=-1)


def up_field(vfov, im_w: int, im_h: int, elevation, roll):
    """Centred-principal-point up field from (vfov, pitch, roll), radians:
    ``up_field_general`` with f_rel = 1/(2 tan(vfov/2)) and cx = cy = 0
    (the reference's centred path, panocam.py:423-448, reduces to it)."""
    return up_field_general(vfov_to_focal_rel(vfov), im_w, im_h, elevation, roll, 0.0, 0.0)


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` over a trailing axis, in its
    jaxpr's form: start * (1 - i / (num - 1)) + stop * (i / (num - 1)) for
    i < num - 1, then stop exactly. XLA's CPU code rounds some elements an
    ulp apart from this; ``torch.linspace`` (which fills its second half
    from the end) differs otherwise."""
    if num == 1:
        return start[..., None]
    frac = torch.arange(num - 1, dtype=torch.float32, device=start.device) / (num - 1)
    body = start[..., None] * (1.0 - frac) + stop[..., None] * frac
    return torch.cat([body, stop[..., None]], dim=-1)


def lat_field_general(focal_rel, im_w: int, im_h: int, elevation, roll, cx_rel, cy_rel):
    """Per-pixel latitude (degrees) for any principal point: (..., im_h,
    im_w) float32 for (...) parameters.

    Rays are rotated into the world frame by R_z(roll), then R_x(elevation);
    latitude = -atan2(y_world, hypot(x_world, z_world)). The grid is the
    reference's linspace, endpoints at +-size/2 (panocam.py:529-541).
    Reference: panocam.py:513-556."""
    dev = _device(focal_rel, elevation, roll, cx_rel, cy_rel)
    focal_rel, elevation, roll, cx_rel, cy_rel = torch.broadcast_tensors(
        *(_f32(v, dev) for v in (focal_rel, elevation, roll, cx_rel, cy_rel))
    )
    cx = (cx_rel + 0.5) * im_w
    cy = (cy_rel + 0.5) * im_h
    focal = (focal_rel * im_h)[..., None]
    dy = linspace((-im_h / 2.0) - (cy - im_h / 2.0), (im_h / 2.0) - (cy - im_h / 2.0), im_h)
    dx = linspace((-im_w / 2.0) - (cx - im_w / 2.0), (im_w / 2.0) - (cx - im_w / 2.0), im_w)
    x = (dx / focal)[..., None, :]
    y = (dy / focal)[..., :, None]
    cr, sr = torch.cos(roll)[..., None, None], torch.sin(roll)[..., None, None]
    ce, se = torch.cos(elevation)[..., None, None], torch.sin(elevation)[..., None, None]
    x_world = x * cr - y * sr
    y_world = x * ce * sr + y * ce * cr - se
    z_world = x * se * sr + y * se * cr + ce
    lat = -torch.atan2(y_world, torch.sqrt(x_world**2 + z_world**2))
    return torch.rad2deg(lat)


def lat_field(vfov, im_w: int, im_h: int, elevation, roll):
    """Centred latitude map (degrees) from (vfov, pitch, roll), radians.
    Reference: panocam.py:385-420."""
    return lat_field_general(vfov_to_focal_rel(vfov), im_w, im_h, elevation, roll, 0.0, 0.0)
