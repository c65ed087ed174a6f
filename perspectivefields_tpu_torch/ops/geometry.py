"""Camera geometry: the general vertical field of view and its inverse.

Port of the part of perspectivefields_tpu/ops/geometry.py that the ParamNet
backfill needs (reference perspective2d/utils/utils.py:13-91). The
reference's scipy ``fsolve`` root find stays the JAX package's closed-form
quadratic, so the backfill runs on the device without a host sync.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


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
