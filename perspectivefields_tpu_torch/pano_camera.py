"""PanoCam-compatible camera API.

Port of perspectivefields_tpu/pano_camera.py, the surface of the reference's
PanoCam class (reference perspective2d/utils/panocam.py:121-752): pano
loading, perspective and distorted crops, horizon / VVP helpers and the
analytic fields, on this package's tensor ops. Methods return numpy arrays
like the reference; use ``perspectivefields_tpu_torch.ops`` directly for
pipelines that stay on the device.

Angles as the reference takes them per method: get_image / crop_equi /
crop_distortion take degrees, the field and horizon statics radians.
``get_image`` runs on the instance's device; the statics take host arrays
and compute on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import geometry as G
from .ops import pano as P


def _cpu(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image  # only for a path: the GPU machine has no PIL

    return np.asarray(Image.open(path).convert("RGB"))


class PanoCam:
    """A panorama given as a file path or an (H, W, 3) RGB array."""

    def __init__(self, pano, device: str = "cuda"):
        self.pano = pano
        self.pano_path = pano if isinstance(pano, str) else None
        self.device = torch.device(device)

    def _load(self) -> np.ndarray:
        img = _read_rgb(self.pano) if isinstance(self.pano, str) else self.pano
        return np.asarray(img).astype(np.float32)

    def get_image(
        self,
        vfov: float = 85,
        im_w: int = 640,
        im_h: int = 480,
        azimuth: float = 0,
        elevation: float = 30,
        roll: float = 0,
        ar: float = 4.0 / 3.0,
        img_format: str = "RGB",
    ):
        """Crop a perspective view; returns (crop uint8, horizon, vvp).
        Reference: panocam.py:132-194 (degrees in, horizon / VVP fractions
        out)."""
        pano = torch.from_numpy(self._load()).to(self.device)
        v, a, e, r = np.radians([vfov, azimuth, elevation, roll]).astype(np.float32)
        crop = P.equi2pers(pano, v, im_w, im_h, a, e, r).cpu().numpy()
        if img_format == "BGR":
            crop = crop[:, :, ::-1]
        horizon = tuple(float(x) for x in G.relative_horizon_line(e, r, v, im_h, im_w))
        vvp = tuple(float(x) for x in G.relative_vvp(e, r, v, im_h, im_w))
        return crop.astype(np.uint8), horizon, vvp

    # ------------------------------------------------------------- statics

    @staticmethod
    def crop_equi(equi_img, vfov, im_w, im_h, azimuth, elevation, roll, ar, mode="bilinear"):
        """Crop a perspective view from an equirect array (degrees).
        Reference: panocam.py:197-249."""
        v, a, e, r = np.radians([vfov, azimuth, elevation, roll]).astype(np.float32)
        img = np.asarray(equi_img, np.float32)
        squeeze = img.ndim == 2
        if squeeze:
            img = img[:, :, None]
        crop = P.equi2pers(torch.from_numpy(img), v, im_w, im_h, a, e, r).numpy()
        crop = crop.astype(equi_img.dtype)
        return crop[:, :, 0] if squeeze else crop

    @staticmethod
    def crop_distortion(image360, f, xi, H, W, az, el, roll):
        """USM distorted crop; returns (im, ntheta, nphi, offset, up, lat,
        xy_map) as the reference (panocam.py:559-752). Angles in degrees."""
        if isinstance(image360, str):
            image360 = _read_rgb(image360)
        out = P.crop_distortion(_cpu(image360), f, xi, H, W, az, el, roll)
        im = out["crop"].numpy().astype(image360.dtype)
        # catadioptric disk mask: where f < minfocal (real only for xi > 1)
        # the valid image is a centred disk of radius diskradius(xi, f);
        # zero everything outside, as the reference (panocam.py:695-707;
        # a NaN fmin for xi <= 1 compares False)
        with np.errstate(invalid="ignore"):
            fmin = min_focal(W / 2.0, H / 2.0, xi)
            if np.isfinite(fmin) and f < fmin:
                r = disk_radius(xi, f)
                ci, cj = np.round(H / 2.0), np.round(W / 2.0)
                jj, ii = np.meshgrid(np.arange(W) - cj, np.arange(H) - ci)
                im = im * (ii * ii + jj * jj < r * r)[:, :, None].astype(im.dtype)
        ntheta, nphi = out["theta"].numpy(), out["phi"].numpy()
        # horizon row offset: the subpixel zero crossing of phi in the middle
        # column
        col = nphi[:, W // 2]
        sign_change = np.where(np.diff(np.sign(col)))[0]
        if len(sign_change) == 0:
            offset = np.nan
        else:
            i = sign_change[0]
            offset = i - col[i] / (col[i + 1] - col[i])
        return im, ntheta, nphi, offset, out["up"].numpy(), out["lat"].numpy(), out["xy_map"].numpy()

    @staticmethod
    def get_up(vfov, im_w, im_h, elevation, roll):
        """(H, W, 2) up field; radians. Reference: panocam.py:423-448."""
        return G.up_field(_cpu(vfov), im_w, im_h, _cpu(elevation), _cpu(roll)).numpy()

    @staticmethod
    def get_lat(vfov, im_w, im_h, elevation, roll):
        """(H, W) latitude in degrees; radians in. Reference: panocam.py:385-420."""
        return G.lat_field(_cpu(vfov), im_w, im_h, _cpu(elevation), _cpu(roll)).numpy()

    @staticmethod
    def get_up_general(focal_rel, im_w, im_h, elevation, roll, cx_rel, cy_rel):
        """Reference: panocam.py:451-510."""
        return G.up_field_general(
            _cpu(focal_rel), im_w, im_h, _cpu(elevation), _cpu(roll), _cpu(cx_rel), _cpu(cy_rel)
        ).numpy()

    @staticmethod
    def get_lat_general(focal_rel, im_w, im_h, elevation, roll, cx_rel, cy_rel):
        """Reference: panocam.py:513-556."""
        return G.lat_field_general(
            _cpu(focal_rel), im_w, im_h, _cpu(elevation), _cpu(roll), _cpu(cx_rel), _cpu(cy_rel)
        ).numpy()

    @staticmethod
    def getRelativeVVP(elevation, roll, vfov, im_h, im_w):
        """Reference: panocam.py:302-333 (returns (inf, inf) at the horizon)."""
        vx, vy, s = G.relative_vvp(_cpu(elevation), _cpu(roll), _cpu(vfov), im_h, im_w)
        if not np.isfinite(float(vx)):
            return (np.inf, np.inf)
        return float(vx), float(vy), float(s)

    @staticmethod
    def getRelativeHorizonLineFromAngles(elevation, roll, vfov, im_h, im_w):
        """Reference: panocam.py:335-351."""
        h0, h1 = G.relative_horizon_line(_cpu(elevation), _cpu(roll), _cpu(vfov), im_h, im_w)
        return float(h0), float(h1)

    @staticmethod
    def getAbsVVP(im_h, im_w, horizon, vvp):
        """Reference: panocam.py:276-300."""
        if len(vvp) == 2:
            vvp = (vvp[0], vvp[1], 0.0)
        return G.abs_vvp(im_h, im_w, tuple(map(_cpu, horizon)), tuple(map(_cpu, vvp))).numpy()

    @staticmethod
    def getGravityField(im_h, im_w, absvvp) -> np.ndarray:
        """Up field from an absolute VVP. Reference: panocam.py:251-273."""
        gx, gy = np.meshgrid(np.arange(im_w), np.arange(im_h))
        d = np.stack([absvvp[0] - gx, absvvp[1] - gy], axis=-1).astype(np.float64)
        n = np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        return (d / n) * absvvp[2]


def min_focal(u0, v0, xi, xref=1.0, yref=1.0):
    """Least focal of a catadioptric image (reference panocam.py:64-70)."""
    return float(P.min_focal(u0, v0, xi, xref, yref))


def disk_radius(xi, f):
    """Catadioptric disk radius (reference panocam.py:18-19)."""
    return float(P.disk_radius(xi, f))
