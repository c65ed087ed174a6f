"""Synthetic training data: random cameras -> pano crops + GT fields.

Port of perspectivefields_tpu/data.py. The reference's training data are
crops of 360 panoramas under random cameras with analytic GT fields (the
camera2perspective workflow, panocam.py); here the cameras are drawn on the
host from a seeded ``torch.Generator`` and the crops and fields are rendered
on the pano's device, so a batch never crosses the host link.

Batch ``i`` of a stream is a pure function of (seed, i): its cameras come
from a generator seeded with both, so the stream is seekable (a resumed run
continues it) and the same on every device. JAX's threefry draws cannot be
reproduced in torch, so the cameras differ from JAX's for the same seed;
``render_batch`` takes any cameras, JAX's included.

Data parallelism: with ``rows`` (``parallel.batch_rows``) a rank draws the
whole batch's cameras, then renders only its own rows of it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .ops.codec import encode_bin, encode_bin_latitude
from .ops.geometry import linspace, lat_field, up_field
from .ops.pano import equi2pers


def seed_of(seed: int, *words: int) -> int:
    """The 64-bit seed that ``seeded_generator(seed, *words)`` takes."""
    state = np.random.SeedSequence([seed, *words]).generate_state(2, np.uint32)
    return int(state[0]) << 32 | int(state[1])


def seeded_generator(seed: int, *words: int, device="cpu") -> torch.Generator:
    """A generator whose state is a pure function of (seed, *words)."""
    return torch.Generator(device=device).manual_seed(seed_of(seed, *words))


@dataclasses.dataclass(frozen=True)
class CameraSampler:
    """Uniform camera-parameter ranges (degrees)."""

    vfov: tuple = (30.0, 120.0)
    elevation: tuple = (-60.0, 60.0)
    roll: tuple = (-45.0, 45.0)
    azimuth: tuple = (-180.0, 180.0)

    def sample(self, generator: torch.Generator, n: int) -> Dict[str, torch.Tensor]:
        """n cameras, radians, each uniform over its range, on the
        generator's device."""

        def u(lo_hi):
            lo, hi = math.radians(lo_hi[0]), math.radians(lo_hi[1])
            r = torch.rand(n, generator=generator, device=generator.device)
            return lo + r * (hi - lo)

        return {
            "vfov": u(self.vfov),
            "elevation": u(self.elevation),
            "roll": u(self.roll),
            "azimuth": u(self.azimuth),
        }


def render_batch(
    cams: Dict[str, torch.Tensor],
    pano: torch.Tensor,
    im_h: int = 320,
    im_w: int = 320,
    gravity_classes: Optional[int] = None,
    latitude_classes: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Crops of ``pano`` (Hp, Wp, 3) float under ``cams`` ((B,) radians) and
    their GT, on the pano's device: ``image`` (B, im_h, im_w, 3) float RGB
    (un-normalized), ``gt_gravity`` (B, h, w, 2) unit up-vectors (or int32
    bins with ``gravity_classes``), ``gt_latitude`` (B, h, w, 1) sin(lat)
    (or bins with ``latitude_classes``), ``gt_params`` (B, 3) = roll, pitch,
    vfov in degrees / 90, and ``cams``."""
    dev = pano.device
    cams = {k: torch.as_tensor(v, dtype=torch.float32).to(dev) for k, v in cams.items()}
    vfov, el, roll = cams["vfov"], cams["elevation"], cams["roll"]
    crop = equi2pers(pano, vfov, im_w, im_h, cams["azimuth"], el, roll)
    up = up_field(vfov, im_w, im_h, el, roll)
    lat_deg = lat_field(vfov, im_w, im_h, el, roll)
    batch = {"image": crop, "cams": cams}
    batch["gt_gravity"] = encode_bin(up, gravity_classes) if gravity_classes else up
    if latitude_classes:
        batch["gt_latitude"] = encode_bin_latitude(lat_deg, latitude_classes)
    else:
        batch["gt_latitude"] = torch.sin(torch.deg2rad(lat_deg))[..., None]
    # normalized params in predict_params order (roll, pitch, vfov)
    batch["gt_params"] = torch.stack(
        [torch.rad2deg(roll) / 90.0, torch.rad2deg(el) / 90.0, torch.rad2deg(vfov) / 90.0], dim=-1
    )
    return batch


def make_batch_generator(
    im_h: int = 320,
    im_w: int = 320,
    sampler: CameraSampler = CameraSampler(),
    gravity_classes: Optional[int] = None,
    latitude_classes: Optional[int] = None,
):
    """A function (generator, pano, n, rows=None) -> training batch: ``n``
    cameras from ``sampler`` (drawn on the generator's device), rendered by
    ``render_batch`` on the pano's device; with ``rows`` (a slice) only those
    rows of the ``n`` are rendered. Regression targets by default;
    gravity_classes / latitude_classes give bin targets (e.g. 73 / 180)."""

    def gen(generator: torch.Generator, pano: torch.Tensor, n: int, rows: Optional[slice] = None):
        cams = sampler.sample(generator, n)
        if rows is not None:
            cams = {k: v[rows] for k, v in cams.items()}
        return render_batch(cams, pano, im_h, im_w, gravity_classes, latitude_classes)

    return gen


def pano_from_noise(noise: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """The procedural pano of ``synthetic_pano`` from its (ph//8, pw//8, 3)
    noise: a sky/ground gradient plus the noise upsampled bilinearly (JAX's
    ``jax.image.resize(..., "linear")``, which for upsampling is
    ``F.interpolate(mode="bilinear", align_corners=False)``)."""
    dev = noise.device
    phi = linspace(torch.ones((), device=dev), torch.zeros((), device=dev), ph)[:, None, None]
    base = torch.cat([phi * 180 + 40, phi * 140 + 70, 130 - phi * 50], dim=-1)
    up = F.interpolate(
        noise.permute(2, 0, 1)[None], size=(ph, pw), mode="bilinear", align_corners=False
    )[0].permute(1, 2, 0)
    return (base + up).clamp(0, 255)


def synthetic_pano(generator: torch.Generator, ph: int = 512, pw: int = 1024,
                   device="cuda") -> torch.Tensor:
    """Procedural (ph, pw, 3) float pano (sky/ground gradient + random blobs)
    on ``device``, for training without real data."""
    noise = torch.rand((ph // 8, pw // 8, 3), generator=generator, device=generator.device) * 60
    return pano_from_noise(noise.to(device), ph, pw)


def _stream(seed: int, pano, device):
    """A stream's pano on ``device``: the one given, else ``synthetic_pano``
    from (seed, 0). Its batches draw from (seed, 1, step), as JAX splits its
    key into a pano key and a batch key."""
    if pano is None:
        pano = synthetic_pano(seeded_generator(seed, 0), device=device)
    return torch.as_tensor(pano, dtype=torch.float32).to(device)


def make_step_batch_fn(
    seed: int,
    batch_size: int = 16,
    im_hw=(320, 320),
    pano: Optional[torch.Tensor] = None,
    device="cuda",
    rows: Optional[slice] = None,
    **gen_kwargs,
):
    """(step: int) -> batch, on ``device``, for ``train.make_train_loop``.
    The same seekable stream as ``data_iterator``: batch i is a pure
    function of (seed, i). ``rows``: this data-parallel rank's rows of each
    global batch of ``batch_size`` (``parallel.batch_rows``)."""
    gen = make_batch_generator(im_hw[0], im_hw[1], **gen_kwargs)
    pano = _stream(seed, pano, device)

    def batch_fn(step: int):
        return gen(seeded_generator(seed, 1, int(step)), pano, batch_size, rows)

    return batch_fn


def data_iterator(
    seed: int,
    batch_size: int = 16,
    im_hw=(320, 320),
    pano: Optional[torch.Tensor] = None,
    start_step: int = 0,
    device="cuda",
    rows: Optional[slice] = None,
    **gen_kwargs,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite stream of synthetic training batches on ``device``. Batch i is
    a pure function of (seed, i), so a resumed run (``start_step`` = the
    restored step) continues the stream instead of re-reading it from
    batch 0. ``rows`` as ``make_step_batch_fn``."""
    batch_fn = make_step_batch_fn(seed, batch_size, im_hw, pano, device, rows, **gen_kwargs)
    step = start_step
    while True:
        yield batch_fn(step)
        step += 1
