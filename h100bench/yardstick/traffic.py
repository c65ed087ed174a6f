"""The benchmark's one traffic generator: every input a cell sends, made
from its seed and its traffic file's parameters.

* ``frame_pool``: distinct uint8 BGR frames of one size (the serving bench's
  pool: 256 frames of 640x640 are 315 MB, beyond the host's caches).
* ``size_order``: the order in which a mix of image sizes is sent. Every
  seed sends the same number of each size (whole rounds, each round one
  frame of every size in a seeded order), so seeds change the order and the
  pixels, never the amount of work.
* ``train_pool``: batches of a training stream: seeded cameras, their
  up-vector and latitude fields (a frozen copy of the geometry the
  training program uses), camera targets, and seeded images, kept in pinned
  host memory as a loader would keep them.
* ``sample``: which answers of a window are compared with the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# purposes of the seed's sub-streams
WEIGHTS, FRAMES, SAMPLE, ORDER, CAMERAS = range(1, 6)


def substream(seed: int, purpose: int, *words: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed, purpose, *words])


def rng(seed: int, purpose: int, *words: int) -> np.random.Generator:
    return np.random.default_rng(substream(seed, purpose, *words))


def torch_generator(seed: int, purpose: int, device) -> torch.Generator:
    word = substream(seed, purpose).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word) >> 1)


def frame_pool(seed: int, n: int, h: int, w: int, which: int = 0) -> np.ndarray:
    """(n, h, w, 3) uint8 frames of uniform noise."""
    r = rng(seed, FRAMES, which)
    return np.frombuffer(r.bytes(n * h * w * 3), np.uint8).reshape(n, h, w, 3)


def size_order(seed: int, n_sizes: int, rounds: int) -> list[int]:
    """Size indices for ``rounds`` rounds, each a seeded permutation."""
    r = rng(seed, ORDER)
    return [int(i) for _ in range(rounds) for i in r.permutation(n_sizes)]


def sample(seed: int, population: int, k: int) -> list[int]:
    """``k`` distinct indices of range(population), sorted, from the seed."""
    k = min(k, population)
    return sorted(int(i) for i in rng(seed, SAMPLE).choice(population, size=k, replace=False))


# ----------------------------------------------------- training stream


def _up_field(focal_rel, im_w, im_h, elevation, roll):
    """Unit up-vectors (B, H, W, 2) of centred pinhole cameras."""
    f, el, rl = (t[:, None, None] for t in (focal_rel, elevation, roll))
    dev = el.device
    gy, gx = torch.meshgrid(torch.arange(im_h, dtype=torch.float32, device=dev) + 0.5,
                            torch.arange(im_w, dtype=torch.float32, device=dev) + 0.5, indexing="ij")
    focal = f * im_h
    s = torch.sin(el)
    s = torch.where(s.abs() < 1e-12, torch.full_like(s, 1e-12), s)
    vx = torch.sin(rl) * torch.cos(el) * focal / (-s) + 0.5 * im_w
    vy = torch.cos(rl) * torch.cos(el) * focal / (-s) + 0.5 * im_h
    ux = (vx - gx) * torch.sign(el)
    uy = (vy - gy) * torch.sign(el)
    ux = torch.where(el == 0, -torch.sin(rl), ux)
    uy = torch.where(el == 0, -torch.cos(rl), uy)
    n = torch.sqrt(ux * ux + uy * uy).clamp_min(1e-12)
    return torch.stack([ux / n, uy / n], dim=-1)


def _lat_field(focal_rel, im_w, im_h, elevation, roll):
    """Latitude in degrees (B, H, W) of centred pinhole cameras."""
    def span(n):
        frac = torch.arange(n - 1, dtype=torch.float32, device=elevation.device) / (n - 1)
        return torch.cat([-n / 2.0 * (1.0 - frac) + n / 2.0 * frac,
                          torch.full((1,), n / 2.0, device=elevation.device)])

    focal = (focal_rel * im_h)[:, None, None]
    x = span(im_w)[None, None, :] / focal
    y = span(im_h)[None, :, None] / focal
    cr, sr = torch.cos(roll)[:, None, None], torch.sin(roll)[:, None, None]
    ce, se = torch.cos(elevation)[:, None, None], torch.sin(elevation)[:, None, None]
    xw = x * cr - y * sr
    yw = x * ce * sr + y * ce * cr - se
    zw = x * se * sr + y * se * cr + ce
    return torch.rad2deg(-torch.atan2(yw, torch.sqrt(xw**2 + zw**2)))


def train_pool(seed: int, n_batches: int, batch: int, size: int, pixel_mean, device,
               ranges: dict) -> list[dict]:
    """``n_batches`` training batches in pinned host memory (plain host
    memory when ``device`` is the CPU): ``image`` (B, S, S, 3) float32 noise
    minus the pixel mean, as the trainer feeds it; ``gt_gravity`` (B, S, S,
    2); ``gt_latitude`` (B, S, S, 1) sin(latitude); ``gt_params`` (B, 3)
    roll, pitch, vfov in degrees / 90. Cameras are uniform over ``ranges``
    (degrees); everything is drawn on ``device`` from the seed."""
    gen = torch_generator(seed, CAMERAS, device)
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=device)
    pin = torch.device(device).type == "cuda"
    pool = []
    for _ in range(n_batches):
        cams = {}
        for key in ("vfov", "elevation", "roll"):
            lo, hi = (math.radians(v) for v in ranges[key])
            cams[key] = lo + torch.rand(batch, generator=gen, device=device) * (hi - lo)
        focal = 1.0 / (2.0 * torch.tan(cams["vfov"] / 2.0))
        img = torch.rand((batch, size, size, 3), generator=gen, device=device) * 255.0 - mean
        lat = _lat_field(focal, size, size, cams["elevation"], cams["roll"])
        dev_batch = {
            "image": img,
            "gt_gravity": _up_field(focal, size, size, cams["elevation"], cams["roll"]),
            "gt_latitude": torch.sin(torch.deg2rad(lat))[..., None],
            "gt_params": torch.rad2deg(torch.stack([cams["roll"], cams["elevation"], cams["vfov"]], -1)) / 90.0,
        }
        pool.append({k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin).copy_(v)
                     for k, v in dev_batch.items()})
    return pool
