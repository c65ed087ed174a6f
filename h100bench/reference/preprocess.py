"""Plain preprocess and postprocess: what ``inference_batch`` does around
the network, worked out again in plain torch.

* ``pil_resize``: Pillow's 8-bit bilinear resize (``Image.resize(...,
  BILINEAR)``: the antialiased triangle filter, fixed-point weights of 22
  bits, a horizontal pass then a vertical one, each rounded and clipped to
  uint8), in int64 arithmetic, so it gives Pillow's bits on any device.
* ``normalize``: (x - mean) / std in float32.
* ``postprocess``: the network-resolution fields back to the image's size:
  the up-vectors scaled by (W/w, H/h), bilinearly resized
  (align_corners=False) and renormalized; the latitude resized, then asin in
  degrees.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_BITS = 22  # Pillow's fixed-point precision for 8-bit images


def _coeffs(n_in: int, n_out: int):
    """Pillow's precompute_coeffs for the triangle filter, normalized and in
    fixed point: (n_out, taps) source indices and int64 weights."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = fscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((n_out, ksize), np.int64)
    wts = np.zeros((n_out, ksize), np.int64)
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        w = np.array([max(0.0, 1.0 - abs((x + lo - center + 0.5) / fscale)) for x in range(hi - lo)])
        total = w.sum()
        if total != 0.0:
            w = w / total
        scaled = w * (1 << _BITS)
        fixed = np.where(scaled < 0, (scaled - 0.5).astype(np.int64), (scaled + 0.5).astype(np.int64))
        idx[o, : hi - lo] = np.arange(lo, hi)
        idx[o, hi - lo:] = max(hi - 1, 0)
        wts[o, : hi - lo] = fixed
    return idx, wts


def _pass(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """One fixed-point pass of (..., H, W, C) int64 over ``axis`` (-3 or -2)."""
    idx, wts = _coeffs(x.shape[axis], n_out)
    idx = torch.from_numpy(idx).to(x.device)
    wts = torch.from_numpy(wts).to(x.device)
    bcast = (-1,) + (1,) * (-axis - 1)
    acc = torch.full_like(x.index_select(axis, idx[:, 0]), 1 << (_BITS - 1))
    for j in range(idx.shape[1]):
        acc += wts[:, j].reshape(bcast) * x.index_select(axis, idx[:, j])
    return torch.where(acc <= 0, 0, (acc >> _BITS).clamp(0, 255))


def pil_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, C) uint8 -> (..., out_h, out_w, C) uint8, Pillow's bits."""
    x = img.to(torch.int64)
    if img.shape[-2] != out_w:
        x = _pass(x, out_w, -2)
    if img.shape[-3] != out_h:
        x = _pass(x, out_h, -3)
    return x.to(torch.uint8)


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x.to(torch.float32) - m) / s


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if x.shape[1:3] == (h, w):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def postprocess(gravity: torch.Tensor, latitude: torch.Tensor, out_h: int, out_w: int):
    """(B, h, w, 2) unit up-vectors and (B, h, w, 1) sin-latitude at the
    network's size -> (B, out_h, out_w, 2) unit up-vectors and (B, out_h,
    out_w) latitude in degrees."""
    h, w = gravity.shape[1:3]
    scale = torch.tensor([out_w / w, out_h / h], dtype=gravity.dtype, device=gravity.device)
    g = _resize(gravity * scale, out_h, out_w)
    g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True).clamp_min(1e-12)
    lat = _resize(latitude, out_h, out_w)[..., 0]
    return g, torch.rad2deg(torch.asin(lat.clamp(-1.0, 1.0)))
