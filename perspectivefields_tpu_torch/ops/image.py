"""Resampling: numpy resize matrices, bit-exact Pillow uint8 resize, and
torch-bilinear resize of channels-last tensors.

Port of the parts of perspectivefields_tpu/ops/image.py on the inference
path. The JAX package expresses ``F.interpolate(mode='bilinear',
align_corners=False)`` as two matmuls with ``make_resize_matrix``; here the
same function is ``F.interpolate`` itself, and the matrices stay as the
numpy oracle the tests hold it against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point precision for 8bpc


def _torch_bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights matching F.interpolate(mode='bilinear',
    align_corners=False, antialias=False)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
        return m
    # torch computes the source index in float32 (opmath_t); emulate it
    scale = np.float32(in_size) / np.float32(out_size)
    for i in range(out_size):
        src = np.maximum(
            scale * np.float32(i + 0.5) - np.float32(0.5), np.float32(0.0)
        )
        i0 = int(np.floor(src))
        i1 = min(i0 + 1, in_size - 1)
        w1 = float(src - np.float32(i0))
        m[i, i0] += 1.0 - w1
        m[i, i1] += w1
    return m


def _pil_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the triangle (bilinear) filter:
    per-output-pixel (xmin, count) bounds and normalized float weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # triangle filter support == 1
    ksize = int(np.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), dtype=np.int64)
    weights = np.zeros((out_size, ksize), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        n = xmax - xmin
        ww = 0.0
        for x in range(n):
            arg = (x + xmin - center + 0.5) / filterscale
            w = max(0.0, 1.0 - abs(arg))
            weights[xx, x] = w
            ww += w
        if ww != 0.0:
            weights[xx, :n] /= ww
        bounds[xx] = (xmin, n)
    return bounds, weights


def _pil_bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float weights of PIL bilinear (box-filtered when
    downscaling)."""
    bounds, weights = _pil_coeffs(in_size, out_size)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        xmin, n = bounds[i]
        m[i, xmin : xmin + n] = weights[i, :n]
    return m


def _nearest_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) selection matrix of F.interpolate(mode='nearest')."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    idx = np.minimum((np.arange(out_size) * in_size) // out_size, in_size - 1)
    m[np.arange(out_size), idx] = 1.0
    return m


@functools.lru_cache(maxsize=256)
def make_resize_matrix(in_size: int, out_size: int, method: str = "torch_bilinear"):
    """(out_size, in_size) float32 resampling matrix; method is
    'torch_bilinear' | 'pil_bilinear' | 'nearest'."""
    makers = {
        "torch_bilinear": _torch_bilinear_matrix,
        "pil_bilinear": _pil_bilinear_matrix,
        "nearest": _nearest_matrix,
    }
    if method not in makers:
        raise ValueError(f"unknown resize method: {method}")
    return makers[method](in_size, out_size).astype(np.float32)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize channels-last (..., H, W, C) -> (..., out_h, out_w, C) with
    F.interpolate(bilinear, align_corners=False) semantics. Integer inputs
    are promoted to float32."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if x.shape[-3:-1] == (out_h, out_w):
        return x
    lead = x.shape[:-3]
    y = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(out_h, out_w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, x.shape[-1])


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize channels-last (..., H, W, C) -> (..., out_h, out_w, C) with
    F.interpolate(mode='nearest') semantics, by index (the rows of
    ``_nearest_matrix``)."""
    h, w = x.shape[-3], x.shape[-2]
    idx_h = torch.from_numpy(np.minimum((np.arange(out_h) * h) // out_h, h - 1)).to(x.device)
    idx_w = torch.from_numpy(np.minimum((np.arange(out_w) * w) // out_w, w - 1)).to(x.device)
    return x.index_select(-3, idx_h).index_select(-2, idx_w)


# ---------------------------------------------------------------------------
# Bit-exact Pillow uint8 resize (host-side, numpy)
# ---------------------------------------------------------------------------


def _pil_int_weights(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's normalize_coeffs_8bpc: float weights -> fixed point with
    round-half-away-from-zero at 22 bits."""
    scaled = _pil_bilinear_matrix(in_size, out_size) * (1 << _PRECISION_BITS)
    return np.where(
        scaled < 0, (scaled - 0.5).astype(np.int64), (scaled + 0.5).astype(np.int64)
    )


@functools.lru_cache(maxsize=64)
def _pil_taps(in_size: int, out_size: int):
    """The banded fixed-point weights as (out, taps) source indices and
    weights; taps past an output's window have weight 0."""
    kk = _pil_int_weights(in_size, out_size)
    bounds, _ = _pil_coeffs(in_size, out_size)
    taps = np.arange(int(bounds[:, 1].max()))
    idx = np.minimum(bounds[:, :1] + taps, in_size - 1)
    w = np.where(taps < bounds[:, 1:], np.take_along_axis(kk, idx, axis=1), 0)
    return idx, w


def _pil_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One fixed-point resampling pass over ``axis`` with clip8 rounding
    (Pillow's ImagingResampleHorizontal_8bpc). Integer sums over the few
    taps of each output: the same bits as the dense product, far faster."""
    idx, w = _pil_taps(img.shape[axis], out_size)
    x = np.moveaxis(img, axis, 0).astype(np.int64)
    bcast = (-1,) + (1,) * (x.ndim - 1)
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(w.shape[1]):
        acc += w[:, j].reshape(bcast) * x[idx[:, j]]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    out = np.where(acc <= 0, np.uint8(0), out)  # clip8 clamps before the shift
    return np.moveaxis(out, 0, axis)


def pil_resize_uint8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bit-exact PIL.Image.resize(BILINEAR) of a uint8 HWC / HW image:
    horizontal pass, then vertical, fixed point with uint8 rounding between
    (Pillow's Resample.c)."""
    if img.dtype != np.uint8:
        raise ValueError(f"pil_resize_uint8 takes uint8, got {img.dtype}")
    out = img
    if img.shape[1] != out_w:
        out = _pil_pass(out, out_w, axis=1)
    if img.shape[0] != out_h:
        out = _pil_pass(out, out_h, axis=0)
    return out
