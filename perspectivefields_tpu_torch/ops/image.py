"""Resampling: numpy resize matrices, bit-exact Pillow uint8 resize, and
resizes of channels-last tensors on any device.

Port of perspectivefields_tpu/ops/image.py. The JAX package expresses every
resize as two matmuls with ``make_resize_matrix`` (plus exact elementwise
forms of the 2x cases); here ``torch_bilinear`` is ``F.interpolate`` itself,
``nearest`` an index gather, and ``pil_bilinear`` the matrices' few nonzero
taps per output as elementwise ops (``make_resize``), so an f32 resize is
IEEE-exact whatever the global TF32 flags say. The matrices stay as the
numpy oracle the tests hold these against. ``make_fused_preprocess`` is
JAX's fused device preprocess: the H pass, then a ``kron(Mw, diag(1/std))``
W pass with a bias.
"""

from __future__ import annotations

import functools
from collections.abc import Callable

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


def _up2x_axis_torch(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 2x upsample along ``axis`` (-3 or -2 of (..., H, W, C)) with
    F.interpolate(bilinear, align_corners=False)'s taps as elementwise ops:
    out[2i] = 0.25 x[i-1] + 0.75 x[i], out[2i+1] = 0.75 x[i] + 0.25 x[i+1]
    (edge-clamped). ``resize_bilinear`` computes the same taps in one
    ``F.interpolate`` kernel, rounding once where this rounds per pass, so
    this form is the oracle the tests hold both it and JAX's against."""
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    prev = x.index_select(axis, (idx - 1).clamp_min(0))
    nxt = x.index_select(axis, (idx + 1).clamp_max(n - 1))
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    axis %= x.ndim
    y = torch.stack([even, odd], dim=axis + 1)
    return y.reshape(*x.shape[:axis], 2 * n, *x.shape[axis + 1:])


def _up2x_adjoint_axis(g: torch.Tensor, axis: int) -> torch.Tensor:
    """The adjoint of ``_up2x_axis_torch`` along ``axis``: input row i gets
    0.75 of the two output rows it centres, 0.25 of out[2i + 2] and of
    out[2i - 1], and the edge rows the clamped taps of out[0] and
    out[2n - 1]. Elementwise, in a fixed order."""
    axis %= g.ndim
    n = g.shape[axis] // 2
    ge, go = g.unflatten(axis, (n, 2)).unbind(axis + 1)
    zero = torch.zeros_like(ge.narrow(axis, 0, 1))
    gx = 0.75 * (ge + go) + 0.25 * (torch.cat([ge.narrow(axis, 1, n - 1), zero], axis)
                                    + torch.cat([zero, go.narrow(axis, 0, n - 1)], axis))
    gx.narrow(axis, 0, 1).add_(0.25 * ge.narrow(axis, 0, 1))
    gx.narrow(axis, n - 1, 1).add_(0.25 * go.narrow(axis, n - 1, 1))
    return gx


class _Up2xBilinear(torch.autograd.Function):
    """``F.interpolate``'s 2x bilinear upsample of channels-last (..., H, W,
    C), with a backward that gives the same gradient without CUDA's
    atomic adds (``_up2x_adjoint_axis`` over W, then H, in float32 or
    wider): a training step on the card is then reproducible."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return resize_bilinear(x, 2 * x.shape[-3], 2 * x.shape[-2])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        g = g.to(torch.promote_types(g.dtype, torch.float32))
        return _up2x_adjoint_axis(_up2x_adjoint_axis(g, -2), -3).to(ctx.dtype)


def up2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of a float channels-last (..., H, W, C) tensor,
    as ``resize_bilinear``, with a deterministic backward."""
    return _Up2xBilinear.apply(x)


def _down2x_axis_pil(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 2x downsample along ``axis`` with PIL bilinear's (antialiased
    triangle) taps: interior out[i] = 0.125 x[2i-1] + 0.375 x[2i] + 0.375
    x[2i+1] + 0.125 x[2i+2]; the first and last rows renormalize the
    truncated window (weights [3, 3, 1] / 7). The taps of
    ``_pil_bilinear_matrix(2n, n)``, rounded per op in ``x``'s dtype."""
    axis %= x.ndim
    n = x.shape[axis] // 2

    def sub(t, start, stop, step=1):
        return t[(slice(None),) * axis + (slice(start, stop, step),)]

    xe, xo = sub(x, 0, 2 * n, 2), sub(x, 1, 2 * n, 2)
    core = 0.375 * (sub(xe, 1, n - 1) + sub(xo, 1, n - 1)) + 0.125 * (
        sub(xo, 0, n - 2) + sub(xe, 2, n)
    )
    e3, e1 = 3.0 / 7.0, 1.0 / 7.0
    first = e3 * sub(x, 0, 1) + e3 * sub(x, 1, 2) + e1 * sub(x, 2, 3)
    last = (e1 * sub(x, 2 * n - 3, 2 * n - 2) + e3 * sub(x, 2 * n - 2, 2 * n - 1)
            + e3 * sub(x, 2 * n - 1, 2 * n))
    return torch.cat([first, core, last], dim=axis)


@functools.lru_cache(maxsize=256)
def _resize_taps(in_size: int, out_size: int, method: str):
    """The nonzero band of each row of ``make_resize_matrix(in_size,
    out_size, method)`` as (out, taps) source indices and float32 weights;
    taps past a row's band have weight 0."""
    m = make_resize_matrix(in_size, out_size, method)
    nz = m != 0
    first = nz.argmax(axis=1)
    last = in_size - 1 - nz[:, ::-1].argmax(axis=1)
    taps = np.arange(int((last - first).max()) + 1)
    idx = np.minimum(first[:, None] + taps, in_size - 1)
    w = np.where(first[:, None] + taps <= last[:, None], np.take_along_axis(m, idx, axis=1), 0)
    return idx.astype(np.int64), w.astype(np.float32)


def _resample(x: torch.Tensor, axis: int, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One resampling pass over ``axis`` (-3 or -2): the sum over taps of
    weight x gathered row, in f32, elementwise (no matrix product)."""
    bcast = (-1,) + (1,) * (-axis - 1)
    y = None
    for j in range(idx.shape[1]):
        t = x.index_select(axis, idx[:, j]) * w[:, j].reshape(bcast)
        y = t if y is None else y + t
    return y


def make_resize(in_hw, out_hw, method: str, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn((..., in_h, in_w, C) tensor on ``device``) -> (..., out_h, out_w, C):
    the resize matrices' taps (``_resize_taps``) placed on the device once,
    then an H pass and a W pass as elementwise f32 ops, rounded to the input's
    dtype at the end (integer inputs give float32). The same function as
    JAX's two-matmul resize at ``precision="highest"``, summed over each
    row's nonzero band only."""
    ops = []
    for axis, n_in, n_out in ((-3, in_hw[0], out_hw[0]), (-2, in_hw[1], out_hw[1])):
        if n_in != n_out:
            idx, w = _resize_taps(n_in, n_out, method)
            ops.append((axis, torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)))

    def fn(x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype if x.is_floating_point() else torch.float32
        y = x.to(torch.float32)
        for axis, idx, w in ops:
            y = _resample(y, axis, idx, w)
        return y.to(dtype)

    return fn


def resize_bilinear(
    x: torch.Tensor, out_h: int, out_w: int, method: str = "torch_bilinear"
) -> torch.Tensor:
    """Resize channels-last (..., H, W, C) -> (..., out_h, out_w, C).

    method: 'torch_bilinear' (F.interpolate(bilinear, align_corners=False)),
    'pil_bilinear' (PIL's antialiased triangle filter in float: within 1 LSB
    of the bit-exact uint8 resize) or 'nearest' (F.interpolate(nearest)).
    Integer inputs are promoted to float32. An exact 2x PIL downsample of a
    tensor with C >= 8 channels takes JAX's elementwise phase form
    (``_down2x_axis_pil``); JAX's 2x torch-bilinear form is F.interpolate's
    own kernel here (see ``_up2x_axis_torch``)."""
    if method not in ("torch_bilinear", "pil_bilinear", "nearest"):
        raise ValueError(f"unknown resize method: {method}")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    if method == "nearest":
        return resize_nearest(x, out_h, out_w)
    if method == "pil_bilinear":
        if x.shape[-1] >= 8 and (2 * out_h, 2 * out_w) == (h, w) and min(out_h, out_w) >= 2:
            # PIL resamples horizontally first, then vertically
            return _down2x_axis_pil(_down2x_axis_pil(x, -2), -3)
        return make_resize((h, w), (out_h, out_w), method, x.device)(x)
    lead = x.shape[:-3]
    y = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(out_h, out_w), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, x.shape[-1])


def make_fused_preprocess(
    in_hw, out_hw, mean, std, dtype=torch.bfloat16, method: str = "pil_bilinear"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(uint8 images (B, in_h, in_w, C)) -> (B, out_h, out_w, C) in
    ``dtype``: resize + per-channel normalize as two matrix products over
    (w*c)-flattened rows, matching ``(resize_bilinear(x, ..., method) - mean)
    / std`` to ``dtype`` rounding.

    The H pass contracts rows with the resize matrix; the W pass multiplies
    by kron(Mw, diag(1/std)), so the normalize rides along, and -mean/std is
    the output bias (resize rows sum to 1). In float32 both products run in
    float64 and round once, so the result does not depend on the global TF32
    flags; in bfloat16 they are bfloat16 products, as in JAX. The operands
    move to the images' device on first use there."""
    in_h, in_w = in_hw
    out_h, out_w = out_hw
    mean64 = np.asarray(mean, np.float64)
    std64 = np.asarray(std, np.float64)
    c = mean64.shape[0]
    mm_dtype = torch.float64 if dtype == torch.float32 else dtype
    mw64 = (_pil_bilinear_matrix if method == "pil_bilinear" else _torch_bilinear_matrix)(in_w, out_w)
    host = (
        torch.from_numpy(make_resize_matrix(in_h, out_h, method)),
        torch.from_numpy(np.einsum("ow,cd->wcod", mw64, np.diag(1.0 / std64)).reshape(
            in_w * c, out_w * c)),
        torch.from_numpy(np.tile(-mean64 / std64, out_w)),
    )
    placed: dict = {}

    def fn(images: torch.Tensor) -> torch.Tensor:
        if images.device not in placed:
            placed[images.device] = [t.to(images.device, mm_dtype) for t in host]
        mh, kr, bias = placed[images.device]
        b = images.shape[0]
        x = torch.matmul(mh, images.reshape(b, in_h, in_w * c).to(mm_dtype))
        y = torch.addmm(bias, x.reshape(b * out_h, in_w * c), kr)
        return y.reshape(b, out_h, out_w, c).to(dtype)

    return fn


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize channels-last (..., H, W, C) -> (..., out_h, out_w, C) with
    F.interpolate(mode='nearest') semantics, by index (the rows of
    ``_nearest_matrix``); a whole-factor downsample is a strided slice, whose
    backward, unlike index_select's on CUDA, adds nothing atomically."""
    h, w = x.shape[-3], x.shape[-2]
    if h % out_h == 0 and w % out_w == 0:
        return x[..., :: h // out_h, :: w // out_w, :]
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
