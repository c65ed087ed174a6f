"""Fused ConvNeXt block: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/convnext_block.py``
(``convnext_block_fused``, whose ``pallas_call`` runs ``_block_kernel``;
oracle ``_xla_reference``). The CUDA source is ``csrc/convnext_block.cu``;
its header says what bounds the block on the H100 (the per-element work
and bytes; unfused, the activation and the 4x hidden map cross HBM about
six times) and what the design does about it (one pass per token tile, the
hidden map walked in chunks on chip).

    z = dw7x7(x) + dwb (f32);  y = T(LN(z) * lns + lnb), var = E[z^2] - mu^2
    out = T(x + (T(gelu_f32(y.W1^T + b1)).W2^T + b2) * gamma)

Weights keep the torch layouts: the depthwise kernel (C, 1, 7, 7), W1
(4C, C) and W2 (C, 4C) as nn.Linear. ``convnext_block`` launches the kernel
for CUDA tensors and raises on anything the kernel does not take; only CPU
tensors go to ``convnext_block_reference``, the same function in plain
torch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops.activations import gelu_f32
from .build import library, raise_on_error
from .mixffn import choose_split, sm_count

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

# csrc/convnext_block.cu's limits and shared-memory layout (kMaxTokens,
# the bf16 kernel's HC, kMaxOutFrags, smem_bytes)
MAX_TOKENS = 64
HIDDEN_CHUNKS = (64, 32)
MAX_OUT_TILES = 16 * 6  # warps x 16x16 accumulators per warp (bf16)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_convnext_block": (
        [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    ),
}


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def smem_bytes(dtype: torch.dtype, c: int, no: int, hc: int = 64) -> int:
    """Shared memory of one block (csrc/convnext_block.cu: smem_bytes);
    ``hc`` is the bf16 kernel's hidden chunk."""
    if dtype == torch.float32:
        return (2 * _align128(no * c * 4) + _align128(no * 68 * 4) + _align128(32 * 33 * 4)
                + 256)
    weights = _align128(hc * (c + 8) * 2) + _align128(c * (hc + 8) * 2)
    return (max(_align128(no * c * 4), weights, 16 * 256 * 4) + _align128(no * (c + 8) * 2)
            + _align128(no * (hc + 4) * 4) + _align128(no * (hc + 8) * 2) + 256)


@functools.lru_cache(maxsize=None)
def choose_tokens(c: int, dtype: torch.dtype) -> tuple[int, int]:
    """Tokens per block and the bf16 kernel's hidden chunk: the most tokens
    (of 64, 48, 32, 16) that fit the bf16 accumulators and shared memory,
    so each block streams the weights over as many tokens as it can hold,
    with chunks of 64 hidden channels where they fit, else 32."""
    for no in (64, 48, 32, 16):
        if dtype == torch.bfloat16 and (no // 16) * (c // 16) > MAX_OUT_TILES:
            continue
        for hc in HIDDEN_CHUNKS:
            if smem_bytes(dtype, c, no, hc) <= SMEM_LIMIT:
                return no, hc
    raise ValueError(f"convnext_block: C={c} ({dtype}) does not fit shared memory")


def stage_channels(h: int, w: int, c: int, no: int) -> int:
    """Channels per copy of x's rows into shared memory for the bf16 conv
    (csrc/convnext_block.cu: dwconv7_staged): the most of 64, 32, 16, 8
    that divide C and whose rows, the most ``no`` tokens and their 3-pixel
    halo span, fit in the LayerNorm output's room (no x (C + 8))."""
    rows = min(h, (no - 1) // w + 8)
    for cc in (64, 32, 16, 8):
        if c % cc == 0 and rows * w * cc <= no * (c + 8):
            return cc
    raise ValueError(f"convnext_block: a {h}x{w} map is too wide for the kernel's conv")


def convnext_block_reference(x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma, eps=1e-6):
    """Plain-torch version of the kernel, with the kernel's casts (JAX:
    _block_kernel / _xla_reference): the 7x7 depthwise conv in f32, not
    rounded; LayerNorm with the fast variance E[z^2] - mu^2; its output
    rounded; pwconv1 in f32, GELU by the dtype rule, rounded; pwconv2 in
    f32; gamma and the residual in f32; one rounding at the end."""
    cdt, f32 = x.dtype, torch.float32
    c = x.shape[-1]
    z = F.conv2d(
        x.to(f32).permute(0, 3, 1, 2), dwk.to(f32), padding=3, groups=c
    ).permute(0, 2, 3, 1) + dwb.to(f32)
    mu = z.mean(dim=-1, keepdim=True)
    var = (z * z).mean(dim=-1, keepdim=True) - mu * mu
    y = ((z - mu) * torch.rsqrt(var + eps) * lns.to(f32) + lnb.to(f32)).to(cdt)
    g = gelu_f32(y.to(f32) @ w1.to(f32).t() + b1.to(f32), cdt).to(cdt)
    h = (g.to(f32) @ w2.to(f32).t() + b2.to(f32)) * gamma.to(f32)
    return (x.to(f32) + h).to(cdt)


def check_kernel_args(x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma) -> None:
    """Raise ValueError unless the kernel takes these tensors: one dtype
    (float32 or bfloat16), one device, contiguous, 32-byte aligned,
    x (B, H, W, C) with C % 32 == 0 and a hidden width of 4C."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"convnext_block: dtype {x.dtype} not supported")
    for t in (x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                "convnext_block: every tensor must share x's dtype and device "
                f"({x.dtype}, {x.device}); got {t.dtype}, {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("convnext_block: tensors must be contiguous")
        if t.data_ptr() % 32:  # 32-byte MMA tiles
            raise ValueError("convnext_block: tensors must be 32-byte aligned")
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(
            f"convnext_block: x must be a non-empty (B, H, W, C) map, got {tuple(x.shape)}"
        )
    c = x.shape[-1]
    if c % 32:
        raise ValueError(f"convnext_block: needs C % 32 == 0, got C={c}")
    shapes = {
        "dwk": (dwk.shape, (c, 1, 7, 7)), "dwb": (dwb.shape, (c,)),
        "lns": (lns.shape, (c,)), "lnb": (lnb.shape, (c,)),
        "w1": (w1.shape, (4 * c, c)), "b1": (b1.shape, (4 * c,)),
        "w2": (w2.shape, (c, 4 * c)), "b2": (b2.shape, (c,)), "gamma": (gamma.shape, (c,)),
    }
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"convnext_block: {name} has shape {tuple(got)}, want {want}")


def _library():
    return library("convnext_block", _SIGNATURES)


def load() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def convnext_block(x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma, eps: float = 1e-6):
    """One ConvNeXt block on a (B, H, W, C) map; returns (B, H, W, C). CUDA
    tensors run the kernel (or raise); CPU tensors run
    ``convnext_block_reference``."""
    global LAUNCHES
    args = (x, dwk, dwb, lns, lnb, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu":
        return convnext_block_reference(*args, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"convnext_block: no kernel for device {x.device}")
    check_kernel_args(*args)
    b, h, w, c = x.shape
    no, hc = choose_tokens(c, x.dtype)
    cc, nsplit = 0, 1
    if x.dtype == torch.bfloat16:
        cc = stage_channels(h, w, c, no)
        nsplit = choose_split(b * -(-h * w // no), 4 * c // hc, sm_count(x.device))
    lib = _library()
    out = torch.empty_like(x)
    partial = None
    if nsplit > 1:
        partial = torch.empty((nsplit, *x.shape), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pf_convnext_block(
            _DTYPE_CODES[x.dtype], *[t.data_ptr() for t in args], out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            b, h, w, c, no, hc, cc, float(eps), nsplit,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on_error(lib, err, "convnext_block")
    LAUNCHES += 1
    return out
