"""Fused MixFFN: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/mixffn.py``
(``mixffn_fused``, whose ``pallas_call`` runs ``_ffn_kernel``). The CUDA
source is ``csrc/mixffn.cu``; its header says what bounds the FFN on the
H100 (the per-element work and bytes of the 4C-wide hidden map) and what the
design does about it (a block walks the hidden dimension in chunks, so the
hidden map never leaves the chip).

    h = T(x.W1^T + b1), zero outside the image;  z = dw3x3(h) + dwb (f32)
    out = T(T(gelu_f32(z)).W2^T + b2)

Weights keep the torch layouts: W1 (4C, C), W2 (C, 4C) as nn.Linear, the
depthwise kernel (4C, 1, 3, 3). ``mixffn`` launches the kernel for CUDA
tensors and raises on anything the kernel does not take; only CPU tensors
go to ``mixffn_reference``, the same function in plain torch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..ops.activations import gelu_f32
from .build import library, raise_on_error

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

# csrc/mixffn.cu's limits and shared-memory layout (kHC, kMaxHalo,
# kWarpsTC x kMaxOutFrags, smem_bytes)
HIDDEN_CHUNK = 64
MAX_HALO = 128
MAX_OUT_TILES = 16 * 4  # warps x 16x16 accumulators per warp (bf16)
MAX_SPLIT = 8  # most blocks a tile's hidden dimension is split over (bf16)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_mixffn": [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def smem_bytes(dtype: torch.dtype, c: int, th: int, tw: int) -> int:
    """Shared memory of one block (csrc/mixffn.cu: smem_bytes)."""
    nhp, nop = _ceil16((th + 2) * (tw + 2)), _ceil16(th * tw)
    hf_ld, gs_ld = HIDDEN_CHUNK + 4, HIDDEN_CHUNK + 8
    small = 2 * 256 + 2 * MAX_HALO * 4  # biases, index tables
    if dtype == torch.float32:
        return (_align128(nhp * c * 4) + _align128(nhp * hf_ld * 4) + _align128(nop * hf_ld * 4)
                + _align128(nop * c * 4) + _align128(32 * 33 * 4) + small)
    weights = _align128(HIDDEN_CHUNK * (c + 8) * 2) + _align128(c * gs_ld * 2)
    return (_align128(nhp * (c + 8) * 2) + max(weights, 16 * 256 * 4)
            + _align128(nhp * hf_ld * 4) + _align128(nop * gs_ld * 2) + small)


def _chunk_cycles(th: int, tw: int, c: int) -> float:
    """Rough cycles of one 64-channel hidden chunk of one bf16 block, from
    per-phase clock counts of the kernel on an H100: fc1 ~200 cycles per
    16x16 tile-step of the busiest warp (16 warps: 4 column tiles x 4 row
    groups), fc2 ~230 per tile-step, ~44 per halo or output row for the
    mask, taps and GELU, ~2000 for staging and barriers."""
    nhalo, no = (th + 2) * (tw + 2), th * tw
    fc1 = -(-_ceil16(nhalo) // 64) * (c // 16) * 200
    fc2 = -(-(_ceil16(no) // 16) * (c // 16) // 16) * 4 * 230
    return fc1 + fc2 + (nhalo + no) * 44 + 2000


@functools.lru_cache(maxsize=None)
def choose_tile(
    b: int, h: int, w: int, c: int, dtype: torch.dtype, sms: int = 132
) -> tuple[int, int]:
    """The output tile (TH, TW) a block owns for a (b, h, w, c) map: among
    the tiles the kernel takes (halo <= 128 tokens, the bf16 accumulators,
    shared memory), the one whose launch takes the fewest cycles by
    ``_chunk_cycles``, counting the waves of blocks on ``sms`` SMs (one
    block fits an SM) and the hidden split of ``choose_split``."""
    chunks = 4 * c // HIDDEN_CHUNK
    best = None
    for th in range(1, h + 1):
        for tw in range(1, w + 1):
            if _ceil16((th + 2) * (tw + 2)) > MAX_HALO:
                break
            if dtype == torch.bfloat16 and _ceil16(th * tw) // 16 * (c // 16) > MAX_OUT_TILES:
                continue
            if smem_bytes(dtype, c, th, tw) > SMEM_LIMIT:
                continue
            blocks = b * -(-h // th) * -(-w // tw)
            split = choose_split(blocks, chunks, sms) if dtype == torch.bfloat16 else 1
            waves = -(-blocks * split // sms)
            cost = waves * -(-chunks // split) * _chunk_cycles(th, tw, c)
            if best is None or cost < best[0]:
                best = (cost, th, tw)
    if best is None:
        raise ValueError(f"mixffn: no tile fits C={c} ({dtype}) in shared memory")
    return best[1], best[2]


def choose_split(blocks: int, chunks: int, sm_count: int) -> int:
    """Blocks to split each tile's hidden dimension over at bf16: as many as
    the SMs the tiles leave idle allow (at most MAX_SPLIT, at most one chunk
    each); 1 where the tiles fill the card."""
    return max(1, min(MAX_SPLIT, chunks, sm_count // blocks))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mixffn_reference(x, w1, b1, dwk, dwb, w2, b2):
    """Plain-torch version of the kernel, with the kernel's casts (JAX:
    _ffn_kernel): fc1 accumulates in f32 and is rounded to the compute
    dtype; the depthwise conv zero-pads the hidden map and sums in f32; GELU
    in f32 by the dtype rule, rounded; fc2 in f32, rounded."""
    cdt, f32 = x.dtype, torch.float32
    hidden = (x.to(f32) @ w1.to(f32).t() + b1.to(f32)).to(cdt)
    z = F.conv2d(
        hidden.to(f32).permute(0, 3, 1, 2), dwk.to(f32), padding=1, groups=w1.shape[0]
    ).permute(0, 2, 3, 1) + dwb.to(f32)
    g = gelu_f32(z, cdt).to(cdt)
    return (g.to(f32) @ w2.to(f32).t() + b2.to(f32)).to(cdt)


def check_kernel_args(x, w1, b1, dwk, dwb, w2, b2) -> None:
    """Raise ValueError unless the kernel takes these tensors: one dtype
    (float32 or bfloat16), one device, contiguous, 32-byte aligned,
    x (B, H, W, C) with C % 32 == 0 and a hidden width of 4C."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"mixffn: dtype {x.dtype} not supported")
    for t in (x, w1, b1, dwk, dwb, w2, b2):
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                "mixffn: every tensor must share x's dtype and device "
                f"({x.dtype}, {x.device}); got {t.dtype}, {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("mixffn: tensors must be contiguous")
        if t.data_ptr() % 32:  # 16-byte vector loads, 32-byte MMA tiles
            raise ValueError("mixffn: tensors must be 32-byte aligned")
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(f"mixffn: x must be a non-empty (B, H, W, C) map, got {tuple(x.shape)}")
    c = x.shape[-1]
    if c % 32:
        raise ValueError(f"mixffn: needs C % 32 == 0, got C={c}")
    hid = 4 * c
    shapes = {
        "w1": (w1.shape, (hid, c)), "b1": (b1.shape, (hid,)),
        "dwk": (dwk.shape, (hid, 1, 3, 3)), "dwb": (dwb.shape, (hid,)),
        "w2": (w2.shape, (c, hid)), "b2": (b2.shape, (c,)),
    }
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"mixffn: {name} has shape {tuple(got)}, want {want}")


def _library():
    return library("mixffn", _SIGNATURES)


def load() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def mixffn(x, w1, b1, dwk, dwb, w2, b2):
    """MixFFN on a (B, H, W, C) map; returns (B, H, W, C). CUDA tensors run
    the kernel (or raise); CPU tensors run ``mixffn_reference``."""
    global LAUNCHES
    if x.device.type == "cpu":
        return mixffn_reference(x, w1, b1, dwk, dwb, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"mixffn: no kernel for device {x.device}")
    check_kernel_args(x, w1, b1, dwk, dwb, w2, b2)
    b, h, w, c = x.shape
    sms = sm_count(x.device)
    th, tw = choose_tile(b, h, w, c, x.dtype, sms)
    nsplit = 1
    if x.dtype == torch.bfloat16:
        nsplit = choose_split(b * -(-h // th) * -(-w // tw), 4 * c // HIDDEN_CHUNK, sms)
    lib = _library()
    out = torch.empty_like(x)
    partial = None
    if nsplit > 1:
        partial = torch.empty((nsplit, *x.shape), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pf_mixffn(
            _DTYPE_CODES[x.dtype],
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), dwk.data_ptr(), dwb.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            b, h, w, c, th, tw, nsplit, torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on_error(lib, err, "mixffn")
    LAUNCHES += 1
    return out
