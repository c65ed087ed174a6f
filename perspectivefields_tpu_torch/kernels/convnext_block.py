"""Fused ConvNeXt block: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/convnext_block.py``
(``convnext_block_fused``, whose ``pallas_call`` runs ``_block_kernel``;
oracle ``_xla_reference``). The CUDA source is ``csrc/convnext_block.cu``;
its header says what bounds the block on the H100 (the two products'
tensor-core work, with the per-element work and bytes close behind;
unfused, the activation and the 4x hidden map cross HBM about six times)
and what the design does about it (64-token tiles on wgmma, the hidden map
walked in chunks in registers, a TMA weight ring, the hidden dimension
split over a thread-block cluster where tiles alone leave SMs idle).

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
from . import hopper_plan as hp
from .build import library, raise_on_error
from .hopper_plan import CLUSTERS, MAX_STAGES, SMEM_LIMIT, STAGE_BYTES  # noqa: F401 (re-exported)

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

# csrc/convnext_block.cu's limits and shared-memory layout: the float32
# kernel's kMaxTokens and smem_f32; the bf16 kernel's 64-token tiles,
# 384-column passes, ring stages (hopper_gemm.cuh; hopper_plan.py) and
# CnxLayout
MAX_TOKENS = 64
TOKENS = 64
PASS_COLS = 384
CONSUMER_THREADS = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_convnext_block": (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p]
    ),
    "pf_convnext_block_smem": [ctypes.c_int] * 6,
    "pf_convnext_block_max_clusters": [ctypes.c_int] * 7,
    "pf_gemm_core": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def smem_f32(c: int, no: int) -> int:
    """Shared memory of one float32 block (csrc/convnext_block.cu: smem_f32)."""
    return 2 * _align128(no * c * 4) + _align128(no * 68 * 4) + _align128(32 * 33 * 4) + 256


def conv_rows(h: int, w: int) -> int:
    """Rows of x a bf16 block stages: the rows 64 tokens span and the halo."""
    return min(h, (TOKENS - 1) // w + 8)


def smem_bytes(c: int, h: int, w: int, cc: int, pc: int, stages: int) -> int:
    """Shared memory of one bf16 block (csrc/convnext_block.cu: CnxLayout):
    the ring, y (zero-padded to whole 128-column tiles), one room for the
    conv's staged rows and z chunk and then the pass's f32 partial output
    (``pc`` columns), the LayerNorm sums (the block's and the cluster's),
    the barriers, and 1024 bytes to align the base."""
    conv = _align128(conv_rows(h, w) * w * cc * 2) + TOKENS * cc * 4
    room = _align128(max(conv, TOKENS * pc * 4))
    return (stages * STAGE_BYTES + TOKENS * -(-c // 128) * 128 * 2 + room + 4 * TOKENS * 4
            + 16 * stages + 1024)


@functools.lru_cache(maxsize=None)
def choose_tokens(c: int, dtype: torch.dtype = torch.float32) -> int:
    """Tokens per float32 block: the most (of 64, 48, 32, 16) that fit
    shared memory. bfloat16 blocks always take 64 (``plan``)."""
    for no in (64, 48, 32, 16):
        if smem_f32(c, no) <= SMEM_LIMIT:
            return no
    raise ValueError(f"convnext_block: C={c} ({dtype}) does not fit shared memory")


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int, sms: int = 132, fits: tuple = ()) -> dict:
    """The bf16 launch for a (b, h, w, c) map: 64-token tiles inside each
    image; ``cluster`` blocks per tile split the hidden dimension and the
    conv's channels (the most of 8, 4, 2, 1 whose clusters all run on the
    card at once, at most one 64-channel chunk each, C / cluster a multiple
    of 8; ``fits`` holds (k, how many clusters of k the card runs
    together) pairs as ``clusters_fit`` reads them on the card, by default
    sms // k); ``cc`` channels per staged chunk of x's rows (a
    multiple of 8 that divides C / cluster, at most the consumers' 256
    threads, that leaves room for 3 ring stages, else 2: the one whose conv
    costs least, counting its sweeps (one when a single chunk holds the
    block's channels) over the threads it keeps busy), then as many ring
    stages as fit (at most 6). ``pc`` output columns per pass: all C up to
    384, else the width of 384, 256 or 128 with the fewest passes and
    columns computed that fits shared memory. Also the L2 weight bytes a
    call: each block reads its chunks of W1 once per pass and its chunks
    of W2 once."""
    tiles = b * -(-h * w // TOKENS)
    chunks = 4 * c // 64
    fit = hp.fit_counts(fits, sms)
    cluster = next(s for s in CLUSTERS
                   if s == 1 or (tiles <= fit(s) and s <= chunks and c % (8 * s) == 0))
    # each block of the cluster convolves c / cluster channels; the conv's
    # cost is its sweeps (one when a single chunk holds them) over the
    # threads it keeps busy (G = 256 // cc tokens at a time per channel)
    cb = c // cluster
    options = sorted((cc for cc in range(min(cb, CONSUMER_THREADS), 7, -8) if cb % cc == 0),
                     key=lambda cc: ((1 if cc == cb else 2) * cb / (CONSUMER_THREADS // cc * cc), -cc))
    widths = [c] if c <= PASS_COLS else sorted((PASS_COLS, 256, 128),
                                                key=lambda pc: (-(-c // pc), -(-c // pc) * pc))
    for pc in widths:
        for min_stages in (3, 2):
            for cc in options:
                if smem_bytes(c, h, w, cc, pc, min_stages) > SMEM_LIMIT:
                    continue
                stages = hp.ring_stages(lambda s: smem_bytes(c, h, w, cc, pc, s), min_stages)
                passes = -(-c // pc)
                weight_bytes = tiles * (passes * 4 * c * c + 4 * c * c) * 2
                return dict(tokens=TOKENS, cluster=cluster, cc=cc, pc=pc, stages=stages,
                            passes=passes, blocks=tiles * cluster,
                            smem=smem_bytes(c, h, w, cc, pc, stages), weight_bytes=weight_bytes)
    raise ValueError(f"convnext_block: a {h}x{w}x{c} map is too wide for the kernel's shared memory")


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


def kernel_smem_bytes(c: int, h: int, w: int, cc: int, pc: int, stages: int) -> int:
    """The kernel's own count of one bf16 block's shared memory (needs
    nvcc); ``smem_bytes`` must equal it."""
    return _library().pf_convnext_block_smem(c, h, w, cc, pc, stages)


@functools.lru_cache(maxsize=None)
def clusters_fit(c: int, h: int, w: int, cc: int, pc: int, stages: int, cluster: int) -> int:
    """How many clusters of ``cluster`` bf16 blocks the card runs at once
    (cudaOccupancyMaxActiveClusters; needs the card)."""
    return _library().pf_convnext_block_max_clusters(c, h, w, cc, pc, stages, cluster)


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, h: int, w: int, c: int, device: torch.device) -> dict:
    """The bf16 plan the wrapper launches on ``device``: ``plan`` with the
    card's own count of the clusters it runs at once (needs the card)."""
    return hp.launch_plan(lambda sms, fits: plan(b, h, w, c, sms, fits),
                          lambda p, k: clusters_fit(c, h, w, p["cc"], p["pc"], p["stages"], k),
                          device)


def gemm_core(a: torch.Tensor, w: torch.Tensor, mode: int = 0, lib=None) -> torch.Tensor:
    """The Hopper GEMM core alone (csrc/hopper_gemm.cuh: gemm_core), for the
    GPU tests: (M, N) f32 = a (M, K) . w (N, K)^T, bf16 CUDA tensors, K a
    multiple of 32. mode 0 takes A from shared memory, mode 1 from
    registers. ``lib`` is a loaded kernel library (default this module's;
    every library that includes the core exports it)."""
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or a.device.type != "cuda":
        raise ValueError("gemm_core: needs bf16 CUDA tensors")
    a, w = a.contiguous(), w.contiguous()
    lib = lib or _library()
    out = torch.empty((a.shape[0], w.shape[0]), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.pf_gemm_core(a.data_ptr(), w.data_ptr(), out.data_ptr(), a.shape[0], w.shape[0],
                               a.shape[1], mode, torch.cuda.current_stream(a.device).cuda_stream)
    raise_on_error(lib, err, "gemm_core")
    return out


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
    no, cc, pc, cluster, stages = TOKENS, 0, 0, 1, 0
    if x.dtype == torch.float32:
        no = choose_tokens(c, x.dtype)
    else:
        p = launch_plan(b, h, w, c, x.device)
        cc, pc, cluster, stages = p["cc"], p["pc"], p["cluster"], p["stages"]
    lib = _library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pf_convnext_block(
            _DTYPE_CODES[x.dtype], *[t.data_ptr() for t in args], out.data_ptr(),
            b, h, w, c, no, cc, pc, cluster, stages, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on_error(lib, err, "convnext_block")
    LAUNCHES += 1
    return out
