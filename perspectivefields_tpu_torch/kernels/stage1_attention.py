"""Stage-1 SR-attention sub-block (one head, C = 64): hand-written CUDA
kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/stage1_attention.py``
(``stage1_attention``, whose ``pallas_call`` runs ``_kernel``). It computes
the function of ``fused_attention`` with one head, for C = 64 and M <= 128
keys at any token count: MiT stage 1 (N = 6400, M = 100 at 320^2). The CUDA
source is ``csrc/stage1_attention.cu``; its header says what bounds the
sub-block on the H100 (bytes) and what the design does about it (one launch
of persistent blocks, each serving one image: K/V computed in the block, x
tiles by TMA ahead of two warpgroups that run every product on wgmma with
the softmax in registers). The TPU kernel's lane packing of token pairs is
not ported: it fills a TPU register, which Hopper has no need of.

``stage1_attention`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; only CPU tensors go to
``stage1_attention_reference``, the same function in plain torch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import check_inference_only, library, raise_on_error
from .hopper_plan import sm_count
from .fused_attention import ATTN_TOKEN_GATE, MAX_KEYS, check_kernel_args as _check_attention_args
from .fused_attention import fused_attention_reference

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

CHANNELS = 64
# csrc/stage1_attention.cu's bf16 layout (S1Layout): 64-row query tiles,
# two slots of x and the residual per consumer warpgroup
ROWS_BF16 = 64
TILE_BYTES = ROWS_BF16 * CHANNELS * 2
SLOTS = 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_stage1_attention": (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p]
    ),
    "pf_stage1_attention_smem": [],
}


def smem_bytes() -> int:
    """Shared memory of one bf16 block (csrc/stage1_attention.cu:
    S1Layout): Wq and Wp (64 x 64), Wkv and the image's kv_in (128 x 64),
    K and V^T (128 keys x 64), two slots of x and the residual (64 x 64
    each) per consumer warpgroup, the barriers, and 1024 bytes to align the
    base. It does not depend on the shapes."""
    return 2 * TILE_BYTES + 8 * TILE_BYTES + 2 * SLOTS * 2 * TILE_BYTES + (1 + 4 * SLOTS) * 8 + 1024


def unit_tiles(n: int, g: int) -> int:
    """The 64-row tiles each consumer warpgroup walks when an image of n
    tokens is served by g blocks (two warpgroups each)."""
    return -(-(-(-n // ROWS_BF16)) // (2 * g))


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, sms: int = 132) -> dict:
    """The bf16 launch for b images of n tokens, chosen by counting: a block
    (one per SM: ``smem_bytes``) serves one image; its two warpgroups each
    walk a run of ``tiles_per_group`` 64-row tiles, one after another. The
    fewest tiles a warpgroup at most walks with at most ``sms`` blocks in
    all, and then the fewest blocks per image (each computes its image's
    K/V once). ``weight_bytes`` counts the L2 reads of the weights and
    kv_in a call: each block reads Wq, Wp, Wkv (32 KB) and its image's
    kv_in (16 KB, 128 padded rows)."""
    per_image = -(-n // ROWS_BF16)
    most = max(1, min(per_image, sms // b))
    g = min(range(1, most + 1), key=lambda g: (unit_tiles(n, g), g))
    tiles = unit_tiles(n, g)
    return dict(blocks_per_image=g, tiles_per_group=tiles, blocks=b * g, smem=smem_bytes(),
                weight_bytes=b * g * (4 * TILE_BYTES + 2 * TILE_BYTES))


def use_kernel(
    use_kernels: bool,
    fuse_block: bool,
    qkv_bias: bool,
    n_tokens: int,
    channels: int,
    num_heads: int,
    n_keys: int,
    device: torch.device,
) -> bool:
    """The gate of SRAttention's stage-1 route: one head of 64 channels,
    at most 128 keys, more tokens than fused_attention's gate takes, a CUDA
    device, and both ``use_kernels`` and ``fuse_block`` on. JAX reaches its
    kernel only through a module switch (perspectivefields_tpu/models/
    mit.py:238-246); the port routes it with ``fuse_block``."""
    return (
        use_kernels
        and fuse_block
        and qkv_bias
        and num_heads == 1
        and channels == CHANNELS
        and n_keys <= MAX_KEYS
        and n_tokens > ATTN_TOKEN_GATE
        and torch.device(device).type == "cuda"
    )


def stage1_attention_reference(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, scale: float,
                               residual=None):
    """Plain-torch version of the kernel, with the kernel's casts: JAX's
    ``_xla_reference`` with one head (every product accumulates in f32 and
    is rounded once; logits and softmax in f32)."""
    return fused_attention_reference(
        x, kv_in, wq, bq, wkv, bkv, wproj, bproj, 1, scale, residual=residual
    )


def check_kernel_args(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, residual=None) -> None:
    """Raise ValueError unless the kernel takes these tensors: those of
    ``fused_attention.check_kernel_args`` with one head and C = 64."""
    if x.dim() != 3 or x.shape[-1] != CHANNELS:
        raise ValueError(f"stage1_attention: needs x (B, N, {CHANNELS}), got {tuple(x.shape)}")
    _check_attention_args(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, 1, residual)


def _library():
    return library("stage1_attention", _SIGNATURES)


def load() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def kernel_smem_bytes() -> int:
    """The kernel's own count of one bf16 block's shared memory (needs
    nvcc); ``smem_bytes`` must equal it."""
    return _library().pf_stage1_attention_smem()


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, n: int, device: torch.device) -> dict:
    """The bf16 plan the wrapper launches on ``device`` (its SM count)."""
    return plan(b, n, sm_count(device))


def launch(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, scale: float, residual=None, g: int = 1,
           lib=None):
    """One launch of the kernel on checked tensors on the card; at bf16 with
    ``g`` blocks per image (``plan``'s ``blocks_per_image``). The wrapper
    launches the plan; the GPU tests launch others. ``lib``: a build of the
    source other than the wrapper's own (chip_smoke.py --phases passes the
    one with the phase stamps)."""
    if x.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"stage1_attention: the bf16 kernel needs scale > 0, got {scale}")
    lib = _library() if lib is None else lib
    b, n, c = x.shape
    m = kv_in.shape[1]
    # float32 projects K/V into a scratch tensor first; bfloat16 in the block
    kv = torch.empty((b, m, 2 * c), dtype=x.dtype, device=x.device) if x.dtype == torch.float32 else None
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pf_stage1_attention(
            _DTYPE_CODES[x.dtype],
            x.data_ptr(), kv_in.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            wkv.data_ptr(), bkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if kv is None else kv.data_ptr(), out.data_ptr(), b, n, m, g, float(scale),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on_error(lib, err, "stage1_attention")
    return out


def stage1_attention(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, scale: float, residual=None):
    """One-head attention sub-block on (B, N, 64) tokens; returns (B, N, 64),
    with ``residual`` added when given. CUDA tensors run the kernel (or
    raise); CPU tensors run ``stage1_attention_reference``."""
    global LAUNCHES
    if x.device.type == "cpu":
        return stage1_attention_reference(
            x, kv_in, wq, bq, wkv, bkv, wproj, bproj, scale, residual
        )
    check_inference_only("stage1_attention", x, kv_in, wq, bq, wkv, bkv, wproj, bproj, residual)
    if x.device.type != "cuda":
        raise ValueError(f"stage1_attention: no kernel for device {x.device}")
    check_kernel_args(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, residual)
    g = 1
    if x.dtype == torch.bfloat16:
        g = launch_plan(x.shape[0], x.shape[1], x.device)["blocks_per_image"]
    out = launch(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, scale, residual, g)
    LAUNCHES += 1
    return out
