"""Stage-1 SR-attention sub-block (one head, C = 64): hand-written CUDA
kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/stage1_attention.py``
(``stage1_attention``, whose ``pallas_call`` runs ``_kernel``). It computes
the function of ``fused_attention`` with one head, for C = 64 and M <= 128
keys at any token count: MiT stage 1 (N = 6400, M = 100 at 320^2). The CUDA
source is ``csrc/stage1_attention.cu``; its header says what bounds the
sub-block on the H100 (bytes and latency) and what the design does about it
(a block stages Wq, Wp, K and V once and walks several query tiles). The
TPU kernel's lane packing of token pairs is not ported: it fills a TPU
register, which Hopper has no need of.

``stage1_attention`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; only CPU tensors go to
``stage1_attention_reference``, the same function in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from .build import library, raise_on_error
from .fused_attention import ATTN_TOKEN_GATE, MAX_KEYS, check_kernel_args as _check_attention_args
from .fused_attention import fused_attention_reference

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

CHANNELS = 64

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_stage1_attention": (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]
    ),
}


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


def stage1_attention(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, scale: float, residual=None):
    """One-head attention sub-block on (B, N, 64) tokens; returns (B, N, 64),
    with ``residual`` added when given. CUDA tensors run the kernel (or
    raise); CPU tensors run ``stage1_attention_reference``."""
    global LAUNCHES
    if x.device.type == "cpu":
        return stage1_attention_reference(
            x, kv_in, wq, bq, wkv, bkv, wproj, bproj, scale, residual
        )
    if x.device.type != "cuda":
        raise ValueError(f"stage1_attention: no kernel for device {x.device}")
    check_kernel_args(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, residual)
    lib = _library()
    b, n, c = x.shape
    m = kv_in.shape[1]
    kv = torch.empty((b, m, 2 * c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pf_stage1_attention(
            _DTYPE_CODES[x.dtype],
            x.data_ptr(), kv_in.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            wkv.data_ptr(), bkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            None if residual is None else residual.data_ptr(),
            kv.data_ptr(), out.data_ptr(), b, n, m, float(scale),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on_error(lib, err, "stage1_attention")
    LAUNCHES += 1
    return out
