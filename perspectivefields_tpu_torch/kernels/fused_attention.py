"""Fused SR-attention sub-block: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/fused_attention.py``
(``_fused_attention``, whose ``pallas_call`` runs ``_kernel``/``_attn_core``).
The CUDA source is ``csrc/fused_attention.cu``; its header says what bounds
the sub-block on the H100 (latency and bytes: the per-head GEMMs are tiny)
and what the design does about it (logits never reach HBM; the q and out
projections are fused with the attention).

    q = x.Wq^T + bq;  [k|v] = kv_in.Wkv^T + bkv
    per head: p = softmax_f32(q_h.k_h^T * scale) in the compute dtype; o_h = p.v_h
    out = concat_h(o_h).Wp^T + bp   (+ residual)

Weights use the nn.Linear layout (out, in); tokens are (B, N, C) / (B, M, C).
``fused_attention`` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; only CPU tensors go to
``fused_attention_reference``, the same function in plain torch.
"""

from __future__ import annotations

import ctypes

import torch

from .build import library, raise_on_error

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

HEAD_DIM = 64
MAX_KEYS = 128
# Largest token count routed to the kernel. Kept from the JAX package
# (perspectivefields_tpu/models/mit.py ATTN_TOKEN_GATE), where it was chosen
# on a TPU; it still has to be measured on the H100.
ATTN_TOKEN_GATE = 2048

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_fused_attention": (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]
    ),
}


def use_kernel(
    use_kernels: bool,
    qkv_bias: bool,
    n_tokens: int,
    head_dim: int,
    n_keys: int,
    device: torch.device,
) -> bool:
    """The gate of SRAttention's kernel path (mirrors the JAX gate at
    perspectivefields_tpu/models/mit.py:324-330, plus the kernel's own
    limits and a CUDA device)."""
    return (
        use_kernels
        and qkv_bias
        and n_tokens <= ATTN_TOKEN_GATE
        and head_dim == HEAD_DIM
        and n_keys <= MAX_KEYS
        and torch.device(device).type == "cuda"
    )


def fused_attention_reference(
    x, kv_in, wq, bq, wkv, bkv, wproj, bproj, num_heads: int, scale: float,
    residual=None,
):
    """Plain-torch version of the kernel, with the kernel's casts: every
    product accumulates in f32 and is rounded once to the compute dtype;
    logits and softmax stay in f32 (JAX: _attn_core / _xla_reference)."""
    cdt, f32 = x.dtype, torch.float32
    b, n, c = x.shape
    m = kv_in.shape[1]
    dh = c // num_heads
    q = (x.to(f32) @ wq.to(f32).t() + bq.to(f32)).to(cdt)
    kv = (kv_in.to(f32) @ wkv.to(f32).t() + bkv.to(f32)).to(cdt)
    q = q.view(b, n, num_heads, dh).transpose(1, 2)
    k = kv[..., :c].reshape(b, m, num_heads, dh).transpose(1, 2)
    v = kv[..., c:].reshape(b, m, num_heads, dh).transpose(1, 2)
    logits = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1).to(cdt)
    o = (p.to(f32) @ v.to(f32)).to(cdt).transpose(1, 2).reshape(b, n, c)
    out = (o.to(f32) @ wproj.to(f32).t() + bproj.to(f32)).to(cdt)
    if residual is not None:
        out = (residual.to(f32) + out.to(f32)).to(cdt)
    return out


def check_kernel_args(
    x, kv_in, wq, bq, wkv, bkv, wproj, bproj, num_heads: int, residual=None
) -> None:
    """Raise ValueError unless the kernel takes these tensors: one dtype
    (float32 or bfloat16), one device, contiguous, head_dim 64, M <= 128."""
    tensors = [x, kv_in, wq, bq, wkv, bkv, wproj, bproj]
    if residual is not None:
        tensors.append(residual)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_attention: dtype {x.dtype} not supported")
    for t in tensors:
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                "fused_attention: every tensor must share x's dtype and device "
                f"({x.dtype}, {x.device}); got {t.dtype}, {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("fused_attention: tensors must be contiguous")
        if t.data_ptr() % 32:  # 16-byte vector loads, 32-byte MMA tiles
            raise ValueError("fused_attention: tensors must be 32-byte aligned")
    if x.dim() != 3 or kv_in.dim() != 3:
        raise ValueError("fused_attention: x and kv_in must be (B, N, C) / (B, M, C)")
    b, n, c = x.shape
    m = kv_in.shape[1]
    if num_heads <= 0 or c != num_heads * HEAD_DIM:
        raise ValueError(
            f"fused_attention: needs head_dim {HEAD_DIM}, got C={c} heads={num_heads}"
        )
    if not 1 <= m <= MAX_KEYS or n < 1:
        raise ValueError(f"fused_attention: needs 1 <= M <= {MAX_KEYS}, N >= 1; got M={m}, N={n}")
    shapes = {
        "kv_in": (kv_in.shape, (b, m, c)),
        "wq": (wq.shape, (c, c)),
        "bq": (bq.shape, (c,)),
        "wkv": (wkv.shape, (2 * c, c)),
        "bkv": (bkv.shape, (2 * c,)),
        "wproj": (wproj.shape, (c, c)),
        "bproj": (bproj.shape, (c,)),
    }
    if residual is not None:
        shapes["residual"] = (residual.shape, (b, n, c))
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"fused_attention: {name} has shape {tuple(got)}, want {want}")


def _library():
    return library("fused_attention", _SIGNATURES)


def load() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def fused_attention(
    x, kv_in, wq, bq, wkv, bkv, wproj, bproj, num_heads: int, scale: float,
    residual=None,
):
    """Attention sub-block on (B, N, C) tokens; returns (B, N, C), with
    ``residual`` added when given. CUDA tensors run the kernel (or raise);
    CPU tensors run ``fused_attention_reference``."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_attention_reference(
            x, kv_in, wq, bq, wkv, bkv, wproj, bproj, num_heads, scale, residual
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {x.device}")
    check_kernel_args(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, num_heads, residual)
    lib = _library()
    b, n, c = x.shape
    m = kv_in.shape[1]
    kv = torch.empty((b, m, 2 * c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pf_fused_attention(
            _DTYPE_CODES[x.dtype],
            x.data_ptr(), kv_in.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            wkv.data_ptr(), bkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            None if residual is None else residual.data_ptr(),
            kv.data_ptr(), out.data_ptr(),
            b, n, m, c, num_heads, float(scale),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on_error(lib, err, "fused_attention")
    LAUNCHES += 1
    return out
