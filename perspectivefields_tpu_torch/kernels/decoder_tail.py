"""Fused decoder tail: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/decoder_tail.py``
(``decoder_tail``, whose ``pallas_call`` runs ``_tail_kernel``). The CUDA
source is ``csrc/decoder_tail.cu``; its header says what bounds the tail on
the H100 (conv0's tensor-core work; at Co = 180 the output's bytes) and what
the design does about it (a block owns an 8x8 coarse tile and keeps every
intermediate in shared memory).

    c0  = T(relu(conv3x3(concat(a, ll), w0) + b0))   zero padding on the concat
    u   = T(up2x(c0))                                bilinear, edge clamp
    c1  = T(relu(conv3x3(u, w1) + b1))               zero padding on u
    out = T(c1 . wp^T + bp)

Weights keep the torch layouts, so a head's own parameters go straight in:
w0 (64, Ca+Cl, 3, 3), w1 (32, 64, 3, 3), wp (Co, 32, 1, 1) or (Co, 32).
``decoder_tail`` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; only CPU tensors go to ``decoder_tail_reference``,
the same function in plain torch. Unlike the TPU kernel it needs no row
tiling of H: ragged tiles are masked, and any H, W >= 1 is taken.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..ops.image import resize_bilinear
from .build import library, raise_on_error

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

# csrc/decoder_tail.cu's limits: the conv widths it is built for, the most
# prediction channels
C0, C1, MAX_CO = 64, 32, 192

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_decoder_tail": [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "pf_decoder_tail_workspace_bytes": [ctypes.c_int] * 3,
}


def _pred_matrix(wp: torch.Tensor) -> torch.Tensor:
    """The 1x1 prediction weight as (Co, C1)."""
    return wp.reshape(wp.shape[0], wp.shape[1])


def decoder_tail_reference(a, ll, w0, b0, w1, b1, wp, bp):
    """Plain-torch version of the kernel, with the kernel's casts (JAX:
    _tail_kernel; its oracle is xla_decoder_tail): concat, conv0 in f32 +
    bias + ReLU, rounded to the compute dtype; the 2x bilinear upsample in
    f32, rounded; conv1 in f32 + bias + ReLU, rounded; the 1x1 in f32 + bias,
    rounded. Channels-last in and out."""
    cdt, f32 = a.dtype, torch.float32

    def w(t):  # a weight as the kernel reads it: stored in the compute dtype
        return t.to(cdt).to(f32)

    x = torch.cat([a, ll.to(cdt)], dim=-1).to(f32).permute(0, 3, 1, 2)
    c0 = F.relu(F.conv2d(x, w(w0), w(b0), padding=1)).to(cdt).permute(0, 2, 3, 1)
    h, wd = c0.shape[1], c0.shape[2]
    u = resize_bilinear(c0.to(f32), 2 * h, 2 * wd).to(cdt)
    c1 = F.relu(F.conv2d(u.to(f32).permute(0, 3, 1, 2), w(w1), w(b1), padding=1)).to(cdt)
    y = c1.to(f32).permute(0, 2, 3, 1) @ w(_pred_matrix(wp)).t() + w(bp)
    return y.to(cdt)


def check_kernel_args(a, ll, w0, b0, w1, b1, wp, bp) -> None:
    """Raise ValueError unless the kernel takes these tensors: one dtype
    (float32 or bfloat16), one device, contiguous, a and ll 16-byte aligned
    (B, H, W, Ca) and (B, H, W, Cl) maps with Ca % 8 == Cl % 8 == 0, the
    heads' conv widths (64, 32) and 1 <= Co <= MAX_CO."""
    if a.dtype not in _DTYPE_CODES:
        raise ValueError(f"decoder_tail: dtype {a.dtype} not supported")
    tensors = {"a": a, "ll": ll, "w0": w0, "b0": b0, "w1": w1, "b1": b1, "wp": wp, "bp": bp}
    for name, t in tensors.items():
        if t.dtype != a.dtype or t.device != a.device:
            raise ValueError(
                "decoder_tail: every tensor must share a's dtype and device "
                f"({a.dtype}, {a.device}); {name} is {t.dtype}, {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"decoder_tail: {name} must be contiguous")
    for name in ("a", "ll"):
        if tensors[name].data_ptr() % 16:  # 16-byte cp.async copies
            raise ValueError(f"decoder_tail: {name} must be 16-byte aligned")
    if a.dim() != 4 or ll.dim() != 4 or min(a.shape) < 1 or a.shape[:3] != ll.shape[:3]:
        raise ValueError(
            "decoder_tail: a and ll must be non-empty (B, H, W, C) maps of one size, got "
            f"{tuple(a.shape)} and {tuple(ll.shape)}"
        )
    ca, cl = a.shape[-1], ll.shape[-1]
    if ca % 8 or cl % 8 or min(ca, cl) < 8:
        raise ValueError(f"decoder_tail: needs Ca % 8 == Cl % 8 == 0, got Ca={ca}, Cl={cl}")
    co = wp.shape[0]
    if not 1 <= co <= MAX_CO:
        raise ValueError(f"decoder_tail: needs 1 <= Co <= {MAX_CO}, got Co={co}")
    shapes = {
        "w0": (w0.shape, (C0, ca + cl, 3, 3)), "b0": (b0.shape, (C0,)),
        "w1": (w1.shape, (C1, C0, 3, 3)), "b1": (b1.shape, (C1,)),
        "wp": (wp.shape, (co, C1, 1, 1) if wp.dim() == 4 else (co, C1)), "bp": (bp.shape, (co,)),
    }
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"decoder_tail: {name} has shape {tuple(got)}, want {want}")


def _library():
    return library("decoder_tail", _SIGNATURES)


def load() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def decoder_tail(a, ll, w0, b0, w1, b1, wp, bp):
    """The fused tail of a (B, H, W, Ca) pyramid output and (B, H, W, Cl)
    low-level features; returns (B, 2H, 2W, Co) in a's dtype. CUDA tensors
    run the kernel (or raise); CPU tensors run ``decoder_tail_reference``."""
    global LAUNCHES
    if a.device.type == "cpu":
        return decoder_tail_reference(a, ll, w0, b0, w1, b1, wp, bp)
    if a.device.type != "cuda":
        raise ValueError(f"decoder_tail: no kernel for device {a.device}")
    check_kernel_args(a, ll, w0, b0, w1, b1, wp, bp)
    b, h, w, ca = a.shape
    cl, co = ll.shape[-1], wp.shape[0]
    code = _DTYPE_CODES[a.dtype]
    lib = _library()
    ws = torch.empty(lib.pf_decoder_tail_workspace_bytes(code, ca + cl, co), dtype=torch.uint8,
                     device=a.device)
    out = torch.empty((b, 2 * h, 2 * w, co), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.pf_decoder_tail(
            code, a.data_ptr(), ll.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(), ws.data_ptr(),
            b, h, w, ca, cl, co, torch.cuda.current_stream(a.device).cuda_stream,
        )
    raise_on_error(lib, err, "decoder_tail")
    LAUNCHES += 1
    return out
