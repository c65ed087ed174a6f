"""Fused SR-attention sub-block: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/fused_attention.py``
(``_fused_attention``, whose ``pallas_call`` runs ``_kernel``/``_attn_core``).
The CUDA source is ``csrc/fused_attention.cu``; its header says what bounds
the sub-block on the H100 and what the design does about it (logits never
reach HBM; the q and out projections are fused with the attention; at bf16
the products run on wgmma, the weights come through a TMA ring shared by a
thread-block cluster, and where row tiles are few a cluster splits the
heads).

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
import functools

import torch

from . import hopper_plan as hp
from .build import check_inference_only, library, raise_on_error
from .hopper_plan import CLUSTERS, MAX_STAGES, SMEM_LIMIT, STAGE_BYTES  # noqa: F401 (re-exported)

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

HEAD_DIM = 64
MAX_KEYS = 128
# Largest token count routed to the kernel. Kept from the JAX package
# (perspectivefields_tpu/models/mit.py ATTN_TOKEN_GATE), where it was chosen
# on a TPU; it still has to be measured on the H100.
ATTN_TOKEN_GATE = 2048

# csrc/fused_attention.cu's bf16 layout (kRowsQ, AttnLayout; the ring of
# hopper_gemm.cuh, planned as hopper_plan.py says)
ROWS_BF16 = 64  # query rows a bf16 block owns: wgmma's M
# the bf16 planner's CUDA-core cycles of one head's staging, softmax and
# exchanges
HEAD_CYCLES = 3000

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_fused_attention": (
        [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p]
    ),
    "pf_fused_attention_smem": [ctypes.c_int] * 3,
    "pf_fused_attention_max_clusters": [ctypes.c_int] * 4,
}


def smem_bytes(c: int, hs: int, stages: int = MAX_STAGES) -> int:
    """Shared memory of one bf16 block whose share is ``hs`` heads
    (csrc/fused_attention.cu: AttnLayout): the ring of ``stages`` 16 KB
    stages, x (then o; 64 x C zero-padded to whole 128-column tiles), q of
    the share's heads, K_h (then p) and V_h^T, the softmax's exchange, the
    barriers, and 1024 bytes to align the base."""
    rows = ROWS_BF16
    return (stages * STAGE_BYTES + rows * -(-c // 128) * 128 * 2 + rows * hs * HEAD_DIM * 2
            + 2 * MAX_KEYS * HEAD_DIM * 2 + 4 * rows * 4 + 16 * stages + 1024)


def block_cycles(c: int, hs: int, split: int) -> float:
    """The bf16 planner's cycles of one block: per head of its share, the
    q projection (64 rows x 64 columns x C), logits and P.V on 128 padded
    keys, and ``HEAD_CYCLES`` of staging and softmax; the out projection of
    its share of the columns (whole 64-column tiles) over every head; at a
    split, the gather of o."""
    cp = -(-c // 128) * 128
    per_head = (64 * 64 * cp + 2 * 64 * MAX_KEYS * 64) * 2
    out = 64 * -(-c // (64 * split)) * 64 * c * 2
    return (hs * (per_head / hp.TC_FLOP_PER_CYCLE + HEAD_CYCLES) + out / hp.TC_FLOP_PER_CYCLE + 2000
            + (split > 1) * 3000)


@functools.lru_cache(maxsize=None)
def plan(b: int, n: int, c: int, heads: int, m: int = MAX_KEYS, sms: int = 132,
         fits: tuple = ()) -> dict:
    """The bf16 launch for (b, n, c) tokens, chosen by counting: 64-row tiles;
    a cluster either multicasts Wq and Wp over k neighbouring row tiles
    (``hopper_plan.multicast_cluster``; ``split`` 0) or splits each row
    tile's heads, and then its output columns, over S blocks (``split`` 1,
    S <= heads), whichever ``block_cycles`` x waves counts cheaper and fits
    shared memory. ``fits``: (k, clusters of k the card runs at once)
    pairs, as ``clusters_fit`` reads them; by default sms // k. The ring
    takes as many 16 KB stages as fit (2 to 6). ``weight_bytes`` counts the
    L2 weight reads a call: Wkv once per 64 rows of the K/V projection, Wq
    and Wp once per multicast cluster, or once per row tile at a split."""
    if c % HEAD_DIM or c != heads * HEAD_DIM:
        raise ValueError(f"fused_attention: needs C = heads * {HEAD_DIM}, got C={c} heads={heads}")
    fit = hp.fit_counts(fits, sms)
    tiles = b * -(-n // ROWS_BF16)
    options = []
    for s in (1, 2, 4, 8):
        hs = -(-heads // s)
        if s > heads or not fit(s) or smem_bytes(c, hs, 2) > SMEM_LIMIT:
            continue
        waves = -(-tiles // fit(s)) if s > 1 else -(-tiles // sms)
        options.append((waves * block_cycles(c, hs, s), s))
    if not options:
        raise ValueError(f"fused_attention: no bf16 block fits C={c} in shared memory")
    split = min(options)[1]
    hs = -(-heads // split)
    if split > 1:
        cluster, grid = split, tiles * split
    else:
        cluster = hp.multicast_cluster(tiles, fit)
        grid = -(-tiles // cluster) * cluster
    stages = hp.ring_stages(lambda s: smem_bytes(c, hs, s))
    qp = 2 * c * c * 2
    return dict(cluster=cluster, split=int(split > 1), heads_per_block=hs, stages=stages,
                blocks=grid, smem=smem_bytes(c, hs, stages),
                weight_bytes=(tiles if split > 1 else grid // cluster) * qp
                + -(-b * m // 64) * 2 * c * c * 2)


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


def kernel_smem_bytes(c: int, hs: int, stages: int = MAX_STAGES) -> int:
    """The kernel's own count of one bf16 block's shared memory (needs
    nvcc); ``smem_bytes`` must equal it."""
    return _library().pf_fused_attention_smem(c, hs, stages)


@functools.lru_cache(maxsize=None)
def clusters_fit(c: int, hs: int, stages: int, cluster: int) -> int:
    """How many clusters of ``cluster`` bf16 blocks the card runs at once
    (cudaOccupancyMaxActiveClusters; needs the card)."""
    return _library().pf_fused_attention_max_clusters(c, hs, stages, cluster)


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, n: int, c: int, heads: int, m: int, device: torch.device) -> dict:
    """The bf16 plan the wrapper launches on ``device``: ``plan`` with the
    card's own count of the clusters it runs at once (needs the card)."""
    return hp.launch_plan(lambda sms, fits: plan(b, n, c, heads, m, sms, fits),
                          lambda p, k: clusters_fit(c, -(-heads // k), p["stages"], k), device)


def launch(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, num_heads: int, scale: float,
           residual=None, cluster: int = 1, split: int = 0, stages: int = 0, lib=None):
    """One launch pair (K/V projection, attention) with a given bf16
    cluster, split and ring depth (``plan``'s keys; float32 ignores them);
    checked tensors on the card. ``fused_attention`` launches the plan; the
    GPU tests launch others. ``lib``: a build of the source other than the
    wrapper's own (chip_smoke.py --phases passes the one with the phase
    stamps)."""
    b, n, c = x.shape
    m = kv_in.shape[1]
    lib = _library() if lib is None else lib
    kv = torch.empty((b, m, 2 * c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pf_fused_attention(
            _DTYPE_CODES[x.dtype],
            x.data_ptr(), kv_in.data_ptr(), wq.data_ptr(), bq.data_ptr(),
            wkv.data_ptr(), bkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            None if residual is None else residual.data_ptr(),
            kv.data_ptr(), out.data_ptr(),
            b, n, m, c, num_heads, cluster, split, stages, float(scale),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on_error(lib, err, "fused_attention")
    return out


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
    check_inference_only("fused_attention", x, kv_in, wq, bq, wkv, bkv, wproj, bproj, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {x.device}")
    check_kernel_args(x, kv_in, wq, bq, wkv, bkv, wproj, bproj, num_heads, residual)
    args = (x, kv_in, wq, bq, wkv, bkv, wproj, bproj, num_heads, scale, residual)
    if x.dtype == torch.float32:
        out = launch(*args)
    else:
        b, n, c = x.shape
        p = launch_plan(b, n, c, num_heads, kv_in.shape[1], x.device)
        out = launch(*args, p["cluster"], p["split"], p["stages"])
    LAUNCHES += 1
    return out
