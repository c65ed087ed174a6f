"""The whole MiT block after LN1: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/fused_block.py``
(``fused_block``, whose ``pallas_call`` runs ``_kernel``; oracle
``_xla_reference``). The CUDA source is ``csrc/fused_block.cu``; its header
says what bounds the block on the H100 and what the design does about it (a
block owns a token tile plus a 1-pixel halo and keeps the attention output,
x2, y and the 4C hidden map on chip; at bf16 its products run on wgmma and
the blocks of a thread-block cluster share each weight tile by TMA
multicast).

    a = attention(ln1x, kv_in)   (kernels/fused_attention.py's function)
    x2 = T(res + a);  y = T(LayerNorm(x2)) in f32
    out = T(x2 + mixffn(y))      (kernels/mixffn.py's function)

Weights keep the torch layouts: nn.Linear (out, in), the depthwise kernel
(4C, 1, 3, 3). ``fused_block`` launches the kernel for CUDA tensors and
raises on anything the kernel does not take; only CPU tensors go to
``fused_block_reference``, the same function in plain torch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import hopper_plan as hp
from .fused_attention import HEAD_DIM, MAX_KEYS, fused_attention_reference
from . import mixffn as mf
from .build import check_inference_only, library, raise_on_error
from .hopper_plan import CLUSTERS, MAX_STAGES, SMEM_LIMIT, STAGE_BYTES  # noqa: F401 (re-exported)

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

# csrc/fused_block.cu's limits and shared-memory layouts: the float32
# kernel's (kSub, Layout; halo up to 128 tokens) and the bf16 kernel's
# (kRows, BlockLayout; the ring of hopper_gemm.cuh)
SUB_ROWS = 32
MAX_HALO = mf.MAX_HALO
ROWS_BF16 = 64  # the bf16 kernel's halo tokens: wgmma's M
MAX_WIDTH_BF16 = 640  # the bf16 kernel's widest C (kMaxCB): two 64 x C operands fit

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_fused_block": (
        [ctypes.c_int] + [ctypes.c_void_p] * 19 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    ),
    "pf_fused_block_smem": [ctypes.c_int] * 5,
    "pf_fused_block_max_clusters": [ctypes.c_int] * 3,
    "pf_gemm_core": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def _tile_bytes(n, c, hdim, mpad, h, w, isz, bb):
    """JAX's scoped-VMEM estimate of one grid step (perspectivefields_tpu/
    kernels/fused_block.py:_tile_bytes)."""
    attn = n * (c * (5 * isz + 8) + mpad * (4 + isz))
    ffn = n * hdim * (4 + 4 + isz) + (h + 2) * (w + 2) * hdim * isz + n * c * 4
    weights = (4 * c * c + 2 * c * hdim) * isz
    return bb * (attn + ffn) + weights


def fused_block_viable(b, n, c, hdim, m, num_heads) -> bool:
    """JAX's gate (perspectivefields_tpu/kernels/fused_block.py:162-174),
    always evaluated at itemsize 2 (its bf16 answer) whatever the dtype, so
    the f32 path runs the blocks the bf16 path runs. The 13 MB threshold is
    the TPU's scoped VMEM; it was chosen on a TPU and is still to be
    measured on the H100, where the kernel tiles tokens and has no such
    limit (at 320^2 it admits stages 3-4 and refuses stages 1-2)."""
    if n > 2048 or c % num_heads or (c // num_heads) % 64:
        return False
    mpad = -(-m // 8) * 8
    side = int(round(n ** 0.5))
    return _tile_bytes(n, c, hdim, mpad, side, side, 2, 1) <= 13 * 2**20


def takes_width(c: int, dtype: torch.dtype) -> bool:
    """Whether the kernel runs a C-wide block in ``dtype``: every C =
    heads * 64 in float32; up to MAX_WIDTH_BF16 in bfloat16, which is all
    that ``fused_block_viable`` admits but C = 704 on maps of at most 31
    tokens."""
    return dtype != torch.bfloat16 or (c % 64 == 0 and 64 <= c <= MAX_WIDTH_BF16)


def fused_block_reference(
    ln1x, kv_in, res, wq, bq, wkv, bkv, wproj, bproj, ln2s, ln2b, w1, b1, dwk, dwb, w2, b2,
    num_heads: int, scale: float, h: int, w: int, eps: float = 1e-6,
):
    """Plain-torch version of the kernel, with the kernel's casts (JAX:
    _xla_reference): the attention sub-block's plain version, x2 in the
    compute dtype, LN2 in f32, the MixFFN's plain version, the second skip
    in the compute dtype. LN2 is F.layer_norm, whose moments the f32 kernel
    sums in the same order on the card (the bf16 kernel in two passes),
    where JAX's takes the fast variance
    E[x^2] - mu^2: with random weights that difference (~3e-6 at stage 4)
    grew past the 5e-4 field tolerance of the f32 path."""
    cdt, f32 = ln1x.dtype, torch.float32
    b, n, c = ln1x.shape
    a = fused_attention_reference(ln1x, kv_in, wq, bq, wkv, bkv, wproj, bproj, num_heads, scale)
    x2 = (res.to(f32) + a.to(f32)).to(cdt)
    y = F.layer_norm(x2.to(f32), (c,), ln2s.to(f32), ln2b.to(f32), eps).to(cdt)
    o = mf.mixffn_reference(y.reshape(b, h, w, c), w1, b1, dwk, dwb, w2, b2).reshape(b, n, c)
    return (x2.to(f32) + o.to(f32)).to(cdt)


_align128, _ceil16 = mf._align128, mf._ceil16


def smem_bytes(dtype: torch.dtype, c: int, th: int, tw: int, stages: int = MAX_STAGES) -> int:
    """Shared memory of one block. float32 (csrc/fused_block.cu: Layout): y
    for the halo tokens, x2 for the tile's tokens, the FFN's biases and
    tables, and one room for the attention phase, then the FFN phase.
    bfloat16 (BlockLayout, any tile): the ring of ``stages`` 16 KB stages,
    two 64 x C operands (the first zero-padded to whole 128-column tiles),
    K_h (then p) and V_h^T, the softmax's exchange, the tables, the
    barriers, and 1024 bytes to align the base."""
    if dtype == torch.bfloat16:
        rows, keys = ROWS_BF16, MAX_KEYS
        return (stages * STAGE_BYTES + rows * (-(-c // 128) * 128 + c) * 2 + 2 * keys * 64 * 2
                + 4 * rows * 4 + 2 * rows * 4 + 16 * stages + 1024)
    nhp, no = _ceil16((th + 2) * (tw + 2)), th * tw
    nop = _ceil16(no)
    hc, hf_ld, ws_ld, max_m = mf.HIDDEN_CHUNK, mf.HIDDEN_CHUNK + 4, 33, 128
    persistent = (_align128(nhp * c * 4) + _align128(no * c * 4) + 2 * _align128(hc * 4)
                  + 2 * MAX_HALO * 4)
    attn = 2 * _align128(SUB_ROWS * c * 4) + _align128(SUB_ROWS * max_m * 4) + _align128(32 * ws_ld * 4)
    ffn = (_align128(nhp * hf_ld * 4) + _align128(nop * hf_ld * 4) + _align128(nop * c * 4)
           + _align128(32 * ws_ld * 4))
    return persistent + max(attn, ffn)


def _block_cycles(th: int, tw: int, c: int, heads: int) -> float:
    """Rough cycles of one float32 block: the attention phase per 32 halo
    tokens (the q and out projections' 16x16 tile-steps, ~200 cycles each,
    and ~3000 per head for K/V staging, logits, softmax and P.V), then
    every hidden chunk as ``mixffn._chunk_cycles`` counts it."""
    subs = -(-_ceil16((th + 2) * (tw + 2)) // SUB_ROWS)
    proj = 2 * -(-(c // 16) // 16) * (c // 16) * 200
    return subs * (proj + heads * 3000) + (4 * c // mf.HIDDEN_CHUNK) * mf._chunk_cycles(th, tw, c)


@functools.lru_cache(maxsize=None)
def choose_tile(
    b: int, h: int, w: int, c: int, heads: int, dtype: torch.dtype = torch.float32, sms: int = 132
) -> tuple[int, int]:
    """The output tile (TH, TW) a float32 block owns for a (b, h, w, c) map:
    among the tiles the kernel takes (halo <= 128 tokens, shared memory),
    the one whose launch takes the fewest cycles by ``_block_cycles``,
    counting the waves of blocks on ``sms`` SMs. bfloat16 tiles come from
    ``plan``."""
    if dtype == torch.bfloat16:
        return plan(b, h, w, c, heads, sms)["tile"]
    best = None
    for th in range(1, h + 1):
        for tw in range(1, w + 1):
            if _ceil16((th + 2) * (tw + 2)) > MAX_HALO:
                break
            if smem_bytes(dtype, c, th, tw) > SMEM_LIMIT:
                continue
            blocks = b * -(-h // th) * -(-w // tw)
            cost = -(-blocks // sms) * _block_cycles(th, tw, c, heads)
            if best is None or cost < best[0]:
                best = (cost, th, tw)
    if best is None:
        raise ValueError(f"fused_block: no tile fits C={c} ({dtype}) in shared memory")
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int, heads: int, sms: int = 132, fits: tuple = ()) -> dict:
    """The bf16 launch for a (b, h, w, c) map. Every block walks all of the
    block's weights for its 64 halo rows, so a block's time hardly depends
    on its tile: the tile is the one (halo <= 64 tokens) with the fewest
    waves of blocks on ``sms`` SMs, then the fewest blocks, then the
    smallest. The cluster is the largest of 8, 4, 2, 1 that has at least 2
    blocks' worth of tiles and takes no more waves than single blocks would
    (``fits``: (k, how many clusters of k the card runs at once) pairs, as
    ``clusters_fit`` reads them on the card; by default sms // k). Its
    blocks share every weight tile, so L2 serves each tile once per
    cluster. The ring takes as many 16 KB stages as fit (2 to 6: a
    consumer releases a stage only once the next one has arrived). Also
    the L2 weight bytes a call: Wq, Wp, W1 and W2 once per cluster."""
    if not takes_width(c, torch.bfloat16):
        raise ValueError(f"fused_block: bf16 needs C = heads * 64 <= {MAX_WIDTH_BF16}, got C={c}")
    best = None
    for th in range(1, h + 1):
        for tw in range(1, w + 1):
            if (th + 2) * (tw + 2) > ROWS_BF16:
                break
            blocks = b * -(-h // th) * -(-w // tw)
            key = (-(-blocks // sms), blocks, th * tw)
            if best is None or key < best[0]:
                best = (key, th, tw, blocks)
    _, th, tw, tiles = best
    cluster = hp.multicast_cluster(tiles, hp.fit_counts(fits, sms))
    stages = hp.ring_stages(lambda s: smem_bytes(torch.bfloat16, c, th, tw, s))
    grid = -(-tiles // cluster) * cluster
    return dict(tile=(th, tw), cluster=cluster, stages=stages, blocks=grid,
                smem=smem_bytes(torch.bfloat16, c, th, tw, stages),
                weight_bytes=grid // cluster * 10 * c * c * 2)


def check_kernel_args(
    ln1x, kv_in, res, wq, bq, wkv, bkv, wproj, bproj, ln2s, ln2b, w1, b1, dwk, dwb, w2, b2,
    num_heads: int, h: int, w: int,
) -> None:
    """Raise ValueError unless the kernel takes these tensors: one dtype
    (float32 or bfloat16), one device, contiguous, 32-byte aligned, tokens
    (B, h*w, C) with C = heads * 64, 1 <= M <= 128 keys, hidden width 4C."""
    tensors = (ln1x, kv_in, res, wq, bq, wkv, bkv, wproj, bproj, ln2s, ln2b, w1, b1, dwk, dwb, w2, b2)
    if ln1x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_block: dtype {ln1x.dtype} not supported")
    for t in tensors:
        if t.dtype != ln1x.dtype or t.device != ln1x.device:
            raise ValueError(
                "fused_block: every tensor must share ln1x's dtype and device "
                f"({ln1x.dtype}, {ln1x.device}); got {t.dtype}, {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError("fused_block: tensors must be contiguous")
        if t.data_ptr() % 32:  # 16-byte vector loads, 32-byte MMA tiles
            raise ValueError("fused_block: tensors must be 32-byte aligned")
    if ln1x.dim() != 3 or kv_in.dim() != 3:
        raise ValueError("fused_block: ln1x and kv_in must be (B, N, C) / (B, M, C)")
    b, n, c = ln1x.shape
    m = kv_in.shape[1]
    if h < 1 or w < 1 or n != h * w:
        raise ValueError(f"fused_block: N={n} tokens is not the {h}x{w} grid")
    if num_heads <= 0 or c != num_heads * HEAD_DIM:
        raise ValueError(f"fused_block: needs head_dim {HEAD_DIM}, got C={c} heads={num_heads}")
    if not 1 <= m <= MAX_KEYS:
        raise ValueError(f"fused_block: needs 1 <= M <= {MAX_KEYS}, got M={m}")
    hid = 4 * c
    shapes = {
        "kv_in": (kv_in.shape, (b, m, c)), "res": (res.shape, (b, n, c)),
        "wq": (wq.shape, (c, c)), "bq": (bq.shape, (c,)),
        "wkv": (wkv.shape, (2 * c, c)), "bkv": (bkv.shape, (2 * c,)),
        "wproj": (wproj.shape, (c, c)), "bproj": (bproj.shape, (c,)),
        "ln2s": (ln2s.shape, (c,)), "ln2b": (ln2b.shape, (c,)),
        "w1": (w1.shape, (hid, c)), "b1": (b1.shape, (hid,)),
        "dwk": (dwk.shape, (hid, 1, 3, 3)), "dwb": (dwb.shape, (hid,)),
        "w2": (w2.shape, (c, hid)), "b2": (b2.shape, (c,)),
    }
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"fused_block: {name} has shape {tuple(got)}, want {want}")


def _library():
    return library("fused_block", _SIGNATURES)


def load() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def kernel_smem_bytes(dtype: torch.dtype, c: int, th: int, tw: int, stages: int = MAX_STAGES) -> int:
    """The kernel's own count of one block's shared memory (needs nvcc);
    ``smem_bytes`` must equal it."""
    return _library().pf_fused_block_smem(_DTYPE_CODES[dtype], c, th, tw, stages)


@functools.lru_cache(maxsize=None)
def clusters_fit(c: int, stages: int, cluster: int) -> int:
    """How many clusters of ``cluster`` bf16 blocks the card runs at once
    (cudaOccupancyMaxActiveClusters; needs the card)."""
    return _library().pf_fused_block_max_clusters(c, stages, cluster)


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, h: int, w: int, c: int, heads: int, device: torch.device) -> dict:
    """The bf16 plan the wrapper launches on ``device``: ``plan`` with the
    card's own count of the clusters it runs at once (needs the card)."""
    return hp.launch_plan(lambda sms, fits: plan(b, h, w, c, heads, sms, fits),
                          lambda p, k: clusters_fit(c, p["stages"], k), device)


def fused_block(
    ln1x, kv_in, res, wq, bq, wkv, bkv, wproj, bproj, ln2s, ln2b, w1, b1, dwk, dwb, w2, b2,
    num_heads: int, scale: float, h: int, w: int, eps: float = 1e-6,
):
    """One MiT block after LN1 on (B, h*w, C) tokens; returns (B, h*w, C),
    both skips applied. CUDA tensors run the kernel (or raise); CPU tensors
    run ``fused_block_reference``."""
    global LAUNCHES
    args = (ln1x, kv_in, res, wq, bq, wkv, bkv, wproj, bproj, ln2s, ln2b, w1, b1, dwk, dwb, w2, b2)
    if ln1x.device.type == "cpu":
        return fused_block_reference(*args, num_heads, scale, h, w, eps)
    check_inference_only("fused_block", *args)
    if ln1x.device.type != "cuda":
        raise ValueError(f"fused_block: no kernel for device {ln1x.device}")
    check_kernel_args(*args, num_heads, h, w)
    b, n, c = ln1x.shape
    m = kv_in.shape[1]
    sms = hp.sm_count(ln1x.device)
    cluster, stages = 1, 0
    if ln1x.dtype == torch.float32:
        th, tw = choose_tile(b, h, w, c, num_heads, ln1x.dtype, sms)
    else:
        p = launch_plan(b, h, w, c, num_heads, ln1x.device)
        (th, tw), cluster, stages = p["tile"], p["cluster"], p["stages"]
    lib = _library()
    kv = torch.empty((b, m, 2 * c), dtype=ln1x.dtype, device=ln1x.device)
    out = torch.empty_like(ln1x)
    with torch.cuda.device(ln1x.device):
        err = lib.pf_fused_block(
            _DTYPE_CODES[ln1x.dtype], *(t.data_ptr() for t in args), kv.data_ptr(),
            out.data_ptr(), b, h, w, m, c, num_heads, th, tw, cluster, stages, float(scale),
            float(eps), torch.cuda.current_stream(ln1x.device).cuda_stream,
        )
    raise_on_error(lib, err, "fused_block")
    LAUNCHES += 1
    return out
