"""Fused MixFFN: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/mixffn.py``
(``mixffn_fused``, whose ``pallas_call`` runs ``_ffn_kernel``). The CUDA
source is ``csrc/mixffn.cu``; its header says what bounds the FFN on the
H100 and what the design does about it (a block walks the hidden dimension
in chunks, so the hidden map never leaves the chip; at bf16 fc1 and fc2 run
on wgmma, the weights come through a TMA ring shared by a thread-block
cluster, and the taps overlap the tensor cores).

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
from . import hopper_plan as hp
from .build import check_inference_only, library, raise_on_error
from .hopper_plan import CLUSTERS, MAX_STAGES, SMEM_LIMIT, STAGE_BYTES  # noqa: F401 (re-exported)
from .hopper_plan import sm_count

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

# csrc/mixffn.cu's limits and shared-memory layouts: the float32 kernel's
# (kHC, kMaxHalo) and the bf16 kernel's (FfnLayout; the ring of
# hopper_gemm.cuh, planned as hopper_plan.py says)
HIDDEN_CHUNK = 64
MAX_HALO = 128
OUT_ROWS_BF16 = 64  # outputs a bf16 block owns at most: fc2's wgmma M
MAX_WIDTH_BF16 = 1280  # the bf16 kernel's widest C (kMaxCB): x's 64 halo rows fit shared memory
MAX_TILES_PASS = 5  # W2 tiles of 128 columns a pass keeps in registers (kMaxNT)
MAX_TILES_TWO_GROUPS = 3  # a halo of two row groups only up to 3 tiles a pass (kMaxNT2)
# the bf16 planner's thread-instructions of the taps and GELU per hidden element
TAP_INSTR = 45

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_mixffn": [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    "pf_mixffn_smem": [ctypes.c_int] * 5,
    "pf_mixffn_max_clusters": [ctypes.c_int] * 5,
}


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def _align1024(n: int) -> int:
    return -(-n // 1024) * 1024


def halo_groups(th: int, tw: int) -> int:
    """m64 row groups of a bf16 block's halo: 1 (<= 64 tokens) or 2."""
    return 2 if (th + 2) * (tw + 2) > 64 else 1


def smem_bytes(dtype: torch.dtype, c: int, th: int, tw: int, stages: int = MAX_STAGES) -> int:
    """Shared memory of one block. float32 (csrc/mixffn.cu: smem_f32): x,
    the hidden chunk, g and the output for the halo'd tile, a staged weight
    tile, biases and tables. bfloat16 (FfnLayout): the ring of ``stages``
    16 KB stages, x's halo rows (one or two groups of 64, zero-padded to
    whole 128-column tiles), the bf16 hidden chunk, two 64 x 64 g buffers,
    the tables, the barriers, and 1024 bytes to align the base."""
    if dtype == torch.bfloat16:
        hr = halo_groups(th, tw)
        return (stages * STAGE_BYTES + hr * 64 * -(-c // 128) * 128 * 2
                + _align1024(hr * 64 * (HIDDEN_CHUNK + 8) * 2) + 2 * 64 * HIDDEN_CHUNK * 2
                + (2 * 64 + 64) * 4 + 16 * stages + 1024)
    nhp, nop = _ceil16((th + 2) * (tw + 2)), _ceil16(th * tw)
    hf_ld = HIDDEN_CHUNK + 4
    small = 2 * 256 + 2 * MAX_HALO * 4  # biases, index tables
    return (_align128(nhp * c * 4) + _align128(nhp * hf_ld * 4) + _align128(nop * hf_ld * 4)
            + _align128(nop * c * 4) + _align128(32 * 33 * 4) + small)


def _chunk_cycles(th: int, tw: int, c: int) -> float:
    """Rough cycles of one 64-channel hidden chunk of one block, from
    per-phase clock counts of this kernel's WMMA version on an H100 (the
    float32 tiling's yardstick, kept for it and for kernels/fused_block.py): fc1
    ~200 cycles per 16x16 tile-step of the busiest warp (16 warps: 4 column
    tiles x 4 row groups), fc2 ~230 per tile-step, ~44 per halo or output
    row for the mask, taps and GELU, ~2000 for staging and barriers."""
    nhalo, no = (th + 2) * (tw + 2), th * tw
    fc1 = -(-_ceil16(nhalo) // 64) * (c // 16) * 200
    fc2 = -(-(_ceil16(no) // 16) * (c // 16) // 16) * 4 * 230
    return fc1 + fc2 + (nhalo + no) * 44 + 2000


@functools.lru_cache(maxsize=None)
def choose_tile(
    b: int, h: int, w: int, c: int, dtype: torch.dtype, sms: int = 132
) -> tuple[int, int]:
    """The output tile (TH, TW) a block owns for a (b, h, w, c) map. float32:
    among the tiles the kernel takes (halo <= 128 tokens, shared memory),
    the one whose launch takes the fewest cycles by ``_chunk_cycles``,
    counting the waves of blocks on ``sms`` SMs. bfloat16 tiles come from
    ``plan``."""
    if dtype == torch.bfloat16:
        return plan(b, h, w, c, sms)["tile"]
    best = None
    for th in range(1, h + 1):
        for tw in range(1, w + 1):
            if _ceil16((th + 2) * (tw + 2)) > MAX_HALO:
                break
            if smem_bytes(dtype, c, th, tw) > SMEM_LIMIT:
                continue
            blocks = b * -(-h // th) * -(-w // tw)
            cost = -(-blocks // sms) * (4 * c // HIDDEN_CHUNK) * _chunk_cycles(th, tw, c)
            if best is None or cost < best[0]:
                best = (cost, th, tw)
    if best is None:
        raise ValueError(f"mixffn: no tile fits C={c} ({dtype}) in shared memory")
    return best[1], best[2]


def w2_passes(c: int) -> tuple[int, int]:
    """(passes, W2 tiles a pass) of the bf16 kernel at width C: fc2's
    accumulators for at most ``MAX_TILES_PASS`` 128-column tiles stay in
    registers, so a wider C walks the hidden chunks once per pass, each
    pass over an even share of the tiles."""
    nt = -(-c // 128)
    passes = -(-nt // MAX_TILES_PASS)
    return passes, -(-nt // passes)


def split_fits(c: int, th: int, tw: int, stages: int) -> bool:
    """Whether a split's f32 partial output (64 x C, padded to whole
    128-column tiles) fits over the ring, x, the hidden chunk and g
    (csrc/mixffn.cu: FfnLayout.tables); a split takes one pass only."""
    hr = halo_groups(th, tw)
    before_tables = (stages * STAGE_BYTES + hr * 64 * -(-c // 128) * 128 * 2
                     + _align1024(hr * 64 * (HIDDEN_CHUNK + 8) * 2) + 2 * 64 * HIDDEN_CHUNK * 2)
    return w2_passes(c)[0] == 1 and OUT_ROWS_BF16 * -(-c // 128) * 128 * 4 <= before_tables


def ring_stages(c: int, th: int, tw: int) -> int:
    """As many 16 KB ring stages as fit (2 to 6)."""
    return hp.ring_stages(lambda s: smem_bytes(torch.bfloat16, c, th, tw, s))


def block_cycles(th: int, tw: int, c: int, chunks: int, split: int) -> float:
    """The bf16 planner's cycles of one block walking ``chunks`` hidden
    chunks of a (th, tw) tile in each of ``w2_passes`` passes: per chunk the
    larger of its tensor-core work (fc1 on whole m64 row groups of the
    halo, fc2 on 64 rows and the pass's 128-column W2 tiles) and its
    CUDA-core work (taps and GELU on the outputs, the mask on the halo
    rows), since the two overlap; plus the prologue and, at a split, the
    exchange of each output tile."""
    hr, nt, cp = halo_groups(th, tw), -(-c // 128), -(-c // 128) * 128
    passes, ntp = w2_passes(c)
    tc = (hr * 64 * HIDDEN_CHUNK * cp + 64 * ntp * 128 * HIDDEN_CHUNK) * 2 / hp.TC_FLOP_PER_CYCLE
    cuda = (th * tw * HIDDEN_CHUNK * TAP_INSTR + hr * 64 * HIDDEN_CHUNK * 4) / 128
    return passes * chunks * (max(tc, cuda) + 300) + 3000 + (split > 1) * nt * 2500


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, c: int, sms: int = 132, fits: tuple = ()) -> dict:
    """The bf16 launch for a (b, h, w, c) map, chosen by counting. Each
    candidate tile (<= 64 outputs, a halo of <= 128 tokens, <= 64 where a
    pass has more than 3 W2 tiles, shared memory for 2 ring stages) and
    cluster is costed as waves x ``block_cycles``: a cluster either
    multicasts the weights over k neighbouring tiles
    (``hopper_plan.multicast_cluster``; ``split`` 0) or splits each tile's
    hidden chunks over S blocks (``split`` 1, S <= the chunks), whose partial
    outputs meet in distributed shared memory (over the ring and x:
    ``split_fits``). ``fits``: (k, clusters of k the card runs at once)
    pairs, as ``clusters_fit`` reads them on the card; by default sms // k.
    The ring takes as many 16 KB stages as fit (2 to 6). ``passes``: the
    hidden walks over W2's column tiles (``w2_passes``). ``weight_bytes``
    counts the L2 weight reads a call: W1 once a pass and W2 once, per
    multicast cluster or per tile at a split."""
    if c % 32 or not 32 <= c <= MAX_WIDTH_BF16:
        raise ValueError(f"mixffn: bf16 needs C % 32 == 0 and C <= {MAX_WIDTH_BF16}, got C={c}")
    fit = hp.fit_counts(fits, sms)
    nch = 4 * c // HIDDEN_CHUNK
    passes, ntp = w2_passes(c)
    best = None
    for th in range(1, min(h, OUT_ROWS_BF16) + 1):
        for tw in range(1, min(w, OUT_ROWS_BF16 // th) + 1):
            halo = (th + 2) * (tw + 2)
            if halo > 128 or (halo > 64 and ntp > MAX_TILES_TWO_GROUPS):
                continue
            if smem_bytes(torch.bfloat16, c, th, tw, 2) > SMEM_LIMIT:
                continue
            tiles = b * -(-h // th) * -(-w // tw)
            options = []
            for s in (1, 2, 4, 8):
                if s > nch or not fit(s) or (s > 1 and not split_fits(c, th, tw, ring_stages(c, th, tw))):
                    continue
                waves = -(-tiles // fit(s)) if s > 1 else -(-tiles // sms)
                options.append((waves * block_cycles(th, tw, c, -(-nch // s), s), s))
            cost, split = min(options)
            key = (cost, tiles, -th * tw)
            if best is None or key < best[0]:
                best = (key, th, tw, tiles, split)
    _, th, tw, tiles, split = best
    if split > 1:
        cluster, grid, copies = split, tiles * split, tiles
    else:
        cluster = hp.multicast_cluster(tiles, fit)
        grid = -(-tiles // cluster) * cluster
        copies = grid // cluster
    stages = ring_stages(c, th, tw)
    return dict(tile=(th, tw), halo_groups=halo_groups(th, tw), cluster=cluster,
                split=int(split > 1), stages=stages, passes=passes, blocks=grid,
                smem=smem_bytes(torch.bfloat16, c, th, tw, stages),
                weight_bytes=copies * (passes + 1) * 4 * c * c * 2)


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
    x (B, H, W, C) with C % 32 == 0 (C <= 1280 in bf16) and a hidden width
    of 4C."""
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
    if x.dtype == torch.bfloat16 and c > MAX_WIDTH_BF16:
        raise ValueError(f"mixffn: the bf16 kernel takes C <= {MAX_WIDTH_BF16}, got C={c}")
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


def kernel_smem_bytes(dtype: torch.dtype, c: int, th: int, tw: int, stages: int = MAX_STAGES) -> int:
    """The kernel's own count of one block's shared memory (needs nvcc);
    ``smem_bytes`` must equal it."""
    return _library().pf_mixffn_smem(_DTYPE_CODES[dtype], c, th, tw, stages)


@functools.lru_cache(maxsize=None)
def clusters_fit(c: int, th: int, tw: int, stages: int, cluster: int) -> int:
    """How many clusters of ``cluster`` bf16 blocks the card runs at once
    (cudaOccupancyMaxActiveClusters; needs the card)."""
    return _library().pf_mixffn_max_clusters(c, th, tw, stages, cluster)


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, h: int, w: int, c: int, device: torch.device) -> dict:
    """The bf16 plan the wrapper launches on ``device``: ``plan`` with the
    card's own count of the clusters it runs at once (needs the card)."""
    return hp.launch_plan(lambda sms, fits: plan(b, h, w, c, sms, fits),
                          lambda p, k: clusters_fit(c, *p["tile"], p["stages"], k), device)


def launch(x, w1, b1, dwk, dwb, w2, b2, th: int, tw: int, cluster: int = 1, split: int = 0,
           stages: int = 0, lib=None):
    """One launch of the kernel with a given tile and, at bf16, cluster,
    split and ring depth (``plan``'s keys); checked tensors on the card.
    ``mixffn`` launches the plan; the GPU tests launch others. ``lib``: a
    build of the source other than the wrapper's own (chip_smoke.py
    --phases passes the one with the phase stamps)."""
    b, h, w, c = x.shape
    lib = _library() if lib is None else lib
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.pf_mixffn(
            _DTYPE_CODES[x.dtype],
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), dwk.data_ptr(), dwb.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            b, h, w, c, th, tw, cluster, split, stages,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    raise_on_error(lib, err, "mixffn")
    return out


def mixffn(x, w1, b1, dwk, dwb, w2, b2):
    """MixFFN on a (B, H, W, C) map; returns (B, H, W, C). CUDA tensors run
    the kernel (or raise); CPU tensors run ``mixffn_reference``."""
    global LAUNCHES
    if x.device.type == "cpu":
        return mixffn_reference(x, w1, b1, dwk, dwb, w2, b2)
    check_inference_only("mixffn", x, w1, b1, dwk, dwb, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"mixffn: no kernel for device {x.device}")
    check_kernel_args(x, w1, b1, dwk, dwb, w2, b2)
    b, h, w, c = x.shape
    if x.dtype == torch.float32:
        out = launch(x, w1, b1, dwk, dwb, w2, b2, *choose_tile(b, h, w, c, x.dtype, sm_count(x.device)))
    else:
        p = launch_plan(b, h, w, c, x.device)
        out = launch(x, w1, b1, dwk, dwb, w2, b2, *p["tile"], p["cluster"], p["split"], p["stages"])
    LAUNCHES += 1
    return out
