"""Fused decoder tail: hand-written CUDA kernel + its plain version.

Replaces the TPU kernel ``perspectivefields_tpu/kernels/decoder_tail.py``
(``decoder_tail``, whose ``pallas_call`` runs ``_tail_kernel``). The CUDA
source is ``csrc/decoder_tail.cu``; its header says what bounds the tail on
the H100 (the tensor-core work of the two 3x3 convs; at Co = 180 the
output's bytes) and what the design does about it (persistent blocks walk
coarse tiles and keep every intermediate on chip; at bf16 the convs run on
wgmma, the input window and w0 arrive through a TMA ring that a cluster
shares, w1 and wp stay resident; ``plan`` picks the tile and cluster).

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
import functools

import torch
import torch.nn.functional as F

from ..ops.image import resize_bilinear
from . import hopper_plan as hp
from .build import check_inference_only, library, raise_on_error
from .hopper_plan import CLUSTERS, SMEM_LIMIT

# Launches of the CUDA kernel since the last reset (a plain counter: a run
# sets it to 0 and reads it back to show the main path went through here).
LAUNCHES = 0

# csrc/decoder_tail.cu's limits: the conv widths it is built for, the most
# prediction channels
C0, C1, MAX_CO = 64, 32, 192
# the bf16 kernel's tiles and layout (TailLayout): a coarse tile's halo
# (TH+2)(TW+2) fills at most one m64 group a consumer warpgroup, its fine
# outputs 4 TH TW at most six m64 groups of conv1; a ring stage holds w0's 9
# taps of one 32-channel k-block and that k-block of the input window
MAX_HALO, MAX_FINE = 128, 384
C0_LD = C0 + 8
W0_STAGE = 9 * C0 * 32 * 2
W1_BYTES = 9 * C1 * C0 * 2
MAX_SIDE = 96  # the upsample's table entries for fine-halo rows, and for columns
# the planner's cycles of the upsample per fine-halo pixel (8 threads of 8
# channels each) and the fixed cost of a tile (barriers, epilogues)
UP_CYCLES = 4
TILE_CYCLES = 3000

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "pf_decoder_tail": [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    "pf_decoder_tail_workspace_bytes": [ctypes.c_int] * 4,
    "pf_decoder_tail_smem": [ctypes.c_int] * 4,
    "pf_decoder_tail_max_clusters": [ctypes.c_int] * 5,
}


def _align(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(th: int, tw: int, co: int, stages: int = 2) -> int:
    """Shared memory of one bf16 block (csrc/decoder_tail.cu: TailLayout):
    ``stages`` ring stages (w0's 9 tap tiles of a k-block, then that k-block
    of the (TH+4) x (TW+4) window), w1 (9 x 32 x 64), wp (Co rounded up to
    64 rows x 32), the fine halo u ((2TH+2) x (2TW+2) x 64), the coarse halo
    c0 (MAX_HALO rows of C0_LD: conv0's GEMM rows), the f32 biases, the upsample's
    tables (16 bytes a fine-halo row or column), the barriers, and 1024
    bytes to align the base."""
    nw, nu = (th + 4) * (tw + 4), (2 * th + 2) * (2 * tw + 2)
    cop = _align(co, 64)
    stage = W0_STAGE + _align(nw * 64, 1024)
    return (stages * stage + W1_BYTES + cop * 64 + 2 * _align(nu * 64, 1024) + MAX_HALO * C0_LD * 2
            + (C0 + C1 + cop) * 4 + 2 * MAX_SIDE * 16 + (2 * stages + 1) * 8 + 1024)


def tile_cycles(th: int, tw: int, cin: int, co: int) -> float:
    """The bf16 planner's cycles of one tile: the tensor-core work at
    ``hopper_plan.TC_FLOP_PER_CYCLE`` (conv0 on the two warpgroups' 64 halo
    rows each, whatever the tile; conv1 and the 1x1 on whole m64 groups of
    its 4 TH TW fine outputs), the upsample on the CUDA cores, and a fixed
    cost."""
    kp = _align(cin, 32)
    groups = -(-4 * th * tw // 64)
    tc = (MAX_HALO * C0 * 9 * kp + groups * 64 * (C1 * 9 * C0 + _align(co, 64) * C1)) * 2
    return tc / hp.TC_FLOP_PER_CYCLE + UP_CYCLES * (2 * th + 2) * (2 * tw + 2) + TILE_CYCLES


def tiles_of(b: int, h: int, w: int, th: int, tw: int) -> int:
    return b * -(-h // th) * -(-w // tw)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, ca: int, cl: int, co: int, sms: int = 132,
         fits: tuple = ()) -> dict:
    """The bf16 launch for a (b, h, w) coarse map, chosen by counting. Each
    candidate tile (a halo of at most MAX_HALO pixels, at most MAX_FINE
    fine outputs, shared memory for 2 ring stages) is costed as the waves
    of persistent blocks (one per SM) times ``tile_cycles``; then the
    largest cluster of ``hopper_plan.CLUSTERS`` that multicasts w0 over that
    many neighbouring tiles without adding a wave (``fits``: (k, clusters of
    k the card runs at once) pairs, as ``clusters_fit`` reads them; by
    default sms // k). ``blocks`` is the persistent grid, ``iters`` the
    tiles each block walks. ``weight_bytes`` counts the L2 weight reads a
    call: w0 once per cluster and tile walked, w1 and wp once per block."""
    if not 1 <= co <= MAX_CO:
        raise ValueError(f"decoder_tail: needs 1 <= Co <= {MAX_CO}, got Co={co}")
    fit = hp.fit_counts(fits, sms)
    best = None
    for th in range(1, min(h, MAX_HALO) + 1):
        for tw in range(1, min(w, MAX_HALO) + 1):
            if (th + 2) * (tw + 2) > MAX_HALO or 4 * th * tw > MAX_FINE:
                break
            if smem_bytes(th, tw, co) > SMEM_LIMIT:
                continue
            tiles = tiles_of(b, h, w, th, tw)
            cost = -(-tiles // max(1, fit(1))) * tile_cycles(th, tw, ca + cl, co)
            key = (cost, tiles, -th * tw)
            if best is None or key < best[0]:
                best = (key, th, tw, tiles)
    if best is None:
        raise ValueError(f"decoder_tail: no bf16 tile fits Co={co} in shared memory")
    _, th, tw, tiles = best

    def grid(k):
        return min(fit(k), -(-tiles // k)) * k

    def iters(k):
        return -(-tiles // grid(k))

    cluster = next(k for k in CLUSTERS
                   if k == 1 or (tiles >= 2 * k and fit(k) and iters(k) <= iters(1)))
    stages = hp.ring_stages(lambda s: smem_bytes(th, tw, co, s))
    w0 = 9 * C0 * (ca + _align(cl, 32)) * 2
    return dict(tile=(th, tw), cluster=cluster, blocks=grid(cluster), iters=iters(cluster),
                stages=stages, smem=smem_bytes(th, tw, co, stages),
                weight_bytes=grid(cluster) // cluster * iters(cluster) * w0
                + grid(cluster) * (W1_BYTES + _align(co, 64) * C1 * 2))


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
    (B, H, W, Ca) and (B, H, W, Cl) maps with Ca % 8 == Cl % 8 == 0 (bf16:
    Ca % 32 == 0, so ll's channels start a k-block of the TMA window), the
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
    if a.dtype == torch.bfloat16 and ca % 32:
        raise ValueError(f"decoder_tail: bf16 needs Ca % 32 == 0, got Ca={ca}")
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


def kernel_smem_bytes(th: int, tw: int, co: int, stages: int = 2) -> int:
    """The kernel's own count of one bf16 block's shared memory (needs
    nvcc); ``smem_bytes`` must equal it."""
    return _library().pf_decoder_tail_smem(th, tw, co, stages)


@functools.lru_cache(maxsize=None)
def clusters_fit(th: int, tw: int, co: int, stages: int, cluster: int) -> int:
    """How many clusters of ``cluster`` bf16 blocks the card runs at once
    (cudaOccupancyMaxActiveClusters; needs the card)."""
    return _library().pf_decoder_tail_max_clusters(th, tw, co, stages, cluster)


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, h: int, w: int, ca: int, cl: int, co: int, device: torch.device) -> dict:
    """The bf16 plan the wrapper launches on ``device``: ``plan`` with the
    card's own count of the clusters it runs at once (needs the card)."""
    return hp.launch_plan(lambda sms, fits: plan(b, h, w, ca, cl, co, sms, fits),
                          lambda p, k: clusters_fit(*p["tile"], co, p["stages"], k), device)


def launch(a, ll, w0, b0, w1, b1, wp, bp, th: int = 8, tw: int = 10, cluster: int = 1,
           blocks: int = 1, stages: int = 2, lib=None):
    """One launch of the kernel on checked tensors on the card; at bf16 with
    a given tile, cluster, persistent grid and ring depth (``plan``'s keys;
    float32 ignores them). ``decoder_tail`` launches the plan; the GPU tests
    launch others. ``lib``: a build of the source other than the wrapper's
    own (chip_smoke.py --phases passes the one with the phase stamps)."""
    b, h, w, ca = a.shape
    cl, co = ll.shape[-1], wp.shape[0]
    code = _DTYPE_CODES[a.dtype]
    lib = _library() if lib is None else lib
    ws = torch.empty(lib.pf_decoder_tail_workspace_bytes(code, ca, cl, co), dtype=torch.uint8,
                     device=a.device)
    out = torch.empty((b, 2 * h, 2 * w, co), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.pf_decoder_tail(
            code, a.data_ptr(), ll.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(), ws.data_ptr(),
            b, h, w, ca, cl, co, th, tw, cluster, blocks, stages,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    raise_on_error(lib, err, "decoder_tail")
    return out


def decoder_tail(a, ll, w0, b0, w1, b1, wp, bp):
    """The fused tail of a (B, H, W, Ca) pyramid output and (B, H, W, Cl)
    low-level features; returns (B, 2H, 2W, Co) in a's dtype. CUDA tensors
    run the kernel (or raise); CPU tensors run ``decoder_tail_reference``."""
    global LAUNCHES
    if a.device.type == "cpu":
        return decoder_tail_reference(a, ll, w0, b0, w1, b1, wp, bp)
    check_inference_only("decoder_tail", a, ll, w0, b0, w1, b1, wp, bp)
    if a.device.type != "cuda":
        raise ValueError(f"decoder_tail: no kernel for device {a.device}")
    check_kernel_args(a, ll, w0, b0, w1, b1, wp, bp)
    if a.dtype == torch.bfloat16:
        b, h, w, ca = a.shape
        p = launch_plan(b, h, w, ca, ll.shape[-1], wp.shape[0], a.device)
        out = launch(a, ll, w0, b0, w1, b1, wp, bp, *p["tile"], p["cluster"], p["blocks"],
                     p["stages"])
    else:
        out = launch(a, ll, w0, b0, w1, b1, wp, bp)
    LAUNCHES += 1
    return out
