"""Drive the PyTorch port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each fails loudly; nothing is caught and turned into success):
  0. probe: the card (nvidia-smi name and power limit), torch, CUDA, nvcc;
  1. build the six CUDA kernels from perspectivefields_tpu_torch/csrc, one
     nvcc each, all started together; print ptxas's register/spill lines;
  2. each kernel vs its plain PyTorch version at the main path's shapes (B=8),
     f32 and bf16, plus ragged cases (batches of 1, 3 and 5, maps and row
     tiles the clusters do not divide, widths past MiT's, M = 1 and 128);
     device times of the kernel, its plain version and, where one exists,
     one PyTorch library call, each from CUDA events around 30 back-to-back
     calls (for every kernel but the whole block also replayed from a CUDA
     graph, without the host's launch cost; stage-1 attention at B=32 too,
     where its tensors no longer fit the L2); the module
     paths the kernels stand in for; each kernel's bound
     and, for the six on hopper_gemm.cuh, each stage's share of it, L2
     weight bytes a call as plan() counts them, cluster size and, for
     attention and MixFFN, the split, for the decoder tail the tile. The
     decoder tail takes its inputs from a
     seeded f32 forward of the flagship (a = fusion1's upsampled output,
     ll) and the heads' own weights at Co = 2, 1 (the flagship's heads), 73
     and 180 (PersNet-360Cities's);
  3. the slice: PerspectiveFields("Paramnet-360Cities-edina-centered") in
     bf16 with seeded random weights answers 3 batches of 8 640x640 images
     and one 480x640 image through inference_batch / inference on three
     paths (launches per forward): default (fused_attention 25), fused =
     fuse_ffn + fuse_convnext (fused_attention 25, mixffn 28, convnext_block
     18) and block = fuse_block (stage1_attention 3, fused_attention 4,
     fused_block 21); then the tail path: the heads' pyramid in the plain
     dataflow and kernels.decoder_tail with each head's own weights
     (fused_attention 25, decoder_tail 2), bf16, and in f32 against each
     head's own plain-dataflow output for the flagship and
     PersNet-360Cities;
  4. f32 parity against the plain path from the same weights: the kernel,
     fused and block paths, and all_fused = fuse_block + fuse_ffn +
     fuse_convnext (3 / 4 / 21 / mixffn 7 / convnext_block 18); the heads
     with JAX's three rewrites against their plain dataflow, and their bf16
     device times at B=8 and B=32;
  5. throughput of inference_batch at B=32, bf16: plain, kernel, fused and
     block paths in interleaved windows, then each path's split of 5 calls
     (host preprocess, device forward, postprocess + copies, synchronized
     at the network's call), and the kernel path's device forward with the
     heads' rewrites and once without;
  6. the other four zoo versions in bf16 with seeded random weights: a batch
     of 4 640x640 images and one 480x640 image each, against each version's
     output contract;
  7. serving, on the flagship in bf16 (default path): (a)
     PerspectiveFields(device_preprocess=True) on 8 640x640 images and one
     480x640 image: the device-resized network input within 1 LSB of the
     host's bit-exact resize (with TF32 on), the output contract, 25
     fused_attention launches a forward; (b) serving.BatchPredictor over 72
     640x640 images at B=32 (2 full batches and a padded tail of 8) in
     every combination of wire u8/f32, out_wire None/f16/u8, select
     None/parameters and depth 1/2, each against inference_batch's raw
     network-size outputs on the same batches (f32 wire equal, u8 wire
     within the bf16 tolerance, f16 out-wire within 2e-3 and u8 out-wire
     within 1/255 of the same wire's f32 readback), 25 launches a batch,
     the forward's outputs on the card; (c) bench_serving's five modes at
     B=32, depth 1 and 2, after its host<->device link probe;
  8. train and evaluate on the card: (a) a B=16 320^2 synthetic batch
     rendered on the card against the same cameras rendered on the CPU
     (images within 255e-3, latitude and parameters 1e-5, the up field on
     99.9% of pixels 1e-5 and on all 1e-3: next to a VVP inside the crop
     its direction is ill-conditioned), crop_distortion's up field on the
     card against the CPU (99% of pixels within 1e-5) and against float64
     (no further off than twice the CPU's float32, or 1e-4); (b) the
     trainer's full-width model (MiT-b3 at 320^2, regression heads,
     ParamNetConvNextRegress, bf16 autocast on f32 parameters) at B=16, 30
     AdamW steps on one batch with remat on, then off: finite, falling
     loss, a finite non-zero gradient for every parameter after the first
     step, no kernel launch, img/s and peak memory; a step of a model built
     with use_kernels=True raises (the kernels are inference-only); the
     entry points tools.train (with a checkpoint resume) and tools.evaluate
     at full width; (c) a train-state checkpoint saved twice, the newest
     corrupted, restored from the older with a warning, and one more step
     from it giving the loss of the run without the save; (d)
     evaluate_pairs over 64 synthetic 320^2 crops on the flagship: bf16 on
     the default kernel route (25 fused_attention launches a forward)
     against bf16 without kernels, f32 with the kernels against f32
     without (within 1e-4 degrees), and its img/s;
  9. parallel, the learning proof, the converters and the demo: (a)
     tools.learning_proof at its defaults with PROOF_STEPS steps (--smoke):
     the held-out mean up error must fall at least 2x from its random-init
     value; img/s; (b) the flagship's seeded state dict saved as a released
     {"model": sd} .pth, tools.convert_checkpoint to the flat .npz (its
     sanity forward on the card), PerspectiveFields(params=npz) bf16
     outputs bit-equal to the model loaded from the state dict, then
     tools.export_torch's .pth loaded strictly and equal to the state dict;
     (c) init_distributed on NCCL at world size 1 (an all-reduce); two gloo
     ranks sharing cuda:0, each on its 8 rows, against one process on the
     B=16 batch (tools.dryrun_multiprocess --config trainer: the trainer's
     full-width model, f32, TF32 off, one step): losses within 1e-5
     (relative), the clipped gradients within 1e-5, parameters within 0.1
     * lr wherever |g| > 1e-5 (DP_GRAD_TOL says why); the same two ranks as
     data=1 x model=2, the ruled Linears and their AdamW state split
     (parallel.tensor_parallel), against the same one-process step with the
     same bars, the replicated parameters bit-equal across the two ranks and
     each rank's AdamW state the size param_shardings implies, each rank's
     peak device memory printed beside the one process's; inference_batch split over
     two replicas on cuda:0 (forward_split, 16 images; the first replica
     the model itself, only the second a copy) bit-equal to the
     single path on each replica's 8 rows, 25 fused_attention launches a
     forward on each replica, and its distance from the single path on all
     16 rows at once (the plain ops' results depend on the batch size, and
     normalising a random up field's near-cancelling vectors amplifies
     that, so it is printed, not bounded); (d) the demo's inference
     (tools.demo) on its synthetic image with the flagship's seeded
     weights: 25 launches, finite camera parameters, and both PNGs where
     cv2 and matplotlib import (else a log line says drawing is held on
     the CPU only).

The line before the last is a JSON object with the kernels' launch counts,
errors, times and bounds; the last line is {"ok": true, "device": {...}}.
Without a CUDA device it exits non-zero and prints neither.

Two measurements of the bf16 attention, MixFFN, stage-1 attention and
decoder-tail kernels run apart from the phases above, each at the
flagship's B=8 shapes:

    python3 chip_smoke.py --phases
        builds the four with PF_PHASES (csrc/hopper_gemm.cuh's clock64()
        stamps) and prints the cycles of each phase of block 0 (``[clk]``
        lines), then each launch's device time from torch.profiler
        (``[prof]``);
    python3 chip_smoke.py --host-probe [ROOT]
        the host's time to issue one call of each wrapper (back to back,
        while the card is still busy), beside the device time back to back
        and from a CUDA graph, for the package under ROOT (default: this
        checkout; another commit unpacked with ``git archive`` compares).

And one of inference_batch, for the package under ROOT in the same way:

    python3 chip_smoke.py --split [ROOT]
        the flagship at B=32 on the default bf16 path: img/s, the split of
        each call into host preprocess, device forward and postprocess +
        copies (synchronized at the network's call), and the pinned host
        memory held while the results of 8 calls are kept (``[split]``
        lines).

And one of phase 8's training run, for how far the card's runs of it
differ:

    python3 chip_smoke.py --train-repeats N
        phase 8's seeded 30-step run (remat on) N times on its one batch:
        each run's losses, its loss terms at steps 1-2, and how many of
        the first step's gradients differ in sign from the first run's
        (``[repeat]`` lines).
"""

from __future__ import annotations

import ctypes
import importlib
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from perspectivefields_tpu_torch import PerspectiveFields, bench_serving, kernels, native
from perspectivefields_tpu_torch.config import model_zoo
from perspectivefields_tpu_torch.kernels import build as kbuild
from perspectivefields_tpu_torch.kernels import convnext_block as cb
from perspectivefields_tpu_torch.kernels import fused_block as fb
from perspectivefields_tpu_torch.kernels import mixffn as mf
from perspectivefields_tpu_torch.kernels import roofline
from perspectivefields_tpu_torch.kernels import stage1_attention as s1
from perspectivefields_tpu_torch.models import PersNet, graphed
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.models.convnext import ConvNeXtBlock
from perspectivefields_tpu_torch.models.mit import MixFFN, SRAttention
from perspectivefields_tpu_torch.bench_serving import card_line
from perspectivefields_tpu_torch.serving import BatchPredictor
from perspectivefields_tpu_torch import data as pdata
from perspectivefields_tpu_torch.checkpoint import restore_train_state, save_train_state
from perspectivefields_tpu_torch.evaluation import evaluate_pairs
from perspectivefields_tpu_torch.ops.pano import crop_distortion
from perspectivefields_tpu_torch.tools import convert_checkpoint, demo, export_torch, learning_proof
from perspectivefields_tpu_torch.tools import dryrun_multiprocess as dryrun
from perspectivefields_tpu_torch.tools import evaluate as tool_evaluate
from perspectivefields_tpu_torch.tools import train as tool_train
from perspectivefields_tpu_torch import parallel
from perspectivefields_tpu_torch.train import create_train_state, make_train_step

# the package exports the function decoder_tail under its module's name
dt = importlib.import_module("perspectivefields_tpu_torch.kernels.decoder_tail")
fa = importlib.import_module("perspectivefields_tpu_torch.kernels.fused_attention")

VERSION = "Paramnet-360Cities-edina-centered"
CLS_VERSION = "PersNet-360Cities"  # classification heads: Co = 73 and 180
OTHER_VERSIONS = [v for v in model_zoo if v != VERSION]
SEED = 0
# MiT-b3 at 320^2: (N, C, heads) of stages 2-4, M = 100 keys, and how many
# blocks of each stage the kernel runs per forward (4 + 18 + 3 = 25)
STAGES = {2: (1600, 128, 2, 4), 3: (400, 320, 5, 18), 4: (100, 512, 8, 3)}
LAUNCHES_PER_FORWARD = sum(s[3] for s in STAGES.values())
# MiT-b3 MixFFN at 320^2: (H = W, C, blocks) of stages 1-4 (3 + 4 + 18 + 3)
FFN_STAGES = {1: (80, 64, 3), 2: (40, 128, 4), 3: (20, 320, 18), 4: (10, 512, 3)}
# ParamNet's ConvNeXt-T over the 320^2 field: (H = W, C, blocks) (3 + 3 + 9 + 3)
CNX_STAGES = {0: (80, 96, 3), 1: (40, 192, 3), 2: (20, 384, 9), 3: (10, 768, 3)}
# MiT-b3 stage 1 at 320^2: (N, M, blocks); the fused block's stages 3-4:
# (H = W, C, heads, blocks)
STAGE1 = (6400, 100, 3)
BLOCK_STAGES = {3: (20, 320, 5, 18), 4: (10, 512, 8, 3)}
# The decoder tail at 320^2 runs on the stride-2 grid; its prediction widths
# by head (the flagship's two heads, then PersNet-360Cities's)
TAIL_HW = 160
TAIL_COS = {("flagship", "gravity_head"): 2, ("flagship", "latitude_head"): 1,
            ("cls", "gravity_head"): 73, ("cls", "latitude_head"): 180}
KERNELS = {mod.__name__.rsplit(".", 1)[1]: mod for mod in kernels.MODULES}
# Each path's PerspectiveFields flags and its kernels' launches per forward
PATHS = {
    "default": ({}, {"fused_attention": LAUNCHES_PER_FORWARD}),
    "fused": (dict(fuse_ffn=True, fuse_convnext=True),
              {"fused_attention": LAUNCHES_PER_FORWARD,
               "mixffn": sum(s[2] for s in FFN_STAGES.values()),
               "convnext_block": sum(s[2] for s in CNX_STAGES.values())}),
    "block": (dict(fuse_block=True),
              {"stage1_attention": STAGE1[2], "fused_attention": STAGES[2][3],
               "fused_block": sum(s[3] for s in BLOCK_STAGES.values())}),
    "all_fused": (dict(fuse_ffn=True, fuse_convnext=True, fuse_block=True),
                  {"stage1_attention": STAGE1[2], "fused_attention": STAGES[2][3],
                   "fused_block": sum(s[3] for s in BLOCK_STAGES.values()),
                   "mixffn": FFN_STAGES[1][2] + FFN_STAGES[2][2],
                   "convnext_block": sum(s[2] for s in CNX_STAGES.values())}),
    # the default model with each head's back end on the decoder-tail kernel
    # (tail_forward; no PerspectiveFields flag routes there)
    "tail": ({}, {"fused_attention": LAUNCHES_PER_FORWARD, "decoder_tail": 2}),
}
# The path whose run gives each kernel's launch count in the kernels line
LAUNCH_PATH = {"fused_attention": "default", "stage1_attention": "block", "mixffn": "fused",
               "convnext_block": "fused", "decoder_tail": "tail", "fused_block": "block"}
HEAD_FLAGS = ("fuse_embed", "fuse_conv0", "fuse_tail")
F32_TOL = 1e-4  # atol and rtol, f32 kernel vs f32 plain version
BF16_REL_TOL = 1e-2  # max|d| / max|ref|, bf16 kernel vs f32 plain version
FIELD_TOL, DEGREE_TOL = 5e-4, 1e-3  # tests/test_reference_parity.py:104-133
TIMING_CALLS = 30
# train / evaluate phase: the trainer's batch, steps on one batch, eval set
TRAIN_BATCH, TRAIN_STEPS, EVAL_IMAGES = 16, 30, 64
# bf16 evaluation with and without the attention kernel, degrees: the two
# bf16 forwards differ by bf16 rounding (2^-8 of a value) in each of 25
# blocks; the mean errors average it over 6.5M pixels, the medians move by
# whole 0.1-degree bins, the camera errors are means of 64 images
EVAL_BF16_TOL = 0.5
EVAL_F32_TOL = 1e-4  # degrees: the f32 kernel sums in cuBLAS's order
# serving phase: B=32 over 72 images (2 full batches and a padded tail of 8)
SERVE_BATCH, SERVE_IMAGES = 32, 72
U8_WIRE_TOL = 1 / 255 + 1e-6  # the u8 output wire's step, plus f32 rounding
F16_WIRE_TOL = 2e-3  # the f16 output wire, relative to max(1, |x|)
# phase 9: learning-proof steps (about a minute), the held-out up error's
# least fall over them; the split's images (two replicas, a padded tail)
PROOF_STEPS, PROOF_MIN_FALL = 500, 2.0
SPLIT_IMAGES = 16
# tests/test_torch_train.py's tolerances: losses 1e-5 relative, the
# first step's clipped gradients 1e-5, parameters 0.1 * lr. On the card the
# parameters are held where |g| > 1e-5 only: the ranks' B=8 convolutions
# round differently from the one process's B=16 ones (gradients within
# ~3e-7), and Adam's first update, lr * g / (|g| + 1e-8), turns that into
# up to 2 * lr where the gradient itself is at that noise level (5,588 of
# 104.6M elements on an NVIDIA H100 80GB HBM3 at 700 W, where one process
# against itself stays within 6e-7 everywhere). The CPU test holds every
# element.
DP_LOSS_RTOL, DP_GRAD_TOL = 1e-5, 1e-5
DP_PARAM_TOL = 0.1 * dryrun.LR


def log(msg: str) -> None:
    print(msg, flush=True)


def probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    card = card_line()
    log(f"[probe] card: {card}")
    log(f"[probe] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}, "
        f"count {torch.cuda.device_count()}")
    nvcc = kbuild.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    log(f"[probe] nvcc {nvcc}: {ver.stdout.strip().splitlines()[-1]}")
    return card


def build_phase() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, in parallel
        libs = dict(zip(KERNELS, pool.map(kbuild.build, KERNELS)))
    for mod in KERNELS.values():
        mod.load()
    log(f"[build] {', '.join(lib.name for lib in libs.values())} in {time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                log(f"[build] {name} ptxas: {line.strip()}")


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of per-call times, each call synchronised (for whole forwards)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = TIMING_CALLS, warmup: int = 3) -> float:
    """Device time per call: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls`` (no synchronisation between calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def graph_ms(fn, calls: int = TIMING_CALLS) -> float:
    """Device time per call without the host's launch cost: ``fn`` captured
    once in a CUDA graph, the graph replayed back to back (``device_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs ask
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = device_ms(graph.replay, calls)
    del graph
    return ms


def stage_bound(cost) -> tuple[float, str]:
    """One call's bound (ms) and what bounds it (kernels/roofline.py)."""
    terms = roofline.bound_terms(*cost)
    by = max(terms, key=terms.get)
    return terms[by], by


def _check(kernel: str, tag: str, got, want, dtype) -> tuple[float, bool]:
    err = (got.float() - want).abs()
    abs_err, ref_max = err.max().item(), want.abs().max().item()
    if dtype == torch.float32:
        ok = bool((err <= F32_TOL + F32_TOL * want.abs()).all())
        bound = f"atol=rtol={F32_TOL}"
    else:
        ok = abs_err / ref_max <= BF16_REL_TOL
        bound = f"rel<={BF16_REL_TOL}"
    log(f"[kernel] {kernel} {tag} {str(dtype)[6:]}: max|d|={abs_err:.3e} rel={abs_err / ref_max:.3e} "
        f"({bound}) {'ok' if ok else 'FAIL'}")
    return abs_err, ok


def _randn(rng, *shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device="cuda")


def _attn_inputs(rng, b, n, m, c):
    """numpy inputs scaled as in tests/test_fused_attention.py:23-34,
    weights in nn.Linear's (out, in) layout."""
    return [_randn(rng, b, n, c), _randn(rng, b, m, c), _randn(rng, c, c, scale=0.05),
            _randn(rng, c, scale=0.01), _randn(rng, 2 * c, c, scale=0.05),
            _randn(rng, 2 * c, scale=0.01), _randn(rng, c, c, scale=0.05),
            _randn(rng, c, scale=0.01)]


def _ffn_inputs(rng, b, h, w, c):
    """x and MixFFN weights at their init scales: Linear (out, in), the
    depthwise kernel (4C, 1, 3, 3)."""
    return [_randn(rng, b, h, w, c), _randn(rng, 4 * c, c, scale=c**-0.5),
            _randn(rng, 4 * c, scale=0.1), _randn(rng, 4 * c, 1, 3, 3, scale=1 / 3),
            _randn(rng, 4 * c, scale=0.1), _randn(rng, c, 4 * c, scale=(4 * c) ** -0.5),
            _randn(rng, c, scale=0.1)]


def _cnx_inputs(rng, b, h, w, c):
    """x and ConvNeXt-block weights: the depthwise kernel (C, 1, 7, 7),
    LayerNorm affine, Linear (out, in), and a layer scale of order 1 so the
    MLP branch is not hidden under the residual."""
    return [_randn(rng, b, h, w, c), _randn(rng, c, 1, 7, 7, scale=1 / 7),
            _randn(rng, c, scale=0.1), 1.0 + _randn(rng, c, scale=0.1), _randn(rng, c, scale=0.1),
            _randn(rng, 4 * c, c, scale=c**-0.5), _randn(rng, 4 * c, scale=0.1),
            _randn(rng, c, 4 * c, scale=(4 * c) ** -0.5), _randn(rng, c, scale=0.1),
            _randn(rng, c, scale=0.5)]


def attention_kernel_phase() -> dict:
    # the stages at B=8, then ragged row tiles with M = 5, 128 and 1 (head
    # splits of 2 and 8) and the one width past 640 that B6's gate sends here
    cases = [(8, n, 100, c, h) for n, c, h, _ in STAGES.values()] + [
        (3, 37, 5, 128, 2), (2, 129, 128, 320, 5), (1, 100, 1, 512, 8), (1, 31, 100, 704, 11)]
    max_abs, failures = 0.0, []
    for b, n, m, c, heads in cases:
        rng = np.random.default_rng(b * 1000 + n + m + c)
        args = _attn_inputs(rng, b, n, m, c)
        res = _randn(rng, b, n, c)
        # the f32 kernel's 32-row tiles leave no room for C = 704 (bf16 only)
        for dtype in (torch.float32, torch.bfloat16)[c > 640:]:
            for residual in (None, res):
                a = [t.to(dtype) for t in args]
                r = None if residual is None else residual.to(dtype)
                got = fa.fused_attention(*a, heads, 64**-0.5, residual=r)
                torch.cuda.synchronize()
                # the plain version in f32 on the same (rounded) inputs
                want = fa.fused_attention_reference(
                    *[t.float() for t in a], heads, 64**-0.5,
                    residual=None if r is None else r.float(),
                )
                tag = f"B={b} N={n} M={m} C={c} heads={heads} residual={r is not None}"
                err, ok = _check("fused_attention", tag, got, want, dtype)
                max_abs = max(max_abs, err)
                if not ok:
                    failures.append(tag)
    if failures:
        raise AssertionError(f"fused_attention disagrees with its plain version: {failures}")

    # bf16 device times at B=8 (the slice's batch): the kernel, its plain
    # version, F.multi_head_attention_forward (the library call for the same
    # function; the port never calls it), and SRAttention's kernel path vs
    # its plain path (sr conv + LN included in both)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    costs = []
    for stage, (n, c, heads, blocks) in STAGES.items():
        rng = np.random.default_rng(stage)
        a = [t.to(torch.bfloat16) for t in _attn_inputs(rng, 8, n, 100, c)]
        x, kv_in, wq, bq, wkv, bkv, wp, bp = a
        xt, kvt, bias = x.transpose(0, 1), kv_in.transpose(0, 1), torch.cat([bq, bkv])

        def library():
            return F.multi_head_attention_forward(
                xt, kvt, kvt, c, heads, None, bias, None, None, False, 0.0, wp, bp,
                training=False, need_weights=False, use_separate_proj_weight=True,
                q_proj_weight=wq, k_proj_weight=wkv[:c], v_proj_weight=wkv[c:],
            )[0]

        with torch.inference_mode():
            lib_out = library().transpose(0, 1)
            ker_out = fa.fused_attention(*a, heads, 64**-0.5)
            lib_d = (lib_out.float() - ker_out.float()).abs().max().item()
            t_k = device_ms(lambda: fa.fused_attention(*a, heads, 64**-0.5))
            t_g = graph_ms(lambda: fa.fused_attention(*a, heads, 64**-0.5))
            t_p = device_ms(lambda: fa.fused_attention_reference(*a, heads, 64**-0.5))
            t_l = device_ms(library)
        costs.append((roofline.attention_cost(8, n, 100, c, heads), blocks))
        t_b, by = stage_bound(costs[-1][0])
        sr = {2: 4, 3: 2, 4: 1}[stage]
        xm = _randn(rng, 8, int(round(n**0.5)), int(round(n**0.5)), c).to(torch.bfloat16)
        mods = {}
        for use in (True, False):
            mods[use] = init_random_(SRAttention(c, heads, sr, use_kernels=use), seed=stage).to(
                "cuda", torch.bfloat16).eval()
        with torch.inference_mode():
            t_mk = device_ms(lambda: mods[True](xm))
            t_mp = device_ms(lambda: mods[False](xm))
        p = fa.launch_plan(8, n, c, heads, 100, x.device)
        log(f"[kernel] fused_attention stage {stage} bf16 B=8 N={n} C={c} heads={heads}: kernel "
            f"{t_k:.4f} ms (from a CUDA graph, without the host's launch cost: {t_g:.4f} ms), "
            f"plain version {t_p:.4f} ms, F.multi_head_attention_forward {t_l:.4f} ms "
            f"(max|d| vs kernel {lib_d:.2e}), bound {t_b:.4f} ms ({by}), {t_b / t_k:.1%} of the bound, "
            f"L2 weight bytes {p['weight_bytes'] / 1e6:.1f} MB a call, cluster {p['cluster']} "
            f"split {p['split']} ({p['heads_per_block']} heads a block); SRAttention kernel path "
            f"{t_mk:.4f} ms, plain path {t_mp:.4f} ms")
        for key, v in zip(tot, (t_k, t_p, t_l)):
            tot[key] += blocks * v
    bound, by = roofline.per_forward(costs)
    return {"max_abs_err": max_abs, **tot, "bound_ms": bound, "bound_by": by}


def _fused_kernel_phase(name, mod, fn, ref, make_inputs, stages, cost, module_pair,
                        extra_cases=(), plan=None) -> dict:
    """Check ``fn`` (the wrapper) against ``ref`` (its plain version) at the
    stage shapes at B=8 and ragged cases, f32 and bf16; then time both, the
    module's fused and plain paths, and sum per forward with the bound.
    ``plan(b, h, w, c)``, where given, tells each stage's cluster size and
    L2 weight bytes a call."""
    cases = [(8, hw, hw, c) for hw, c, _ in stages.values()] + [(3, 13, 7, 64), *extra_cases]
    max_abs, failures = 0.0, []
    for b, h, w, c in cases:
        args = make_inputs(np.random.default_rng(b * 1000 + h + w + c), b, h, w, c)
        for dtype in (torch.float32, torch.bfloat16):
            a = [t.to(dtype) for t in args]
            before = mod.LAUNCHES
            got = fn(*a)
            torch.cuda.synchronize()
            if mod.LAUNCHES != before + 1:
                raise AssertionError(f"{name}: the wrapper did not launch its kernel")
            want = ref(*[t.float() for t in a])  # f32 on the same rounded inputs
            tag = f"B={b} H={h} W={w} C={c}"
            err, ok = _check(name, tag, got, want, dtype)
            max_abs = max(max_abs, err)
            if not ok:
                failures.append(f"{tag} {dtype}")
    if failures:
        raise AssertionError(f"{name} disagrees with its plain version: {failures}")

    tot = dict(ms=0.0, plain_ms=0.0)
    costs = []
    for stage, (hw, c, blocks) in stages.items():
        a = [t.to(torch.bfloat16) for t in make_inputs(np.random.default_rng(stage), 8, hw, hw, c)]
        with torch.inference_mode():
            t_k = device_ms(lambda: fn(*a))
            t_g = graph_ms(lambda: fn(*a))
            t_p = device_ms(lambda: ref(*a))
        costs.append((cost(8, hw, hw, c), blocks))
        t_b, by = stage_bound(costs[-1][0])
        mods = {f: module_pair(c, f).to("cuda", torch.bfloat16).eval() for f in (True, False)}
        for m in mods.values():
            init_random_(m, seed=stage)
        mods[True].load_state_dict(mods[False].state_dict())
        with torch.inference_mode():
            t_mk = device_ms(lambda: mods[True](a[0]))
            t_mp = device_ms(lambda: mods[False](a[0]))
        extra = ""
        if plan is not None:
            p = plan(8, hw, hw, c)
            extra = (f", {t_b / t_k:.1%} of the bound, L2 weight bytes {p['weight_bytes'] / 1e6:.1f} MB "
                     f"a call, cluster {p['cluster']}")
            if "split" in p:
                th, tw = p["tile"]
                extra += f" split {p['split']}, tile {th}x{tw}"
        log(f"[kernel] {name} stage {stage} bf16 B=8 {hw}x{hw} C={c}: kernel {t_k:.4f} ms "
            f"(from a CUDA graph: {t_g:.4f} ms), "
            f"plain version {t_p:.4f} ms, bound {t_b:.4f} ms ({by}){extra}; module fused path "
            f"{t_mk:.4f} ms, unfused path {t_mp:.4f} ms")
        for key, v in zip(tot, (t_k, t_p)):
            tot[key] += blocks * v
    bound, by = roofline.per_forward(costs)
    return {"max_abs_err": max_abs, **tot, "bound_ms": bound, "bound_by": by, "library_ms": None}


def stage1_kernel_phase() -> dict:
    """stage1_attention vs its plain version at stage 1 (B=8) and ragged
    cases (N = 999, 6401 and 64; M = 37, 128 and 1), f32 and bf16, with and
    without the residual; then bf16 times of the kernel (back to back and
    from a CUDA graph), its plain version, F.multi_head_attention_forward
    (the library call; the port never calls it), fused_attention at the
    same shape, SRAttention's stage-1 route vs its plain path, and the
    kernel at B=32."""
    n1, m1, blocks = STAGE1
    max_abs, failures = 0.0, []
    for b, n, m in [(8, n1, m1), (3, 999, 37), (2, 6401, 128), (3, 64, 1)]:
        rng = np.random.default_rng(b * 1000 + n + m)
        args = _attn_inputs(rng, b, n, m, 64)
        res = _randn(rng, b, n, 64)
        for dtype in (torch.float32, torch.bfloat16):
            for residual in (None, res):
                a = [t.to(dtype) for t in args]
                r = None if residual is None else residual.to(dtype)
                before = s1.LAUNCHES
                got = s1.stage1_attention(*a, 0.125, residual=r)
                torch.cuda.synchronize()
                if s1.LAUNCHES != before + 1:
                    raise AssertionError("stage1_attention: the wrapper did not launch its kernel")
                want = s1.stage1_attention_reference(
                    *[t.float() for t in a], 0.125, residual=None if r is None else r.float()
                )
                tag = f"B={b} N={n} M={m} residual={r is not None}"
                err, ok = _check("stage1_attention", tag, got, want, dtype)
                max_abs = max(max_abs, err)
                if not ok:
                    failures.append(f"{tag} {dtype}")
    if failures:
        raise AssertionError(f"stage1_attention disagrees with its plain version: {failures}")

    rng = np.random.default_rng(1)
    a = [t.to(torch.bfloat16) for t in _attn_inputs(rng, 8, n1, m1, 64)]
    x, kv_in, wq, bq, wkv, bkv, wp, bp = a
    xt, kvt, bias = x.transpose(0, 1), kv_in.transpose(0, 1), torch.cat([bq, bkv])

    def library():
        return F.multi_head_attention_forward(
            xt, kvt, kvt, 64, 1, None, bias, None, None, False, 0.0, wp, bp,
            training=False, need_weights=False, use_separate_proj_weight=True,
            q_proj_weight=wq, k_proj_weight=wkv[:64], v_proj_weight=wkv[64:],
        )[0]

    with torch.inference_mode():
        lib_d = (library().transpose(0, 1).float() - s1.stage1_attention(*a, 0.125).float())
        lib_d = lib_d.abs().max().item()
        t_k = device_ms(lambda: s1.stage1_attention(*a, 0.125))
        t_g = graph_ms(lambda: s1.stage1_attention(*a, 0.125))
        t_p = device_ms(lambda: s1.stage1_attention_reference(*a, 0.125))
        t_l = device_ms(library)
        t_b1 = device_ms(lambda: fa.fused_attention(*a, 1, 0.125))
    cost = roofline.attention_cost(8, n1, m1, 64, 1)
    t_b, by = stage_bound(cost)
    xm = _randn(rng, 8, 80, 80, 64).to(torch.bfloat16)
    mods = {f: init_random_(SRAttention(64, 1, 8, use_kernels=True, fuse_block=f), seed=1).to(
        "cuda", torch.bfloat16).eval() for f in (True, False)}
    with torch.inference_mode():
        t_mk = device_ms(lambda: mods[True](xm))
        t_mp = device_ms(lambda: mods[False](xm))
    p = s1.launch_plan(8, n1, x.device)
    log(f"[kernel] stage1_attention stage 1 bf16 B=8 N={n1} M={m1}: kernel {t_k:.4f} ms (from a "
        f"CUDA graph, without the host's launch cost: {t_g:.4f} ms), plain "
        f"version {t_p:.4f} ms, F.multi_head_attention_forward {t_l:.4f} ms (max|d| vs kernel "
        f"{lib_d:.2e}), fused_attention at this shape {t_b1:.4f} ms, bound {t_b:.4f} ms ({by}), "
        f"{t_b / t_g:.1%} of the bound (graph), L2 weight bytes {p['weight_bytes'] / 1e6:.1f} MB a "
        f"call, {p['blocks_per_image']} blocks an image, {p['tiles_per_group']} tiles a warpgroup; "
        f"SRAttention stage-1 route {t_mk:.4f} ms, plain path {t_mp:.4f} ms")
    # B=32: x, the residual and out (52 MB each way with it) no longer fit the L2
    a32 = [t.to(torch.bfloat16) for t in _attn_inputs(np.random.default_rng(32), 32, n1, m1, 64)]
    r32 = _randn(np.random.default_rng(33), 32, n1, 64).to(torch.bfloat16)
    x32, kv32 = a32[0].transpose(0, 1), a32[1].transpose(0, 1)
    with torch.inference_mode():
        t_k32 = device_ms(lambda: s1.stage1_attention(*a32, 0.125, residual=r32))
        t_g32 = graph_ms(lambda: s1.stage1_attention(*a32, 0.125, residual=r32))
        t_l32 = device_ms(lambda: F.multi_head_attention_forward(
            x32, kv32, kv32, 64, 1, None, torch.cat([a32[3], a32[5]]), None, None, False, 0.0,
            a32[6], a32[7], training=False, need_weights=False, use_separate_proj_weight=True,
            q_proj_weight=a32[2], k_proj_weight=a32[4][:64], v_proj_weight=a32[4][64:])[0])
    t_b32, by32 = stage_bound(roofline.attention_cost(32, n1, m1, 64, 1, residual=True))
    p32 = s1.launch_plan(32, n1, x.device)
    log(f"[kernel] stage1_attention stage 1 bf16 B=32 N={n1} M={m1} with the residual: kernel "
        f"{t_k32:.4f} ms (from a CUDA graph: {t_g32:.4f} ms), F.multi_head_attention_forward "
        f"(no residual) {t_l32:.4f} ms, bound {t_b32:.4f} ms ({by32}), {t_b32 / t_g32:.1%} of the "
        f"bound (graph), {p32['blocks_per_image']} blocks an image, {p32['tiles_per_group']} tiles "
        "a warpgroup")
    bound, by = roofline.per_forward([(cost, blocks)])
    return {"max_abs_err": max_abs, "ms": blocks * t_k, "plain_ms": blocks * t_p,
            "bound_ms": bound, "bound_by": by, "library_ms": blocks * t_l}


def _block_inputs(rng, b, h, w, c, m):
    """ln1x, kv_in, res and a MiT block's weights, scaled as in
    tests/test_fused_block.py:24-34; torch layouts."""
    n, hid = h * w, 4 * c
    args = [_randn(rng, b, n, c, scale=0.5), _randn(rng, b, m, c, scale=0.5),
            _randn(rng, b, n, c, scale=0.5)]
    for shape in [(c, c), (c,), (2 * c, c), (2 * c,), (c, c), (c,), (c,), (c,), (hid, c), (hid,),
                  (hid, 1, 3, 3), (hid,), (c, hid), (c,)]:
        args.append(_randn(rng, *shape, scale=0.05))
    args[9] = args[9] + 1.0  # the LayerNorm scale near 1
    return args


def block_kernel_phase() -> dict:
    """fused_block vs its plain version at stages 3-4 (B=8), ragged grids
    (B = 1, 3, 5; 7x5, 7x11, 13x9) and a width past MiT's (C = 192), f32 and
    bf16; then bf16 times of the
    kernel, its plain version and the unfused path it stands in for after
    LN1 (fused_attention with the residual, LayerNorm, the unfused MixFFN,
    the skip), with each stage's share of the bound, L2 weight bytes and
    cluster size. No single PyTorch call computes the block."""
    cases = [(8, hw, hw, c, heads, 100) for hw, c, heads, _ in BLOCK_STAGES.values()]
    # ragged maps and batches the cluster does not divide
    cases += [(3, 7, 5, 128, 2, 7), (1, 20, 20, 320, 5, 100), (5, 7, 11, 512, 8, 100),
              (3, 13, 9, 320, 5, 64), (2, 9, 7, 192, 3, 63)]
    max_abs, failures = 0.0, []
    for b, h, w, c, heads, m in cases:
        args = _block_inputs(np.random.default_rng(b * 1000 + h + w + c), b, h, w, c, m)
        for dtype in (torch.float32, torch.bfloat16):
            a = [t.to(dtype) for t in args]
            before = fb.LAUNCHES
            got = fb.fused_block(*a, heads, 64**-0.5, h, w)
            torch.cuda.synchronize()
            if fb.LAUNCHES != before + 1:
                raise AssertionError("fused_block: the wrapper did not launch its kernel")
            want = fb.fused_block_reference(*[t.float() for t in a], heads, 64**-0.5, h, w)
            tag = f"B={b} H={h} W={w} C={c} heads={heads} M={m}"
            err, ok = _check("fused_block", tag, got, want, dtype)
            max_abs = max(max_abs, err)
            if not ok:
                failures.append(f"{tag} {dtype}")
    if failures:
        raise AssertionError(f"fused_block disagrees with its plain version: {failures}")

    tot = dict(ms=0.0, plain_ms=0.0)
    costs = []
    for stage, (hw, c, heads, blocks) in BLOCK_STAGES.items():
        a = [t.to(torch.bfloat16) for t in _block_inputs(np.random.default_rng(stage), 8, hw, hw, c, 100)]
        ln1x, kv_in, res, wq, bq, wkv, bkv, wp, bp, lns, lnb, w1, b1, dwk, dwb, w2, b2 = a
        ffn = MixFFN(c, 4 * c).to("cuda", torch.bfloat16).eval()
        ffn.load_state_dict({"fc1.weight": w1, "fc1.bias": b1, "dwconv.dwconv.weight": dwk,
                             "dwconv.dwconv.bias": dwb, "fc2.weight": w2, "fc2.bias": b2})

        def unfused():
            x2 = fa.fused_attention(ln1x, kv_in, wq, bq, wkv, bkv, wp, bp, heads, 64**-0.5,
                                    residual=res)
            y = F.layer_norm(x2, (c,), lns, lnb, 1e-6)
            return x2 + ffn(y.view(8, hw, hw, c)).reshape(8, hw * hw, c)

        with torch.inference_mode():
            t_k = device_ms(lambda: fb.fused_block(*a, heads, 64**-0.5, hw, hw))
            t_p = device_ms(lambda: fb.fused_block_reference(*a, heads, 64**-0.5, hw, hw))
            t_u = device_ms(unfused)
        costs.append((roofline.fused_block_cost(8, hw, 100, c, heads), blocks))
        t_b, by = stage_bound(costs[-1][0])
        p = fb.launch_plan(8, hw, hw, c, heads, ln1x.device)
        th, tw = p["tile"]
        log(f"[kernel] fused_block stage {stage} bf16 B=8 {hw}x{hw} C={c} heads={heads} tile "
            f"{th}x{tw}: kernel {t_k:.4f} ms, plain version {t_p:.4f} ms, bound {t_b:.4f} ms "
            f"({by}), {t_b / t_k:.1%} of the bound, L2 weight bytes {p['weight_bytes'] / 1e6:.1f} MB "
            f"a call, cluster {p['cluster']}; unfused block path after LN1 {t_u:.4f} ms")
        for key, v in zip(tot, (t_k, t_p)):
            tot[key] += blocks * v
    bound, by = roofline.per_forward(costs)
    return {"max_abs_err": max_abs, **tot, "bound_ms": bound, "bound_by": by, "library_ms": None}


def net_input(b: int, seed: int, dtype) -> torch.Tensor:
    """A normalized (b, 320, 320, 3) batch on the card from seeded uint8
    640x640 images, through the native preprocess."""
    cfg = model_zoo[VERSION]["config"]
    imgs = np.random.default_rng(seed).integers(0, 256, size=(b, 640, 640, 3), dtype=np.uint8)
    x = native.preprocess_batch(imgs, 320, 320, np.asarray(cfg.pixel_mean, np.float32),
                                np.asarray(cfg.pixel_std, np.float32))
    return torch.from_numpy(x).to("cuda", dtype)


def persnet(version: str, sd: dict, dtype) -> PersNet:
    """A built PersNet on the card (the attention kernels on in bf16)."""
    net = PersNet(model_zoo[version]["config"], use_kernels=dtype == torch.bfloat16)
    net.load_state_dict(sd)
    return net.to("cuda", dtype).eval()


def set_flags(head, on: bool) -> None:
    """JAX's three head rewrites on (the default) or off (the plain
    dataflow) in one SegFormerDecoder."""
    for flag in HEAD_FLAGS:
        setattr(head, flag, on)


def set_head_flags(net, on: bool) -> None:
    """``set_flags`` in every head of a built PersNet."""
    for head in net.persformer_heads.values():
        set_flags(head, on)


def head_weights(head) -> list:
    """A head's conv0, conv1 and prediction parameters, as the decoder-tail
    kernel takes them."""
    c0, c1, p = head.conv_fuse_conv0.conv, head.conv_fuse_conv1.conv, head.pred
    return [c0.weight, c0.bias, c1.weight, c1.bias, p.weight, p.bias]


def tail_forward(net, x) -> dict:
    """The tail path: backbone and low-level encoder, each head's pyramid in
    the plain dataflow, then kernels.decoder_tail with the head's own
    weights. Raw head outputs (before the gravity normalise), by head."""
    hl, ll = net.backbone(x), net.ll_enc(x).contiguous()
    set_head_flags(net, False)
    out = {name: kernels.decoder_tail(head.pyramid(hl).contiguous(), ll, *head_weights(head))
           for name, head in net.persformer_heads.items()}
    set_head_flags(net, True)
    return out


def _tail_weights(rng, cin, co):
    """conv0, conv1 and 1x1 weights at their init scales, biases of 0.1."""
    return [_randn(rng, 64, cin, 3, 3, scale=(9 * cin) ** -0.5), _randn(rng, 64, scale=0.1),
            _randn(rng, 32, 64, 3, 3, scale=(9 * 64) ** -0.5), _randn(rng, 32, scale=0.1),
            _randn(rng, co, 32, 1, 1, scale=32**-0.5), _randn(rng, co, scale=0.1)]


def tail_kernel_phase(sd, sd_cls) -> dict:
    """decoder_tail vs its plain version on the flagship's activations (B=8:
    a = fusion1's upsampled output and ll from a seeded f32 forward) with
    each head's own weights, Co = 2, 1, 73 and 180, f32 and bf16, a ragged
    13x9 map (Ca=32, Cl=8) whose every tile touches a border and a 1x1 map
    (Co = 9, 192); then bf16 times of the kernel (back to back and from a
    CUDA graph), its plain version, the head's unfused back end
    on the same a (conv0 -> resize_bilinear -> conv1 -> 1x1 in cuDNN and
    PyTorch), fuse_tail's phase form, and JAX's whole back end (fuse_conv0 +
    fuse_tail from fusion1's output before its upsample), and the plan's
    cluster against single blocks on the same grid. No single PyTorch call
    computes the tail."""
    f32, bf = torch.float32, torch.bfloat16
    nets = {dtype: {"flagship": persnet(VERSION, sd, dtype), "cls": persnet(CLS_VERSION, sd_cls, dtype)}
            for dtype in (f32, bf)}
    x = net_input(8, SEED + 3, f32)
    with torch.inference_mode():
        flag = nets[f32]["flagship"]
        hl, ll = flag.backbone(x), flag.ll_enc(x).contiguous()
        set_head_flags(flag, False)
        a = flag.persformer_heads["gravity_head"].pyramid(hl).contiguous()
        set_head_flags(flag, True)
    cases = [(f"{key[0]} {key[1]} B=8 {TAIL_HW}x{TAIL_HW}", a, ll,
              head_weights(nets[f32][key[0]].persformer_heads[key[1]])) for key in TAIL_COS]
    rng = np.random.default_rng(5)
    for co in (2, 73):
        cases.append(("ragged B=3 13x9 Ca=32 Cl=8", _randn(rng, 3, 13, 9, 32), _randn(rng, 3, 13, 9, 8),
                      _tail_weights(rng, 40, co)))
    for co in (9, 192):
        cases.append(("ragged B=2 1x1 Ca=32 Cl=8", _randn(rng, 2, 1, 1, 32), _randn(rng, 2, 1, 1, 8),
                      _tail_weights(rng, 40, co)))
    max_abs, failures = 0.0, []
    for tag, a_, ll_, w in cases:
        for dtype in (f32, bf):
            args = [t.detach().to(dtype).contiguous() for t in (a_, ll_, *w)]
            before = dt.LAUNCHES
            with torch.inference_mode():
                got = dt.decoder_tail(*args)
                torch.cuda.synchronize()
                if dt.LAUNCHES != before + 1:
                    raise AssertionError("decoder_tail: the wrapper did not launch its kernel")
                want = dt.decoder_tail_reference(*[t.float() for t in args])
            tag_co = f"{tag} Co={args[-1].shape[0]}"
            err, ok = _check("decoder_tail", tag_co, got, want, dtype)
            max_abs = max(max_abs, err)
            if not ok:
                failures.append(f"{tag_co} {dtype}")
            del got, want
    if failures:
        raise AssertionError(f"decoder_tail disagrees with its plain version: {failures}")

    tot = dict(ms=0.0, plain_ms=0.0)
    with torch.inference_mode():
        flag = nets[bf]["flagship"]
        xb = x.to(bf)
        hl_b, ll_b = flag.backbone(xb), flag.ll_enc(xb).contiguous()
        ghead = flag.persformer_heads["gravity_head"]
        ghead.fuse_conv0 = False
        a_b = ghead.pyramid(hl_b).contiguous()
        ghead.fuse_conv0 = True
        a0_b = ghead.pyramid(hl_b)  # before fusion1's upsample
        for (model_key, head_name), co in TAIL_COS.items():
            head = nets[bf][model_key].persformer_heads[head_name]
            args = [a_b, ll_b, *head_weights(head)]
            t_k = device_ms(lambda: dt.decoder_tail(*args))
            t_g = graph_ms(lambda: dt.decoder_tail(*args))
            t_p = device_ms(lambda: dt.decoder_tail_reference(*args))
            head.fuse_conv0, head.fuse_tail = False, False
            t_u = device_ms(lambda: head.back_end(a_b, ll_b))
            head.fuse_tail = True
            t_f = device_ms(lambda: head.back_end(a_b, ll_b))
            head.fuse_conv0 = True
            t_j = device_ms(lambda: head.back_end(a0_b, ll_b))
            t_b, by = stage_bound(roofline.decoder_tail_cost(8, TAIL_HW, TAIL_HW, co=co))
            p = dt.launch_plan(8, TAIL_HW, TAIL_HW, a_b.shape[-1], ll_b.shape[-1], co, a_b.device)
            th, tw = p["tile"]
            log(f"[kernel] decoder_tail {model_key} {head_name} bf16 B=8 {TAIL_HW}x{TAIL_HW} Co={co}: "
                f"kernel {t_k:.4f} ms (from a CUDA graph: {t_g:.4f} ms), plain version {t_p:.4f} ms, "
                f"bound {t_b:.4f} ms ({by}), {t_b / t_k:.1%} of the bound, L2 weight bytes "
                f"{p['weight_bytes'] / 1e6:.1f} MB a call, tile {th}x{tw}, cluster {p['cluster']}, "
                f"{p['blocks']} blocks x {p['iters']} tiles; "
                f"unfused back end {t_u:.4f} ms, fuse_tail phase form {t_f:.4f} ms, JAX's back end "
                f"(fuse_conv0 + fuse_tail) {t_j:.4f} ms; no single PyTorch call computes it")
            if model_key == "flagship":
                tot["ms"] += t_k
                tot["plain_ms"] += t_p
        # the plan's cluster against single blocks on the same grid (same
        # waves): what multicasting w0 saves a tile, with w0's L2 reads
        head = nets[bf]["flagship"].persformer_heads["gravity_head"]
        args = [a_b, ll_b, *head_weights(head)]
        p = dt.launch_plan(8, TAIL_HW, TAIL_HW, a_b.shape[-1], ll_b.shape[-1], 2, a_b.device)
        w0 = 9 * 64 * (a_b.shape[-1] + ll_b.shape[-1]) * 2
        times = {k: graph_ms(lambda k=k: dt.launch(*args, *p["tile"], k, p["blocks"], p["stages"]))
                 for k in sorted({1, p["cluster"]})}
        log("[kernel] decoder_tail flagship gravity_head bf16 B=8 Co=2, the plan's grid of "
            f"{p['blocks']} blocks x {p['iters']} tiles from a CUDA graph: "
            + ", ".join(f"cluster {k} {t:.4f} ms (w0 read from L2 {p['blocks'] // k * p['iters'] * w0 / 1e6:.0f} MB)"
                        for k, t in times.items()))
    bound, by = roofline.per_forward(roofline.flagship()["decoder_tail"][1])
    return {"max_abs_err": max_abs, **tot, "bound_ms": bound, "bound_by": by, "library_ms": None}


def kernel_phase(sd, sd_cls) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {
        "fused_attention": attention_kernel_phase(),
        "stage1_attention": stage1_kernel_phase(),
        "mixffn": _fused_kernel_phase(
            "mixffn", mf, mf.mixffn, mf.mixffn_reference, _ffn_inputs, FFN_STAGES,
            roofline.mixffn_cost,
            lambda c, fused: MixFFN(c, 4 * c, fused=fused),
            extra_cases=[(1, 7, 7, 512), (2, 9, 5, 640), (5, 7, 11, 384), (2, 9, 10, 128),
                         (2, 9, 5, 704)],
            plan=lambda b, h, w, c: mf.launch_plan(b, h, w, c, torch.device("cuda")),
        ),
        "convnext_block": _fused_kernel_phase(
            "convnext_block", cb, cb.convnext_block, cb.convnext_block_reference, _cnx_inputs,
            CNX_STAGES, roofline.convnext_block_cost,
            lambda c, fused: ConvNeXtBlock(c, fused=fused),
            extra_cases=[(1, 10, 10, 768), (3, 13, 9, 768), (5, 7, 11, 384), (1, 7, 7, 512),
                         (1, 4, 4, 1024)],
            plan=lambda b, h, w, c: cb.launch_plan(b, h, w, c, torch.device("cuda")),
        ),
        "decoder_tail": tail_kernel_phase(sd, sd_cls),
        "fused_block": block_kernel_phase(),
    }


def seeded_state_dict(cfg) -> dict:
    """Seeded random weights for the whole model. The latitude head's
    prediction conv is shrunk 100x so latitudes sit inside (-1, 1): random
    init otherwise drives it far into its clamp, where asin's slope makes
    the degree comparison ill-posed (one f32 ulp moves 0.02 degrees)."""
    model = init_random_(PersNet(cfg), seed=SEED)
    sd = model.state_dict()
    for key in ("weight", "bias"):
        sd[f"persformer_heads.latitude_head.linear_pred_latitude.{key}"] *= 0.01
    return sd


def output_keys(cfg) -> set:
    """The keys of one image's result, as the JAX package emits them
    (perspectivefields_tpu/api.py:_package_results and ParamNetHead)."""
    keys = {"pred_gravity", "pred_latitude", "pred_gravity_original", "pred_latitude_original",
            "pred_latitude_original_mode"}
    if cfg.param_on:
        keys |= {"pred_roll", "pred_pitch", "pred_general_vfov", "pred_rel_cx", "pred_rel_cy",
                 "pred_rel_focal"}
        if cfg.param.name == "ParamNet":
            keys |= {"pred_vfov", "pred_rel_pp"} if cfg.recover_pp else {"pred_vfov"}
        else:
            keys |= {f"pred_{p}" for p in cfg.param.predict_params}
    return keys


def check_contract(pred: dict, hw, cfg) -> None:
    """One image's result against its version's contract: the key set, the
    shapes (class logits for classification heads), finite values, unit
    up-vectors (the invalid gravity bin decodes to the zero vector) and
    latitude in [-90, 90] degrees."""
    h, w = hw
    if set(pred) != output_keys(cfg):
        raise AssertionError(f"keys {sorted(pred)}, want {sorted(output_keys(cfg))}")
    shapes = {
        "pred_gravity": (320, 320, cfg.gravity.out_channels),
        "pred_latitude": (320, 320, cfg.latitude.out_channels),
        "pred_gravity_original": (h, w, 2), "pred_latitude_original": (h, w),
    }
    for key in pred.keys() - shapes.keys() - {"pred_latitude_original_mode"}:
        shapes[key] = (2,) if key == "pred_rel_pp" else ()
    for key, shape in shapes.items():
        if pred[key].shape != shape or not np.isfinite(pred[key]).all():
            raise AssertionError(f"{key}: shape {pred[key].shape} (want {shape}) or non-finite")
    if pred["pred_latitude_original_mode"] != "deg":
        raise AssertionError("pred_latitude_original_mode")
    norm = np.linalg.norm(pred["pred_gravity_original"], axis=-1)
    off = np.abs(norm - 1.0)
    if cfg.gravity.loss_type == "classification":
        off = off[norm > 0]
    if off.size and off.max() > 1e-3:
        raise AssertionError(f"gravity not unit norm: {off.max()}")
    lat = pred["pred_latitude_original"]
    if lat.min() < -90.0 or lat.max() > 90.0:
        raise AssertionError(f"latitude out of [-90, 90]: {lat.min()}, {lat.max()}")


# Each kernel module's one device kernel a bf16 launch, as the profiler names it
DEVICE_KERNELS = {"fused_attention": "attn_bf16", "stage1_attention": "stage1_bf16",
                  "mixffn": "mixffn_bf16", "convnext_block": "convnext_block_bf16",
                  "decoder_tail": "tail_bf16", "fused_block": "block_bf16"}


def device_kernel_counts(prof) -> dict:
    """How many times each kernel module's bf16 kernel ran on the card in a
    torch.profiler trace (kernels a CUDA graph replays included)."""
    by_kernel = {k: name for name, k in DEVICE_KERNELS.items()}
    counts = dict.fromkeys(KERNELS, 0)
    for e in prof.key_averages():
        kernel = re.search(r"(\w+)[<(]", e.key.split("::")[-1])
        if e.device_time_total > 0 and kernel and kernel.group(1) in by_kernel:
            counts[by_kernel[kernel.group(1)]] += e.count
    return counts


_captures_at_reset = 0


def _reset_counts() -> None:
    global _captures_at_reset
    for mod in KERNELS.values():
        mod.LAUNCHES = 0
    _captures_at_reset = graphed.COUNTS.captures


def _expected(path: str, forwards: int = 1) -> dict:
    """The launches of ``forwards`` forwards on ``path``, and of one more for
    each CUDA graph captured since the counters were reset: a capture runs
    the forward once, eager, before it records (``models.graphed``)."""
    forwards += graphed.COUNTS.captures - _captures_at_reset
    return {name: PATHS[path][1].get(name, 0) * forwards for name in KERNELS}


def slice_phase(sd, path: str) -> dict:
    """Drive one bf16 path (PATHS). Every count is set to 0 just before and
    read just after. The B=8 batches replay the forward's CUDA graph (two
    calls before the count run it eager and capture it) and the B=1 call
    runs eager: the kernels' launch counters, which a replay adds to from
    its capture's record, are held to the kernels the profiler sees run."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED)
    model = PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda",
                              **PATHS[path][0])
    if not model.use_kernels:
        raise AssertionError("the default bf16 CUDA model must use the attention kernels")
    log(f"[slice:{path}] host preprocess backend: {native.backend()}")
    batches = [rng.integers(0, 256, size=(8, 640, 640, 3), dtype=np.uint8) for _ in range(3)]
    single = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
    for _ in range(2):  # warm-up, before the count: B=8 runs eager, then is captured
        model.inference_batch(list(batches[0]))
    torch.cuda.synchronize()

    _reset_counts()
    replays = graphed.COUNTS.replays
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        preds = [p for batch in batches for p in model.inference_batch(list(batch))]
        preds.append(model.inference(single))
        torch.cuda.synchronize()
    launches = {name: mod.LAUNCHES for name, mod in KERNELS.items()}
    ran = device_kernel_counts(prof)
    forwards = len(batches) + 1
    want = _expected(path, forwards)
    log(f"[slice:{path}] {len(preds)} images in {forwards} forwards "
        f"({graphed.COUNTS.replays - replays} replayed): launches {launches}, on the card {ran}")
    if launches != want or ran != want:
        raise AssertionError(f"[slice:{path}] want launches {want}, got {launches}, ran {ran}")
    if graphed.COUNTS.replays - replays != len(batches):
        raise AssertionError(f"[slice:{path}] {graphed.COUNTS.replays - replays} replays, "
                             f"want {len(batches)}")
    for p in preds[:-1]:
        check_contract(p, (640, 640), model.cfg)
    check_contract(preds[-1], (480, 640), model.cfg)
    log(f"[slice:{path}] output contract ok; image 0: roll {float(preds[0]['pred_roll']):.4f} "
        f"pitch {float(preds[0]['pred_pitch']):.4f} vfov {float(preds[0]['pred_vfov']):.4f}")
    return launches


def tail_path_phase(sd, sd_cls) -> dict:
    """The tail path (PATHS["tail"]) in bf16 on the flagship's default model:
    3 forwards of 8 images, every count set to 0 just before and read just
    after. Then f32, for the flagship and PersNet-360Cities: each head's raw
    output through the kernel against the head's own plain-dataflow output
    (before the gravity normalise, which would amplify differences where
    random up-vectors nearly cancel)."""
    net = PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda").model
    xs = [net_input(8, SEED + 4 + i, torch.bfloat16) for i in range(3)]
    with torch.inference_mode():
        tail_forward(net, xs[0])  # warm-up, before the count
        torch.cuda.synchronize()
        _reset_counts()
        outs = [tail_forward(net, x) for x in xs]
        torch.cuda.synchronize()
    launches = {name: mod.LAUNCHES for name, mod in KERNELS.items()}
    want = _expected("tail", len(xs))
    log(f"[slice:tail] {len(xs)} forwards of 8 images: launches {launches}")
    if launches != want:
        raise AssertionError(f"[slice:tail] want launches {want}, got {launches}")
    for out in outs:
        for name, y in out.items():
            co = TAIL_COS[("flagship", name)]
            if y.shape != (8, 320, 320, co) or not torch.isfinite(y).all():
                raise AssertionError(f"[slice:tail] {name}: shape {tuple(y.shape)} or non-finite")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = net_input(4, SEED + 5, torch.float32)
    for version, state in ((VERSION, sd), (CLS_VERSION, sd_cls)):
        plain = PerspectiveFields(version, params=state, device="cuda", use_kernels=False).model
        with torch.inference_mode():
            got = tail_forward(plain, x)
            hl, ll = plain.backbone(x), plain.ll_enc(x)
            set_head_flags(plain, False)
            for name, head in plain.persformer_heads.items():
                ref = head(hl, ll)
                err = (got[name] - ref).abs()
                ok = bool((err <= F32_TOL + F32_TOL * ref.abs()).all())
                log(f"[f32] tail path {version} {name} (Co={ref.shape[-1]}) vs the head's plain "
                    f"dataflow: max|d|={err.max().item():.3e} (atol=rtol={F32_TOL}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"f32 tail path disagrees with {version} {name}")
    return launches


def heads_phase(sd, card: str) -> None:
    """The heads with JAX's three rewrites (the default) against their plain
    dataflow: raw f32 outputs within FIELD_TOL at B=2, then bf16 device times
    of each head (CUDA events, back-to-back calls, eager and replayed from a
    CUDA graph) at B=8 and B=32."""
    net = PerspectiveFields(VERSION, params=sd, device="cuda", use_kernels=False).model
    x = net_input(2, SEED + 6, torch.float32)
    with torch.inference_mode():
        hl, ll = net.backbone(x), net.ll_enc(x)
        for name, head in net.persformer_heads.items():
            fused = head(hl, ll)
            set_flags(head, False)
            plain = head(hl, ll)
            err = (fused - plain).abs()
            ok = bool((err <= FIELD_TOL + 1e-4 * plain.abs()).all())
            log(f"[f32] heads: {name} with fuse_embed/fuse_conv0/fuse_tail vs plain dataflow: "
                f"max|d|={err.max().item():.3e} (atol={FIELD_TOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"f32 {name}: the rewrites disagree with the plain dataflow")
    net = PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda").model
    for b in (8, 32):
        x = net_input(b, SEED + 7, torch.bfloat16)
        with torch.inference_mode():
            hl, ll = net.backbone(x), net.ll_enc(x)
            times = []
            for name, head in net.persformer_heads.items():
                for on in (True, False):
                    set_flags(head, on)
                    eager, graph = device_ms(lambda: head(hl, ll)), graph_ms(lambda: head(hl, ll))
                    times.append(f"{name} {'fused' if on else 'plain'} {eager:.3f} ms ({graph:.3f})")
                set_flags(head, True)
        log(f"[heads] bf16 B={b} ({card}), a call back to back (in a CUDA graph, without the host's "
            "launches): " + ", ".join(times))


def versions_phase() -> None:
    """The other four zoo versions in bf16 with seeded random weights: a
    batch of 4 640x640 images through inference_batch and one 480x640 image
    through inference, each against its own output contract, with the
    attention kernel's 25 launches per forward."""
    rng = np.random.default_rng(SEED + 8)
    batch = list(rng.integers(0, 256, size=(4, 640, 640, 3), dtype=np.uint8))
    single = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
    for version in OTHER_VERSIONS:
        cfg = model_zoo[version]["config"]
        model = PerspectiveFields(version, params=seeded_state_dict(cfg), compute_dtype="bfloat16",
                                  device="cuda")
        _reset_counts()
        preds = model.inference_batch(batch) + [model.inference(single)]
        torch.cuda.synchronize()
        launches = {name: mod.LAUNCHES for name, mod in KERNELS.items()}
        if launches != _expected("default", 2):
            raise AssertionError(f"[versions] {version}: launches {launches}")
        for p in preds[:-1]:
            check_contract(p, (640, 640), cfg)
        check_contract(preds[-1], (480, 640), cfg)
        params = {k[5:]: float(v) for k, v in sorted(preds[0].items())
                  if isinstance(v, np.ndarray) and v.ndim == 0}
        log(f"[versions] {version}: output contract ok (pred_gravity {preds[0]['pred_gravity'].shape}, "
            f"pred_latitude {preds[0]['pred_latitude'].shape}); image 0: "
            + (", ".join(f"{k} {v:.4f}" for k, v in params.items()) or "no camera parameters"))


def _compare(tag: str, got: list, want: list) -> None:
    worst = {}
    for g, w in zip(got, want):
        for key, wv in w.items():
            if key == "pred_latitude_original_mode":
                continue
            tol = FIELD_TOL if key in ("pred_gravity", "pred_latitude", "pred_gravity_original") else DEGREE_TOL
            d = np.abs(g[key] - wv)
            worst[key] = max(worst.get(key, 0.0), float(d.max()))
            if (d > tol + 1e-4 * np.abs(wv)).any():
                raise AssertionError(f"f32 {tag} path vs plain path, {key}: max|d| {d.max()} > {tol}")
    log(f"[f32] {tag} path vs plain path, max|d|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items())))


def f32_parity_phase(sd) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    imgs = list(np.random.default_rng(SEED + 1).integers(0, 256, size=(4, 640, 640, 3), dtype=np.uint8))
    plain = PerspectiveFields(VERSION, params=sd, device="cuda", use_kernels=False)
    _reset_counts()
    want = plain.inference_batch(imgs)
    if any(mod.LAUNCHES for mod in KERNELS.values()):
        raise AssertionError("the plain model launched a kernel")
    paths = {tag: PerspectiveFields(VERSION, params=sd, device="cuda", use_kernels=True,
                                    **PATHS[path][0])
             for tag, path in [("kernel", "default"), ("fused", "fused"), ("block", "block"),
                               ("all_fused", "all_fused")]}
    x = torch.from_numpy(
        native.preprocess_batch(np.stack(imgs), 320, 320, plain._pixel_mean, plain._pixel_std)
    ).cuda()
    for tag, model in paths.items():
        _reset_counts()
        got = model.inference_batch(imgs)
        counts = {name: mod.LAUNCHES for name, mod in KERNELS.items()}
        expect = _expected("default" if tag == "kernel" else tag)
        if counts != expect:
            raise AssertionError(f"f32 {tag} model launched {counts}, want {expect}")
        with torch.inference_mode():
            # the backbone's stage outputs, where the MiT paths meet first
            feats = zip(model.model.backbone(x), plain.model.backbone(x))
            log(f"[f32] {tag}: backbone stage outputs vs plain path, max|d|: "
                + ", ".join(f"{(a - b).abs().max().item():.2e}" for a, b in feats))
            # ParamNet's five raw outputs (the ConvNeXt head), each model on
            # its own fields
            raw = []
            for m in (model, plain):
                out = m.model(x)
                field = torch.cat([out["pred_gravity"], out["pred_latitude"]], dim=-1)
                raw.append(m.model.param_net.backbone(field))
            log(f"[f32] {tag}: ParamNet raw outputs vs plain path, max|d| per output: "
                + ", ".join(f"{v:.2e}" for v in (raw[0] - raw[1]).abs().amax(dim=0).tolist()))
        _compare(tag, got, want)


def throughput_phase(sd, card: str) -> None:
    rng = np.random.default_rng(SEED + 2)
    batch = list(rng.integers(0, 256, size=(32, 640, 640, 3), dtype=np.uint8))
    models = {
        "plain": PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda",
                                   use_kernels=False),
        "kernel": PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda"),
        "fused": PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda",
                                   **PATHS["fused"][0]),
        "block": PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda",
                                   **PATHS["block"][0]),
    }
    reps = 5
    rates = {k: [] for k in models}
    for name in ("plain", "kernel", "fused", "block", "block", "fused", "kernel", "plain"):
        m = models[name]
        for _ in range(2):  # a model's first window: its forward runs eager, then is captured
            m.inference_batch(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            m.inference_batch(batch)
        torch.cuda.synchronize()
        rates[name].append(32 * reps / (time.perf_counter() - t0))
    x = torch.from_numpy(native.preprocess_batch(
        np.stack(batch), 320, 320, models["kernel"]._pixel_mean, models["kernel"]._pixel_std,
    )).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        # two warm-up calls a route: its first sight runs eager, the second
        # captures its CUDA graph, and the timed calls replay it
        fwd = median_ms(lambda: models["kernel"].model(x), reps=5, warmup=2)
        set_head_flags(models["kernel"].model, False)
        plain_heads = median_ms(lambda: models["kernel"].model(x), reps=5, warmup=2)
        set_head_flags(models["kernel"].model, True)
    log(f"[throughput] kernel path device forward with the heads' plain dataflow: {plain_heads:.1f} ms "
        f"(with JAX's three head rewrites, the default: {fwd:.1f} ms; B=32 bf16, {card})")
    for name, m in models.items():
        log(f"[throughput] {name}: {', '.join(f'{r:.2f}' for r in rates[name])} img/s "
            f"(B=32 640x640 bf16, {card}; host preprocess {native.backend()}); "
            f"{split_line(inference_split(m, batch, reps))}")


class _SyncedModule:
    """A model's network behind a synchronize and a clock mark on each side
    of its call: one inference_batch call then splits into the host
    preprocess with the copy to the card, the device forward, and the
    postprocess with the copies back, all three timed in the same call."""

    def __init__(self, inner):
        self.inner, self.marks = inner, []

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        out = self.inner(*args, **kwargs)
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def inference_split(m, batch, reps: int) -> dict:
    """ms of each stage of ``m.inference_batch(batch)`` (any tree's
    PerspectiveFields: only its ``model`` attribute is wrapped) over
    ``reps`` calls, each stage's list of times: ``preprocess`` (entry to the
    network's call: host preprocess, staging, copy to the card, normalize),
    ``forward`` (the network, synchronized on both sides), ``postprocess``
    (postprocess, copies back, per-image numpy) and ``total``."""
    inner = m.model
    m.model = timed = _SyncedModule(inner)
    split = {"preprocess": [], "forward": [], "postprocess": [], "total": []}
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.inference_batch(batch)
            t3 = time.perf_counter()
            t1, t2 = timed.marks[-2:]
            for key, a, b in (("preprocess", t0, t1), ("forward", t1, t2),
                              ("postprocess", t2, t3), ("total", t0, t3)):
                split[key].append((b - a) * 1e3)
    finally:
        m.model = inner
    return split


def split_line(split: dict) -> str:
    return (f"split of {len(split['total'])} calls, mean (min-max) ms: " + " + ".join(
        f"{k} {statistics.mean(v):.2f} ({min(v):.2f}-{max(v):.2f})"
        for k, v in split.items() if k != "total")
        + f" = {statistics.mean(split['total']):.2f} ms a batch (synchronized at the network's call)")


def _serving_launch_check(tag: str, forwards: int) -> None:
    launches = {name: mod.LAUNCHES for name, mod in KERNELS.items()}
    if launches != _expected("default", forwards):
        raise AssertionError(f"[serving] {tag}: launches {launches}, want {_expected('default', forwards)}")


def _device_preprocess_check(sd, rng, card: str) -> None:
    """(a): device_preprocess=True on 8 640x640 images and one 480x640."""
    model = PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda",
                              device_preprocess=True)
    batch = list(rng.integers(0, 256, size=(8, 640, 640, 3), dtype=np.uint8))
    single = rng.integers(0, 256, size=(480, 640, 3), dtype=np.uint8)
    # the resize is elementwise f32: the global TF32 flags must not reach it
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    worst = 0.0
    for imgs in (np.stack(batch), single[None]):
        got = model._device_resize(*imgs.shape[1:3])(torch.from_numpy(imgs).cuda()).cpu().numpy()
        for im, g in zip(imgs, got):
            exact = native.pil_resize_uint8(im, 320, 320).astype(np.float32)
            worst = max(worst, float(np.abs(np.round(g) - exact).max()))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    log(f"[serving] device_preprocess: device resize (TF32 on) vs the host's bit-exact PIL "
        f"resize, max |round(x) - exact| = {worst:.0f} LSB (bound 1)")
    if worst > 1.0:
        raise AssertionError("device resize beyond 1 LSB of the host's exact resize")
    for _ in range(2):  # warm-up, before the count: B=8 runs eager, then is captured
        model.inference_batch(batch)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    preds = model.inference_batch(batch) + [model.inference(single)]
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    _serving_launch_check("device_preprocess", 2)
    for p in preds[:-1]:
        check_contract(p, (640, 640), model.cfg)
    check_contract(preds[-1], (480, 640), model.cfg)
    log(f"[serving] device_preprocess: 9 images in 2 forwards ({dt_s * 1e3:.1f} ms, {card}), "
        f"fused_attention {fa.LAUNCHES} launches, output contract ok; resize operands cached for "
        f"{sorted(model._resize_cache._d)}")


def _compare_serving(tag: str, got: list, want: list, tol) -> float:
    """Max |d| over every image and key of ``want`` (the keys must match);
    raises where |d| > tol(key, ref)."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if set(g) != set(w):
            raise AssertionError(f"[serving] {tag}: keys {sorted(g)}, want {sorted(w)}")
        for key, wv in w.items():
            if g[key].dtype != np.float32 or g[key].shape != wv.shape:
                raise AssertionError(f"[serving] {tag} {key}: {g[key].dtype} {g[key].shape}")
            d = np.abs(g[key] - wv)
            worst = max(worst, float(d.max()))
            if (d > tol(key, wv)).any():
                raise AssertionError(f"[serving] {tag} {key}: max|d| {d.max()} beyond its bound")
    return worst


def _batch_predictor_check(model, imgs, card: str) -> None:
    """(b): every wire / out_wire / select / depth combination against
    inference_batch on the same batches (the tail padded as the predictor
    pads it: the last image repeated)."""
    ref = []
    for i in range(0, len(imgs), SERVE_BATCH):
        chunk = imgs[i:i + SERVE_BATCH]
        ref += model.inference_batch(chunk + [chunk[-1]] * (SERVE_BATCH - len(chunk)))[:len(chunk)]
    raw = {k for k, v in ref[0].items() if not k.endswith(("_original", "_mode"))}
    ref = [{k: r[k] for k in raw} for r in ref]
    params = bench_serving.PARAM_KEYS
    forwards = -(-len(imgs) // SERVE_BATCH)
    base = {}  # wire -> its f32 readback of every key
    for wire in ("f32", "u8"):
        for out_wire in (None, "f16", "u8"):
            for select in (None, params):
                for depth in (1, 2):
                    bp = BatchPredictor(model, batch_size=SERVE_BATCH, wire=wire, select=select,
                                        depth=depth, out_wire=out_wire)
                    devices = set()
                    fwd = bp._fwd

                    def spy(x, fwd=fwd, devices=devices):
                        out = fwd(x)
                        devices.update([x.device.type] + [v.device.type for v in out.values()])
                        return out

                    bp._fwd = spy
                    torch.cuda.synchronize()
                    _reset_counts()
                    outs = bp.predict(imgs)
                    torch.cuda.synchronize()
                    tag = f"wire={wire} out_wire={out_wire} select={'params' if select else 'all'} depth={depth}"
                    _serving_launch_check(tag, forwards)
                    if devices != {"cuda"} or not bp._slots[0][0].is_pinned():
                        raise AssertionError(f"[serving] {tag}: forward on {devices}, or slot not pinned")
                    keys = set(select or raw)
                    if out_wire is None:
                        want = [{k: r[k] for k in keys} for r in ref]
                        if wire == "f32":  # the same inputs as inference_batch: equal
                            err = _compare_serving(tag, outs, want, lambda k, w: 0.0)
                        else:
                            err = _compare_serving(tag, outs, want,
                                                   lambda k, w: BF16_REL_TOL * np.abs(w).max())
                        if select is None and depth == 1:
                            base[wire] = outs
                        note = "vs inference_batch"
                    else:
                        want = [{k: b[k] for k in keys} for b in base[wire]]

                        def tol(k, w):
                            unit = out_wire == "u8" and k in ("pred_gravity", "pred_latitude")
                            return U8_WIRE_TOL if unit else F16_WIRE_TOL * np.maximum(1.0, np.abs(w))

                        err = _compare_serving(tag, outs, want, tol)
                        note = f"vs the {wire} wire's f32 readback"
                    stages = bp.timer.summary()
                    log(f"[serving] BatchPredictor {tag}: {len(outs)} images, {forwards} batches, "
                        f"fused_attention {fa.LAUNCHES}, max|d| {note} {err:.3e}; device_wait "
                        f"{stages['device_wait']['seconds']:.4f} s ({card})")


def serving_phase(sd, card: str) -> None:
    rng = np.random.default_rng(SEED + 9)
    _device_preprocess_check(sd, rng, card)
    model = PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda")
    imgs = list(rng.integers(0, 256, size=(SERVE_IMAGES, 640, 640, 3), dtype=np.uint8))
    _batch_predictor_check(model, imgs, card)
    # (c) bench_serving's modes, on this model and these images
    link = bench_serving.link_probe()
    log(f"[serving] link ({card}): " + ", ".join(f"{k} {v:.1f}" for k, v in link.items()))
    timed = imgs[:2 * SERVE_BATCH] + imgs[:2 * SERVE_BATCH]
    for depth in (1, 2):
        for name, (wire, select, out_wire) in bench_serving.MODES.items():
            r = bench_serving.run_mode(model, timed, SERVE_BATCH, wire, select,
                                       imgs[:SERVE_BATCH], depth, out_wire)
            split = ", ".join(f"{k} {v['seconds']:.4f} s" for k, v in r["stages"].items())
            log(f"[serving] bench {name} depth {depth}: {r['images_per_sec']:.2f} img/s "
                f"({r['images']} images, B={SERVE_BATCH}, {card}; host preprocess "
                f"{native.backend()}, {native.num_threads()} threads); {split}")


def _launch_counts() -> dict:
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}


def _data_on_card_check() -> None:
    """(a) a synthetic batch rendered on the card against the same cameras
    rendered on the CPU, and crop_distortion on the card against the CPU."""
    gen = pdata.make_batch_generator(320, 320)
    pano_cpu = pdata.synthetic_pano(pdata.seeded_generator(SEED, 0), device="cpu")
    t0 = time.perf_counter()
    got = gen(pdata.seeded_generator(SEED, 1, 0), pano_cpu.cuda(), TRAIN_BATCH)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = pdata.render_batch({k: v.cpu() for k, v in got["cams"].items()}, pano_cpu, 320, 320)
    worst = {}
    for key, tol in (("image", 255e-3), ("gt_gravity", 1e-3), ("gt_latitude", 1e-5),
                     ("gt_params", 1e-5)):
        worst[key] = (got[key].cpu() - want[key]).abs().max().item()
        if worst[key] > tol:
            raise AssertionError(f"[train] batch on the card vs CPU, {key}: {worst[key]} > {tol}")
    # the up field's direction is ill-conditioned at pixels next to a VVP
    # that falls inside the crop (an ulp of the VVP over the distance to it)
    up_err = (got["gt_gravity"].cpu() - want["gt_gravity"]).abs().amax(dim=-1)
    up_share = (up_err <= 1e-5).float().mean().item()
    if up_share < 0.999:
        raise AssertionError(f"[train] up field on the card vs CPU: {up_share} within 1e-5")
    log(f"[train] B={TRAIN_BATCH} 320^2 batch rendered on the card in {ms:.1f} ms (first call); "
        "vs the same cameras on the CPU, max|d|: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f"; {up_share * 100:.3f}% of up-field pixels within 1e-5")
    # the USM up field differentiates a float32 round trip (theta -> pixel
    # -> theta); near the pole's image it is ill-conditioned, so each
    # device is held against a float64 evaluation as well
    up = {dev: crop_distortion(pano_cpu.to(dev), 150.0, 0.5, 320, 320, 30.0, 20.0, -10.0)["up"].cpu()
          for dev in ("cuda", "cpu")}
    ref = crop_distortion(pano_cpu.double(), 150.0, 0.5, 320, 320, 30.0, 20.0, -10.0)["up"]
    err = (up["cuda"] - up["cpu"]).abs().amax(dim=-1)
    share = (err <= 1e-5).float().mean().item()
    off = {dev: (u.double() - ref).abs().max().item() for dev, u in up.items()}
    log(f"[train] crop_distortion up field (320^2, f 150, xi 0.5) on the card vs CPU: max|d| "
        f"{err.max().item():.2e}, {share * 100:.2f}% of pixels within 1e-5; vs float64: card "
        f"{off['cuda']:.2e}, CPU {off['cpu']:.2e}")
    if share < 0.99 or off["cuda"] > max(2 * off["cpu"], 1e-4):
        raise AssertionError("[train] crop_distortion's up field on the card is off the CPU's")


def _train_run(cfg, batch, remat: bool, card: str) -> tuple:
    """TRAIN_STEPS AdamW steps of the full-width trainer on one batch; the
    losses (finite, falling), the first step's gradients (finite and not
    zero), no kernel launch, img/s and peak memory."""
    model = tool_train.build_model(cfg, "cuda", remat=remat, seed=SEED)
    state = create_train_state(model, learning_rate=1e-4)
    step = make_train_step(cfg, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state, m = step(state, batch)
    bad = [n for n, p in model.named_parameters()
           if not torch.isfinite(p.grad).all() or not p.grad.any()]
    if bad:
        raise AssertionError(f"[train] parameters with no finite non-zero gradient: {bad}")
    losses = [m["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - 1):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    rate = TRAIN_BATCH * (TRAIN_STEPS - 1) / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(_launch_counts().values()):
        raise AssertionError(f"[train] a kernel launched during training: {_launch_counts()}")
    losses = torch.stack(losses).tolist()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[train] remat={remat}: losses {losses}")
    log(f"[train] full width B={TRAIN_BATCH} 320^2 bf16 autocast, remat {'on' if remat else 'off'}: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} in {TRAIN_STEPS} steps, {rate:.2f} img/s "
        f"(steps 2-{TRAIN_STEPS}), peak memory {peak:.2f} GiB, every gradient finite and non-zero "
        f"({len(list(model.parameters()))} parameters), no kernel launch ({card})")
    return state, step


def train_repeats_main(n: int) -> int:
    """Phase 8's training run (remat on), ``n`` times from the same seed on
    the same batch."""
    probe()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = tool_train.model_config(False, 320)
    mean = torch.tensor(cfg.pixel_mean, device="cuda")
    batch = pdata.make_step_batch_fn(SEED + 3, TRAIN_BATCH, (320, 320), device="cuda")(0)
    batch = {k: v for k, v in dict(batch, image=batch["image"] - mean).items() if k != "cams"}
    first_grad = None
    for run in range(n):
        model = tool_train.build_model(cfg, "cuda", remat=True, seed=SEED)
        state = create_train_state(model, learning_rate=1e-4)
        step = make_train_step(cfg, compute_dtype=torch.bfloat16)
        losses, parts = [], []
        for i in range(TRAIN_STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if i < 2:
                parts.append(", ".join(f"{k} {float(v):.4f}" for k, v in m.items() if k != "loss"))
            if i == 0:
                grad = torch.cat([p.grad.flatten() for p in model.parameters()])
                first_grad = grad if first_grad is None else first_grad
                flips = int(((grad > 0) != (first_grad > 0)).sum())
        log(f"[repeat] run {run}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({'falls' if losses[-1] < losses[0] else 'does not fall'}); step 1 gradients of "
            f"{grad.numel()} differing in sign from run 0's: {flips}; losses "
            + " ".join(f"{x:.3f}" for x in losses))
        log(f"[repeat] run {run}: step 1 terms {parts[0]}; step 2 terms {parts[1]}")
        del model, state, step, grad
        torch.cuda.empty_cache()
    return 0


def _checkpoint_check(cfg, state, step, batch, tmp: Path) -> None:
    """(c) save twice (keep=2), corrupt the newest, restore the older with a
    warning; one more step from it gives the loss of the run without the
    save."""
    import warnings

    first = save_train_state(state, str(tmp))
    n = state.step
    state, m = step(state, batch)
    want = m["loss"].item()
    newest = save_train_state(state, str(tmp))
    Path(newest, "state.pt").write_bytes(b"not a checkpoint")
    template = create_train_state(tool_train.build_model(cfg, "cuda", remat=False, seed=SEED + 1))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        restored = restore_train_state(str(tmp), template)
    if restored.step != n or not any("unusable" in str(w.message) for w in caught):
        raise AssertionError(f"[train] restore gave step {restored.step} (want {n}) or no warning")
    _, m = step(restored, batch)
    got = m["loss"].item()
    if abs(got - want) > 1e-6 * abs(want):
        raise AssertionError(f"[train] loss after restore {got}, without the save {want}")
    log(f"[train] checkpoint: saved {Path(first).name} and {Path(newest).name}, corrupted the "
        f"newest, restored step {n} with a warning; the next step's loss {got:.6f} "
        f"(without the save {want:.6f})")


def _entry_points_check(tmp: Path, card: str) -> None:
    """The trainer and evaluator as a user runs them (python -m ...), at
    full width: 2 steps with a checkpoint, a resume to 4, then an evaluation
    of the flagship version."""
    ckpt, out = tmp / "cli", tmp / "cli.npz"
    common = ["--batch", str(TRAIN_BATCH), "--chunk", "2", "--ckpt-dir", str(ckpt),
              "--ckpt-every", "2"]
    tool_train.main(["--steps", "2", *common])
    state = tool_train.main(["--steps", "4", "--out", str(out), *common])
    if state.step != 4 or not out.exists():
        raise AssertionError("[train] tools.train did not resume to step 4 and save")
    res = tool_evaluate.main(["--samples", "32", "--batch", str(TRAIN_BATCH)])
    if res["samples"] != 32 or not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"[train] tools.evaluate: {res}")
    log(f"[train] tools.train (2 steps, resumed to 4, saved {out.name}) and tools.evaluate "
        f"(32 crops) at full width ran ({card})")


def _eval_metrics(model, tag: str, card: str) -> dict:
    it = pdata.data_iterator(SEED + 5, batch_size=TRAIN_BATCH, im_hw=(320, 320), device="cuda")
    batches = [next(it) for _ in range(EVAL_IMAGES // TRAIN_BATCH)]
    for _ in range(2):  # warm-up: the batch's forward runs eager, then is captured
        evaluate_pairs(model, batches[:1])
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = evaluate_pairs(model, batches, max_samples=EVAL_IMAGES)
    rate = EVAL_IMAGES / (time.perf_counter() - t0)
    res["launches"] = _launch_counts()
    log(f"[eval] {tag}: {rate:.2f} img/s over {res['samples']} crops ({card}); "
        + ", ".join(f"{k} {v:.4f}" for k, v in res.items() if isinstance(v, float))
        + f"; launches {res['launches']}")
    return res


def _compare_metrics(tag: str, a: dict, b: dict, tol: float) -> None:
    keys = [k for k, v in a.items() if isinstance(v, float)]
    diff = {k: abs(a[k] - b[k]) for k in keys}
    log(f"[eval] {tag}: max|d| {max(diff.values()):.2e} degrees (bound {tol}); "
        + ", ".join(f"{k} {v:.2e}" for k, v in diff.items()))
    if max(diff.values()) > tol:
        raise AssertionError(f"[eval] {tag}: {diff}")


def _evaluation_check(sd, card: str) -> None:
    """(d) evaluate_pairs on the flagship: bf16 on the default kernel route
    against bf16 without kernels, f32 with the kernels against f32 without."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}
    for dtype in ("bfloat16", "float32"):
        for kernels_on in (True, False):
            m = PerspectiveFields(VERSION, params=sd, compute_dtype=dtype, device="cuda",
                                  use_kernels=kernels_on)
            tag = f"{dtype} {'kernel route' if kernels_on else 'no kernels'}"
            res[dtype, kernels_on] = r = _eval_metrics(m, tag, card)
            want = (_expected("default", EVAL_IMAGES // TRAIN_BATCH)["fused_attention"]
                    if kernels_on else 0)
            if r["launches"] != {**{k: 0 for k in KERNELS}, "fused_attention": want}:
                raise AssertionError(f"[eval] {tag}: launches {r['launches']}, want {want}")
    _compare_metrics("bf16 kernel route vs bf16 without kernels", res["bfloat16", True],
                     res["bfloat16", False], EVAL_BF16_TOL)
    _compare_metrics("f32 kernel route vs f32 without kernels", res["float32", True],
                     res["float32", False], EVAL_F32_TOL)


def train_eval_phase(sd, card: str) -> None:
    """Phase 8: the training and evaluation path on the card."""
    import tempfile

    t0 = time.perf_counter()
    _data_on_card_check()
    log(f"[train] (a) data checks at {time.perf_counter() - t0:.1f} s")
    cfg = tool_train.model_config(False, 320)
    mean = torch.tensor(cfg.pixel_mean, device="cuda")
    batch = pdata.make_step_batch_fn(SEED + 3, TRAIN_BATCH, (320, 320), device="cuda")(0)
    batch = {k: v for k, v in dict(batch, image=batch["image"] - mean).items() if k != "cams"}
    _train_run(cfg, batch, remat=True, card=card)
    state, step = _train_run(cfg, batch, remat=False, card=card)
    kernel_model = init_random_(PersNet(cfg, use_kernels=True), seed=SEED).cuda()
    try:
        make_train_step(cfg, compute_dtype=torch.bfloat16)(create_train_state(kernel_model), batch)
    except RuntimeError as exc:
        if "inference-only" not in str(exc):
            raise
        log(f"[train] a step of a model built with use_kernels=True raises: {exc}")
    else:
        raise AssertionError("[train] a training step through the kernels did not raise")
    del kernel_model
    log(f"[train] (b) training runs at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        _checkpoint_check(cfg, state, step, batch, Path(tmp) / "ckpt")
        del state, step
        torch.cuda.empty_cache()
        log(f"[train] (c) checkpoint at {time.perf_counter() - t0:.1f} s")
        _entry_points_check(Path(tmp), card)
        log(f"[train] entry points at {time.perf_counter() - t0:.1f} s")
    _evaluation_check(sd, card)
    log(f"[train] phase 8 in {time.perf_counter() - t0:.1f} s")


def _learning_check(card: str) -> None:
    """(a) the learning proof at its defaults, PROOF_STEPS steps."""
    res = learning_proof.main(["--steps", str(PROOF_STEPS), "--smoke"])
    before, after = res["before"]["up_mean_deg"], res["after"]["up_mean_deg"]
    log(f"[proof] {res['steps']} steps B={res['batch']} {res['size']}^2: held-out up error "
        f"{before:.2f} -> {after:.2f} deg ({before / after:.2f}x), latitude "
        f"{res['before']['lat_mean_deg']:.2f} -> {res['after']['lat_mean_deg']:.2f} deg, loss "
        f"{res['loss_first']:.4f} -> {res['loss_last']:.4f}, {res['images_per_sec']:.1f} img/s "
        f"({res['train_seconds']} s; {card})")
    if not after * PROOF_MIN_FALL <= before:
        raise AssertionError(f"[proof] up error fell {before / after:.2f}x, want >= {PROOF_MIN_FALL}")


def _converter_check(sd, tmp: Path) -> None:
    """(b) a released-format .pth -> .npz (and its sanity forward) -> the
    same bf16 outputs as the state dict; the .npz -> .pth export loads
    strictly and equals the state dict."""
    pth = tmp / Path(model_zoo[VERSION]["weights_url"]).name
    torch.save({"model": sd}, pth)
    npz = convert_checkpoint.convert_one(VERSION, str(pth), str(tmp), "cuda")
    imgs = list(np.random.default_rng(SEED + 11).integers(0, 256, size=(4, 640, 640, 3), dtype=np.uint8))
    got = PerspectiveFields(VERSION, params=npz, compute_dtype="bfloat16", device="cuda").inference_batch(imgs)
    want = PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda").inference_batch(imgs)
    for g, w in zip(got, want, strict=True):
        bad = [k for k in w if k != "pred_latitude_original_mode" and not np.array_equal(g[k], w[k])]
        if bad or set(g) != set(w):
            raise AssertionError(f"[convert] outputs from the .npz differ: {bad}")
    exported = export_torch.export(npz, str(tmp / "export.pth"))
    net = PersNet(model_zoo[VERSION]["config"])
    net.load_state_dict(torch.load(tmp / "export.pth", weights_only=True)["model"], strict=True)
    off = max((exported[k] - sd[k].float()).abs().max().item() for k in sd)
    if off != 0.0:
        raise AssertionError(f"[convert] exported tensors differ from the state dict by {off}")
    log(f"[convert] {pth.name} -> {Path(npz).name} -> export.pth ({len(exported)} tensors, strict "
        f"load, equal); bf16 outputs of the .npz model bit-equal to the state dict's on 4 images")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_step_check(tmp: Path, solo: dict, solo_s: float, n_model: int, card: str) -> None:
    """Two gloo ranks on cuda:0, data=2 (n_model 1) or data=1 x model=2 (the
    ruled Linears split), one step of the trainer's model against the one
    process's (``solo``, saved under ``tmp``)."""
    t1 = time.perf_counter()
    ranks = dryrun.launch(2, n_model, 1, out_dir=str(tmp), timeout=300, device="cuda", config="trainer")
    t2 = time.perf_counter()
    ref = solo["train_losses"][0]
    loss_d = max(abs(r["train_losses"][0] - ref) for r in ranks)
    a, b = (torch.load(tmp / f"{role}.pt", weights_only=True) for role in ("solo", "mp"))
    # after one step Adam's first moment is (1 - beta1) * the clipped gradient
    grads = {k: (a["exp_avg"][k] / 0.1, b["exp_avg"][k] / 0.1) for k in a["exp_avg"]}
    grad_d = max((ga - gb).abs().max().item() for ga, gb in grads.values())
    param_all = max((a["params"][k] - b["params"][k]).abs().max().item() for k in a["params"])
    beyond = sum(int(((a["params"][k] - b["params"][k]).abs() > DP_PARAM_TOL).sum()) for k in grads)
    param_d = max(((a["params"][k] - b["params"][k]).abs() * (ga.abs() > DP_GRAD_TOL)).max().item()
                  for k, (ga, _) in grads.items())
    layout = ("with 8 rows each" if n_model == 1
              else "as data=1 x model=2 (the ruled Linears and their AdamW state split)")
    log(f"[parallel] one train step of the trainer's full-width model (f32, TF32 off, remat): "
        f"2 gloo ranks on cuda:0 {layout} vs one process at B=16: loss {ref:.6f}, "
        f"max|d| loss {loss_d:.2e} (bound {DP_LOSS_RTOL:.0e} relative), clipped gradients "
        f"{grad_d:.2e} (bound {DP_GRAD_TOL:.0e}), parameters where |g| > {DP_GRAD_TOL:.0e} "
        f"{param_d:.2e} (bound {DP_PARAM_TOL:.0e}), all parameters {param_all:.2e} ({beyond} of "
        f"{sum(v.numel() for v in a['params'].values())} elements beyond {DP_PARAM_TOL:.0e}); one "
        f"process {solo_s:.1f} s, two ranks {t2 - t1:.1f} s ({card})")
    if loss_d > DP_LOSS_RTOL * max(1.0, abs(ref)) or grad_d > DP_GRAD_TOL or param_d > DP_PARAM_TOL:
        raise AssertionError(f"[parallel] the {layout} step is not the one-process step")
    if n_model == 1:
        return
    gib = 2**-30
    log(f"[parallel] model=2: AdamW elements a moment per rank "
        + ", ".join(f"{r['adam_elements']:,}" for r in ranks)
        + f" (param_shardings: {ranks[0]['expected_adam_elements']:,}; one process "
        f"{solo['adam_elements']:,}); peak device memory per rank "
        + ", ".join(f"{r['peak_memory_bytes'] * gib:.2f}" for r in ranks)
        + f" GiB (one process {solo['peak_memory_bytes'] * gib:.2f} GiB); replicated parameters "
        f"bit-equal across the model group: {[r['replicated_bit_equal'] for r in ranks]}")
    if not all(r["replicated_bit_equal"] for r in ranks) or any(
            r["adam_elements"] != r["expected_adam_elements"] for r in ranks):
        raise AssertionError("[parallel] model=2: replicated parameters differ across the model "
                             "group, or a rank's AdamW state is not its shards'")


def _parallel_check(sd, tmp: Path, card: str) -> None:
    """(c) NCCL at world size 1; two gloo ranks on cuda:0 against one
    process; inference_batch's split over two replicas on cuda:0."""
    import torch.distributed as dist

    parallel.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    t = torch.arange(4.0, device="cuda")
    dist.all_reduce(t)
    if dist.get_backend() != "nccl" or t.tolist() != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError(f"[parallel] NCCL world 1: {dist.get_backend()}, {t.tolist()}")
    dist.destroy_process_group()
    log("[parallel] init_distributed: NCCL at world size 1, all-reduce ok")

    t0 = time.perf_counter()
    solo = dryrun.run("solo", "", 0, 1, 1, 1, "cuda", str(tmp), "trainer")
    solo_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for n_model in (1, 2):
        _mesh_step_check(tmp, solo, solo_s, n_model, card)
        torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 12)
    imgs = list(rng.integers(0, 256, size=(SPLIT_IMAGES, 640, 640, 3), dtype=np.uint8))
    model = PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda")
    raw = [k for k in model.inference(imgs[0]) if not k.endswith(("_original", "_mode"))]
    half = SPLIT_IMAGES // 2
    rows = model.inference_batch(imgs[:half]) + model.inference_batch(imgs[half:])
    whole = model.inference_batch(imgs)
    model.replica_devices = [torch.device("cuda", 0)] * 2
    model.inference_batch(imgs[:2])  # warm-up: the second replica is made
    if set(model._replicas) != {1}:  # the first is the model itself, on its own cuda:0
        raise AssertionError(f"[parallel] replicas copied for slots {sorted(model._replicas)}, want [1]")
    torch.cuda.synchronize()
    _reset_counts()
    got = model.inference_batch(imgs)
    torch.cuda.synchronize()
    launches = _launch_counts()
    if launches != _expected("default", 2):
        raise AssertionError(f"[parallel] split over 2 replicas: launches {launches}, want 25 each")
    got_raw = [{k: g[k] for k in raw} for g in got]
    _compare_serving("split over 2 replicas", got_raw, [{k: w[k] for k in raw} for w in rows],
                     lambda k, w: 0.0)
    far = {k: max(float(np.abs(g[k] - w[k]).max()) for g, w in zip(got_raw, whole)) for k in raw}
    log(f"[parallel] inference_batch of {SPLIT_IMAGES} images split over 2 replicas on cuda:0: "
        f"bit-equal to the single path on each replica's {half} rows; launches {launches}; vs the "
        f"single path on all {SPLIT_IMAGES} rows at once, max|d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in far.items()))


def _demo_check(sd, tmp: Path, card: str) -> None:
    """(d) the demo's inference on its synthetic image; the drawings where
    cv2 and matplotlib import."""
    img = demo.load_image_bgr(None)
    model = PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda")
    _reset_counts()
    pred = model.inference(img)
    torch.cuda.synchronize()
    if _launch_counts() != _expected("default"):
        raise AssertionError(f"[demo] launches {_launch_counts()}")
    params = demo.camera_params(pred)
    if not all(np.isfinite(list(params.values()))):
        raise AssertionError(f"[demo] camera parameters {params}")
    log("[demo] " + ", ".join(f"{k}: {v:.2f}" for k, v in params.items())
        + f" (seeded random weights, {img.shape[0]}x{img.shape[1]} synthetic image, {card})")
    try:
        import cv2  # noqa: F401
        import matplotlib  # noqa: F401
    except ImportError as exc:
        log(f"[demo] drawing is held on the CPU only: {exc}")
        return
    paths = demo.draw(img, pred, str(tmp / "demo"))
    log(f"[demo] wrote {', '.join(Path(p).name for p in paths)}")


def parallel_demo_phase(sd, card: str) -> None:
    """Phase 9: the learning proof, the converters, parallel, the demo."""
    import tempfile

    t0 = time.perf_counter()
    _learning_check(card)
    log(f"[phase9] (a) learning proof at {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        _converter_check(sd, Path(tmp))
        log(f"[phase9] (b) converters at {time.perf_counter() - t0:.1f} s")
        _parallel_check(sd, Path(tmp), card)
        log(f"[phase9] (c) parallel at {time.perf_counter() - t0:.1f} s")
        _demo_check(sd, Path(tmp), card)
    log(f"[phase9] (d) demo; phase 9 in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    card = probe()
    build_phase()
    sd = seeded_state_dict(model_zoo[VERSION]["config"])
    sd_cls = seeded_state_dict(model_zoo[CLS_VERSION]["config"])
    kstats = kernel_phase(sd, sd_cls)
    launches = {path: slice_phase(sd, path) for path in ("default", "fused", "block")}
    launches["tail"] = tail_path_phase(sd, sd_cls)
    f32_parity_phase(sd)
    heads_phase(sd, card)
    throughput_phase(sd, card)
    versions_phase()
    serving_phase(sd, card)
    train_eval_phase(sd, card)
    parallel_demo_phase(sd, card)
    log(card_line())
    kernels = []
    for name, stats in kstats.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"perspectivefields_tpu_torch/csrc/{name}.cu",
            "replaces": roofline.flagship()[name][0],
            "launches": launches[LAUNCH_PATH[name]][name],
            **stats,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# csrc/*.cu's PF_STAMP ids: (id, name); PF_STAMP_STEP(i, j) is i + 10 j
PHASE_NAMES = {
    "fused_attention": {0: "start", 1: "x", 90: "heads done", 91: "gather of o",
                        **{i + 10 * j: f"{name} {j}" for j in range(8) for i, name in (
                            (2, "q (head start)"), (3, "K/V staged"), (4, "logits"), (5, "softmax"),
                            (9, "P.V issued"), (6, "P.V"), (7, "out projection tile"))}},
    "mixffn": {0: "start", 1: "x", 2: "fc1(0) and mask", 96: "drain", 97: "partials written",
               **{i + 10 * j: f"{name} {j}" for j in range(8) for i, name in (
                   (3, "fc1 issue"), (4, "taps"), (6, "fc2 issue"), (5, "mask"))}},
    "stage1_attention": {0: "start", 1: "weights and kv_in", 2: "K/V",
                         **{i + 10 * j: f"{name} {j}" for j in range(8) for i, name in (
                             (3, "x arrived"), (4, "q"), (5, "logits"), (6, "softmax"),
                             (7, "P.V"), (8, "out stored"))}},
    "decoder_tail": {0: "start", **{i + 10 * j: f"{name} {j}" for j in range(8) for i, name in (
        (2, "conv0"), (3, "c0 stored"), (4, "upsample"), (5, "conv1 + 1x1"))}},
}


def _bf16(tensors):
    return [t.to(torch.bfloat16) for t in tensors]


def _tail_inputs(rng, b, co):
    """a and ll at the heads' widths on the flagship's 160x160 grid, and a
    tail's weights, bf16 (random: for timing)."""
    return _bf16([_randn(rng, b, TAIL_HW, TAIL_HW, 256), _randn(rng, b, TAIL_HW, TAIL_HW, 64),
                  *_tail_weights(rng, 320, co)])


def phases_main() -> int:
    """Per-phase clock64() counts of the bf16 attention, MixFFN, stage-1
    attention and decoder-tail kernels, then each launch's device time from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    probe()
    device = torch.device("cuda")
    libs = {name: kbuild.library(name, mod._SIGNATURES, ("PF_PHASES",))
            for name, mod in (("fused_attention", fa), ("mixffn", mf), ("stage1_attention", s1),
                              ("decoder_tail", dt))}
    for lib in libs.values():
        lib.pf_read_clk.argtypes = [ctypes.c_void_p]
    calls = {}
    for stage, (n, c, heads, _) in STAGES.items():
        a = _bf16(_attn_inputs(np.random.default_rng(stage), 8, n, 100, c))
        p = fa.launch_plan(8, n, c, heads, 100, device)
        calls[f"fused_attention stage {stage} (cluster {p['cluster']} split {p['split']})"] = (
            "fused_attention", lambda lib, a=a, h=heads, p=p: fa.launch(
                *a, h, 0.125, None, p["cluster"], p["split"], p["stages"], lib=lib))
    for stage, (hw, c, _) in FFN_STAGES.items():
        a = _bf16(_ffn_inputs(np.random.default_rng(stage), 8, hw, hw, c))
        p = mf.launch_plan(8, hw, hw, c, device)
        th, tw = p["tile"]
        calls[f"mixffn stage {stage} (tile {th}x{tw} cluster {p['cluster']} split {p['split']})"] = (
            "mixffn", lambda lib, a=a, p=p: mf.launch(
                *a, *p["tile"], p["cluster"], p["split"], p["stages"], lib=lib))
    n1, m1, _ = STAGE1
    a = _bf16(_attn_inputs(np.random.default_rng(1), 8, n1, m1, 64))
    p = s1.launch_plan(8, n1, device)
    calls[f"stage1_attention stage 1 ({p['blocks_per_image']} blocks an image)"] = (
        "stage1_attention", lambda lib, a=a, p=p: s1.launch(
            *a, 0.125, None, p["blocks_per_image"], lib=lib))
    a = _tail_inputs(np.random.default_rng(2), 8, 2)
    p = dt.launch_plan(8, TAIL_HW, TAIL_HW, 256, 64, 2, device)
    calls[f"decoder_tail Co=2 (tile {p['tile'][0]}x{p['tile'][1]} cluster {p['cluster']})"] = (
        "decoder_tail", lambda lib, a=a, p=p: dt.launch(
            *a, *p["tile"], p["cluster"], p["blocks"], p["stages"], lib=lib))
    log(f"[clk] {torch.cuda.get_device_name(0)} ({card_line()}); cycles of thread 0 of block 0, "
        "second of two calls, each phase since the one before")
    buf = np.zeros(256, np.int64)
    for tag, (name, call) in calls.items():
        for _ in range(2):  # the first call's stamps are cleared by the read
            call(libs[name])
            torch.cuda.synchronize()
            err = libs[name].pf_read_clk(buf.ctypes.data)
            if err:
                raise RuntimeError(f"reading the stamps failed ({err})")
        seen = sorted((int(buf[i]), PHASE_NAMES[name].get(i, str(i))) for i in range(256) if buf[i])
        parts = [f"{nm} {t - prev}" for (prev, _), (t, nm) in zip(seen, seen[1:])]
        log(f"[clk] {tag}: {seen[-1][0] - seen[0][0]} cycles from {seen[0][1]}: " + ", ".join(parts))
    for tag, (name, call) in calls.items():
        for _ in range(3):
            call(None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call(None)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total > 0:
                kernel = re.search(r"(\w+)[<(]", e.key.split("::")[-1])
                log(f"[prof] {tag}: {kernel.group(1) if kernel else e.key[:40]} "
                    f"{e.device_time_total / e.count:.2f} us a call")
    return 0


def _import_root(root: str) -> str:
    """Make ``import perspectivefields_tpu_torch`` load the package under
    ``root`` (this checkout's modules are dropped); returns root resolved."""
    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.startswith("perspectivefields_tpu_torch")]:
        del sys.modules[name]
    pkg = importlib.import_module("perspectivefields_tpu_torch")
    if not pkg.__file__.startswith(root):
        raise RuntimeError(f"imported {pkg.__file__}, not the package under {root}")
    return root


def split_main(root: str) -> int:
    """inference_batch of the package under ``root`` on the flagship's
    default bf16 path at B=32: img/s in two windows of 10 calls, the split
    of 10 calls (``inference_split``), and the pinned host memory that
    PyTorch's caching host allocator holds while the results of 8 calls are
    kept (``torch.cuda.host_memory_stats``)."""
    card = probe()
    sd = seeded_state_dict(model_zoo[VERSION]["config"])
    root = _import_root(root)
    pf = importlib.import_module("perspectivefields_tpu_torch").PerspectiveFields
    m = pf(VERSION, params=sd, compute_dtype="bfloat16", device="cuda")
    batch = list(np.random.default_rng(SEED + 2).integers(0, 256, size=(32, 640, 640, 3), dtype=np.uint8))
    reps = 10
    for _ in range(2):
        m.inference_batch(batch)
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            m.inference_batch(batch)
        rates.append(32 * reps / (time.perf_counter() - t0))
    log(f"[split] {root} ({card}): inference_batch kernel path {', '.join(f'{r:.2f}' for r in rates)} "
        f"img/s (B=32 640x640 bf16, {reps} calls a window); {split_line(inference_split(m, batch, reps))}")
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        log(f"[split] {root}: torch {torch.__version__} has no torch.cuda.host_memory_stats")
        return 0
    kept = []
    for calls in range(1, 9):
        kept.append(m.inference_batch(batch))
        if calls in (1, 2, 4, 8):
            st = stats()
            log(f"[split] {root}: results of {calls} calls kept, pinned host memory held by "
                f"the allocator {st.get('allocated_bytes.current', 0) / 2**20:.1f} MiB ({card})")
    return 0


def host_probe_main(root: str) -> int:
    """The host's cost of one call of the bf16 attention, MixFFN, stage-1
    attention and decoder-tail wrappers of the package under ``root``
    (B=8, the flagship's shapes): the wall time of issuing 200 calls back
    to back (the card still busy with the earlier ones, so the host never
    waits on it), beside the device time per call back to back and from a
    CUDA graph."""
    probe()
    root = _import_root(root)
    pfa = importlib.import_module("perspectivefields_tpu_torch.kernels.fused_attention")
    pmf = importlib.import_module("perspectivefields_tpu_torch.kernels.mixffn")
    ps1 = importlib.import_module("perspectivefields_tpu_torch.kernels.stage1_attention")
    pdt = importlib.import_module("perspectivefields_tpu_torch.kernels.decoder_tail")
    cases = []
    for stage, (n, c, heads, _) in STAGES.items():
        a = _bf16(_attn_inputs(np.random.default_rng(stage), 8, n, 100, c))
        cases.append((f"fused_attention stage {stage}", lambda a=a, h=heads: pfa.fused_attention(*a, h, 0.125)))
    for stage, (hw, c, _) in FFN_STAGES.items():
        a = _bf16(_ffn_inputs(np.random.default_rng(stage), 8, hw, hw, c))
        cases.append((f"mixffn stage {stage}", lambda a=a: pmf.mixffn(*a)))
    n1, m1, _ = STAGE1
    a = _bf16(_attn_inputs(np.random.default_rng(1), 8, n1, m1, 64))
    cases.append(("stage1_attention stage 1", lambda a=a: ps1.stage1_attention(*a, 0.125)))
    a = _tail_inputs(np.random.default_rng(2), 8, 2)
    cases.append(("decoder_tail Co=2", lambda a=a: pdt.decoder_tail(*a)))
    calls = 200
    with torch.inference_mode():
        for tag, fn in cases:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            issue_ms = (time.perf_counter() - t0) * 1e3 / calls
            torch.cuda.synchronize()
            log(f"[host] {tag} ({root}, {card_line()}): host {issue_ms:.4f} ms to issue a call, "
                f"device {device_ms(fn):.4f} ms a call back to back, {graph_ms(fn):.4f} ms from a CUDA graph")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phases"]:
        sys.exit(phases_main())
    if sys.argv[1:2] == ["--host-probe"]:
        sys.exit(host_probe_main(sys.argv[2] if len(sys.argv) > 2 else "."))
    if sys.argv[1:2] == ["--train-repeats"]:
        sys.exit(train_repeats_main(int(sys.argv[2])))
    if sys.argv[1:2] == ["--split"]:
        sys.exit(split_main(sys.argv[2] if len(sys.argv) > 2 else "."))
    sys.exit(main())
