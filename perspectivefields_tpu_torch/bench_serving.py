"""Host-fed serving throughput of the port on one NVIDIA GPU.

    python -m perspectivefields_tpu_torch.bench_serving [--batch 32]
        [--batches 64] [--depth 1,2] [--modes params:u8,fields:u8] [--out FILE]

The path a serving deployment runs, through ``serving.BatchPredictor``:
host uint8 640x640 frames -> native preprocess (OpenMP, PIL-exact resize;
u8 or fused-f32 wire) into pinned memory -> host-to-device copy -> the bf16
forward of the flagship (the attention kernel's default path, seeded random
weights: throughput does not depend on their values) -> device-to-host copy
of the selected outputs. The wall time covers the whole stream: every
image's selected outputs land in host numpy. The stream cycles over 256
distinct frames (8 batches at B=32; 315 MB, beyond the host's caches), so a
window of several seconds needs no more host memory. It reports img/s,
``StageTimer``'s split and the pinned host memory that PyTorch's caching
host allocator holds after the stream, per mode and depth:

  params:u8       camera-parameter service (roll/pitch/vfov/cx/cy), u8 wire
  fields:u8       dense-field service (gravity + latitude at network size),
                  float32 readback
  fields:u8:f16o  the same service, f16 output wire
  fields:u8:u8o   the same service, u8 fixed-point output wire
  params:f32      parameters, float32 input wire (fused host normalize)

The header line holds a host<->device link probe in MB/s, from pinned and
from pageable host memory. Every line carries the card's name and power
limit as nvidia-smi gives them. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import native
from .api import PerspectiveFields
from .config import model_zoo
from .models import PersNet
from .models.common import init_random_
from .serving import BatchPredictor

VERSION = "Paramnet-360Cities-edina-centered"
PARAM_KEYS = ("pred_roll", "pred_pitch", "pred_general_vfov", "pred_rel_cx", "pred_rel_cy")
FIELD_KEYS = ("pred_gravity", "pred_latitude")
# mode -> (wire, select, out_wire)
MODES = {
    "params:u8": ("u8", PARAM_KEYS, None),
    "fields:u8": ("u8", FIELD_KEYS, None),
    "fields:u8:f16o": ("u8", FIELD_KEYS, "f16"),
    "fields:u8:u8o": ("u8", FIELD_KEYS, "u8"),
    "params:f32": ("f32", PARAM_KEYS, None),
}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def link_probe(mb: int = 64, reps: int = 5) -> dict:
    """Host-to-device and device-to-host MB/s (best of ``reps`` copies of
    ``mb`` MiB each, timed to a synchronize) from pinned and from pageable
    host memory."""
    n = mb * 2**20 // 4
    dev = torch.empty(n, device="cuda")
    rates = {}
    for kind, pinned in (("pinned", True), ("pageable", False)):
        host = torch.ones(n, pin_memory=pinned)
        for direction in ("h2d", "d2h"):
            dst, src = (dev, host) if direction == "h2d" else (host, dev)
            dst.copy_(src, non_blocking=pinned)  # warm-up
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                dst.copy_(src, non_blocking=pinned)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            rates[f"{direction}_{kind}_MBps"] = mb * 2**20 / 1e6 / best
    return rates


def flagship(seed: int = 0) -> PerspectiveFields:
    """The flagship in bf16 on the card, with weights drawn from ``seed``."""
    cfg = model_zoo[VERSION]["config"]
    sd = init_random_(PersNet(cfg), seed=seed).state_dict()
    return PerspectiveFields(VERSION, params=sd, compute_dtype="bfloat16", device="cuda")


def run_mode(model, images, batch_size, wire, select, warm_images, depth, out_wire=None) -> dict:
    """img/s of one BatchPredictor configuration over ``images`` (after one
    untimed pass over ``warm_images``), with its StageTimer split."""
    pred = BatchPredictor(model, batch_size=batch_size, wire=wire, select=select, depth=depth,
                          out_wire=out_wire)
    for _ in pred.predict_iter(warm_images):
        pass
    pred.timer = type(pred.timer)()
    n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in pred.predict_iter(images):
        n += 1
    dt = time.perf_counter() - t0
    stats = getattr(torch.cuda, "host_memory_stats", None)
    pinned = stats().get("allocated_bytes.current") if stats is not None else None
    return {"images": n, "seconds": dt, "images_per_sec": n / dt, "stages": pred.timer.summary(),
            "pinned_host_bytes": pinned}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--batches", type=int, default=64, help="timed batches per mode")
    ap.add_argument("--depth", default="1,2", help="comma-separated depths")
    ap.add_argument("--modes", default=",".join(MODES), help="comma-separated modes")
    ap.add_argument("--out", help="also write all results to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_serving: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        ap.error(f"unknown modes {unknown}; known: {list(MODES)}")
    card = card_line()
    model = flagship()
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, size=(min(args.batches * args.batch, 256), 640, 640, 3), dtype=np.uint8)
    images = [pool[i % len(pool)] for i in range(args.batches * args.batch)]
    results = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "link": link_probe(),
        "batch": args.batch,
        "n_images": len(images),
        "host_preprocess": native.backend(),
        "host_threads": native.num_threads(),
        "modes": [],
    }
    print(json.dumps({k: v for k, v in results.items() if k != "modes"}), flush=True)
    for depth in (int(d) for d in args.depth.split(",")):
        for name in modes:
            wire, select, out_wire = MODES[name]
            r = run_mode(model, images, args.batch, wire, select, images[: args.batch], depth,
                         out_wire)
            line = {"mode": name, "depth": depth, "card": card, **r}
            results["modes"].append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
