"""End-to-end learning proof: synthetic data -> training -> held-out error.

Port of tools/learning_proof.py. A small PersNet trains on the synthetic
camera stream (``data.make_step_batch_fn``, seed 1) and the per-pixel
up-vector and latitude errors are measured on a held-out stream (seed 999)
before and after. Pass bar (asserted unless ``--smoke``), the JAX tool's:
the mean up error falls at least 4x from its random-init value and below
15 degrees, and the mean latitude error ends below 10 degrees.

Prints one JSON line and, unless ``--smoke``, writes it to
docs/artifacts/learning_proof_torch.json with the card's name and power
limit.

    python -m perspectivefields_tpu_torch.tools.learning_proof --commit "$(git rev-parse HEAD)"
    python -m perspectivefields_tpu_torch.tools.learning_proof --steps 40 --chunk 20 \\
        --batch 4 --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import BackboneConfig, GravityHeadConfig, LatitudeHeadConfig, ModelConfig
from .train import resolve_device

ARTIFACT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "docs", "artifacts", "learning_proof_torch.json",
)


def build(size: int, device, seed: int = 0):
    """The JAX tool's field-only model (dims 16/32/48/64, two blocks a
    stage, regression heads of width 32), float32, every kernel off."""
    from ..models import PersNet
    from ..models.common import init_random_

    cfg = ModelConfig(
        version="custom",
        backbone=BackboneConfig(dims=(16, 32, 48, 64), depths=(2, 2, 2, 2), num_heads=(1, 2, 3, 4)),
        gravity=GravityHeadConfig(loss_type="regression", embed_dim=32, fusion_dim=32),
        latitude=LatitudeHeadConfig(loss_type="regression", embed_dim=32, fusion_dim=32),
        resize=(size, size),
    )
    return cfg, init_random_(PersNet(cfg), seed=seed).to(device)


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    from ..bench_serving import card_line

    return card_line()


@torch.inference_mode()
def evaluate(model, batches, mean) -> dict:
    """Mean of each batch's field metrics on the held-out batches; latitudes
    in degrees from arcsin of the clipped prediction, as the JAX tool."""
    from ..evaluation import field_metrics

    was_training = model.training
    model.eval()
    rows = []
    for batch in batches:
        out = model(batch["image"] - mean)
        pred_lat = torch.rad2deg(torch.arcsin(out["pred_latitude"][..., 0].clamp(-1, 1)))
        gt_lat = torch.rad2deg(torch.arcsin(batch["gt_latitude"][..., 0]))
        m = field_metrics(out["pred_gravity"], batch["gt_gravity"], pred_lat, gt_lat)
        rows.append({k: float(v) for k, v in m.items()})
    model.train(was_training)
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4, help="peak lr of the warmup + cosine schedule")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="plumbing smoke: no artifact, no improvement assertions")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--commit", default=None,
                    help="the commit (and any change on top of it) the run is made at, recorded "
                         "in the artifact (a copy of the tree without .git cannot name it)")
    args = ap.parse_args(argv)

    from ..data import data_iterator, make_step_batch_fn
    from ..train import create_train_state, make_train_loop, warmup_cosine_decay_schedule

    device = resolve_device(args.device)
    cfg, model = build(args.size, device)
    # warmup + cosine to 1% of the peak: the JAX tool found a constant lr
    # stalls well above the bar; the decay's tail buys single digits
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=args.lr, warmup_steps=min(500, args.steps // 10),
        decay_steps=args.steps, end_value=args.lr * 1e-2,
    )
    state = create_train_state(model, learning_rate=schedule)
    mean = torch.tensor(cfg.pixel_mean, device=device)

    eval_it = data_iterator(999, batch_size=args.batch, im_hw=cfg.resize, device=device)
    eval_batches = [next(eval_it) for _ in range(args.eval_batches)]
    before = evaluate(model, eval_batches, mean)
    print(f"# before: {before}", file=sys.stderr, flush=True)

    batch_fn = make_step_batch_fn(1, batch_size=args.batch, im_hw=cfg.resize, device=device)

    def prepare(batch):
        batch = dict(batch, image=batch["image"] - mean)
        batch.pop("cams")
        batch.pop("gt_params")
        return batch

    loop = make_train_loop(cfg, batch_fn, args.chunk, prepare=prepare)
    t0 = time.time()
    losses = []
    i = 0
    while i < args.steps:
        state, metrics = loop(state)
        i += args.chunk
        losses.append(float(metrics["loss"][-1]))
        print(f"# step {i:5d}  loss {losses[-1]:.4f}  ({time.time() - t0:.0f}s)",
              file=sys.stderr, flush=True)
    train_secs = time.time() - t0

    after = evaluate(model, eval_batches, mean)
    print(f"# after: {after}", file=sys.stderr, flush=True)

    result = {
        "steps": i,
        "batch": args.batch,
        "size": args.size,
        "train_seconds": round(train_secs, 1),
        "images_per_sec": round(i * args.batch / train_secs, 1),
        "before": before,
        "after": after,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "backend": f"torch {torch.__version__}, {device.type}",
        "card": card_name(device),
        "commit": args.commit,
    }
    print(json.dumps(result), flush=True)
    if not args.smoke:
        os.makedirs(os.path.dirname(ARTIFACT), exist_ok=True)
        with open(ARTIFACT, "w") as f:
            json.dump(result, f, indent=1)
        print(f"# wrote {ARTIFACT}", file=sys.stderr)
        assert after["up_mean_deg"] < before["up_mean_deg"] / 4, (before, after)
        assert after["up_mean_deg"] < 15.0, after
        assert after["lat_mean_deg"] < 10.0, after
        print("# learning proof PASSED", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
