"""Train a PerspectiveFields model end to end on synthetic pano crops.

Port of tools/train.py: random cameras -> pano crops + GT fields rendered
on the device, AdamW steps with a global-norm clip, train-state
checkpoints with resume. For real data, swap the batch function for a
loader that yields the same batch dict.

    python -m perspectivefields_tpu_torch.tools.train --steps 200 --batch 16 --size 320
    python -m perspectivefields_tpu_torch.tools.train --steps 2 --batch 2 --size 64 --tiny --device cpu

The full-width model is MiT-b3 at 320^2 with regression heads and a
ParamNetConvNextRegress at input 64, in bfloat16 autocast on float32
parameters, each backbone block recomputed in the backward pass (remat).
``--tiny`` is a narrow float32 model for a CPU smoke run. The model is
built with every kernel off (``use_kernels=False``, no fuse_* flag): the
CUDA kernels are inference-only, as JAX's Pallas kernels are.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..config import (
    BackboneConfig,
    GravityHeadConfig,
    LatitudeHeadConfig,
    ModelConfig,
    ParamNetConfig,
)

TINY_BACKBONE = BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4))


def model_config(tiny: bool, size: int) -> ModelConfig:
    """The trainer's model: JAX's tools/train.py config (MiT-b3, or the tiny
    smoke backbone with narrow heads)."""
    head_kw = dict(embed_dim=16, fusion_dim=16) if tiny else {}
    return ModelConfig(
        version="custom",
        backbone=TINY_BACKBONE if tiny else BackboneConfig(),
        gravity=GravityHeadConfig(loss_type="regression", **head_kw),
        latitude=LatitudeHeadConfig(loss_type="regression", **head_kw),
        param=ParamNetConfig(
            name="ParamNetConvNextRegress",
            predict_params=("roll", "pitch", "vfov"),
            input_size=64 if size >= 128 else 32,
        ),
        recover_rpf=True,
        resize=(size, size),
    )


def resolve_device(name: str) -> torch.device:
    """The device asked for; "cuda" without a card raises (no CPU
    fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to run on the CPU")
    return dev


def build_model(cfg: ModelConfig, device, remat: bool, seed: int = 0):
    """A PersNet for training: float32 parameters from the JAX init scheme
    (seeded), every kernel off."""
    from ..models import PersNet
    from ..models.common import init_random_

    model = PersNet(cfg, use_kernels=False, fuse_ffn=False, fuse_convnext=False,
                    fuse_block=False, remat=remat)
    return init_random_(model, seed=seed).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--tiny", action="store_true", help="tiny float32 model (smoke)")
    ap.add_argument("--out", default=None, help="save the weights as a JAX-layout .npz")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory of step_<n>/ train-state checkpoints; resumes from the newest")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=10,
                    help="steps per loop call (metrics are read once a call); 1 = one step a call")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..checkpoint import restore_train_state, save_params, save_train_state
    from ..data import data_iterator, make_step_batch_fn
    from ..train import create_train_state, make_train_loop, make_train_step

    device = resolve_device(args.device)
    cfg = model_config(args.tiny, args.size)
    model = build_model(cfg, device, remat=not args.tiny)
    dtype = torch.float32 if args.tiny else torch.bfloat16
    state = create_train_state(model, learning_rate=args.lr)

    start = 0
    if args.ckpt_dir and os.path.isdir(args.ckpt_dir):
        try:
            state = restore_train_state(args.ckpt_dir, state)
            start = state.step
            print(f"resumed from {args.ckpt_dir} at step {start}")
        except FileNotFoundError as exc:
            if any(d.startswith("step_") for d in os.listdir(args.ckpt_dir)):
                # checkpoints exist but none restored (another config?):
                # starting again from step 0 would overwrite the run
                raise SystemExit(
                    f"checkpoints exist under {args.ckpt_dir} but none restored "
                    f"({exc.__cause__!r}); refusing to start fresh. Point --ckpt-dir "
                    "elsewhere to begin a new run."
                )
            print(f"no restorable checkpoint under {args.ckpt_dir}; starting fresh")

    # the trainer subtracts pixel_mean only (JAX tools/train.py);
    # evaluate_pairs also divides by pixel_std
    mean = torch.tensor(cfg.pixel_mean, device=device)

    def prepare(batch):
        batch = dict(batch, image=batch["image"] - mean)
        batch.pop("cams")
        return batch

    def maybe_ckpt(prev_step, now_step):
        # whenever a multiple of --ckpt-every falls in (prev_step, now_step]
        if args.ckpt_dir and now_step // args.ckpt_every > prev_step // args.ckpt_every:
            save_train_state(state, args.ckpt_dir)
            print(f"checkpointed step {now_step} -> {args.ckpt_dir}", flush=True)

    t0 = time.time()
    if args.chunk > 1:
        batch_fn = make_step_batch_fn(1, batch_size=args.batch, im_hw=cfg.resize, device=device)
        loops = {}

        def loop_for(n):
            if n not in loops:
                loops[n] = make_train_loop(cfg, batch_fn, n, prepare=prepare, compute_dtype=dtype)
            return loops[n]

        i, warm = start, None
        while i < args.steps:
            n = min(args.chunk, args.steps - i)
            state, metrics = loop_for(n)(state)
            i += n
            loss = float(metrics["loss"][-1])
            if warm is None:
                print(f"step {i:5d}  loss {loss:.4f}  (first call: {time.time() - t0:.1f}s)",
                      flush=True)
                warm = (time.time(), i)
            else:
                rate = args.batch * (i - warm[1]) / (time.time() - warm[0])
                print(f"step {i:5d}  loss {loss:.4f}  ({rate:.1f} img/s)", flush=True)
            maybe_ckpt(i - n, i)
    else:
        step_fn = make_train_step(cfg, compute_dtype=dtype)
        it = data_iterator(1, batch_size=args.batch, im_hw=cfg.resize, start_step=start,
                           device=device)
        for i in range(start, args.steps):
            state, metrics = step_fn(state, prepare(next(it)))
            if (i + 1) % args.log_every == 0 or i == start:
                loss = float(metrics["loss"])
                rate = args.batch * (i + 1 - start) / (time.time() - t0)
                print(f"step {i + 1:5d}  loss {loss:.4f}  ({rate:.1f} img/s)", flush=True)
            maybe_ckpt(i, i + 1)

    if args.out:
        save_params(state.model, args.out)
        print(f"saved {args.out}")
    return state


if __name__ == "__main__":
    main()
