"""Train a PerspectiveFields model end to end on synthetic pano crops.

Port of tools/train.py: random cameras -> pano crops + GT fields rendered
on the device, AdamW steps with a global-norm clip, train-state
checkpoints with resume. For real data, swap the batch function for a
loader that yields the same batch dict.

    python -m perspectivefields_tpu_torch.tools.train --steps 200 --batch 16 --size 320
    python -m perspectivefields_tpu_torch.tools.train --steps 2 --batch 2 --size 64 --tiny --device cpu
    torchrun --nproc_per_node=N -m perspectivefields_tpu_torch.tools.train --steps 200 --batch 32

Under torchrun the ranks form one (data, model) mesh (``parallel.make_mesh``;
by default every rank on "data", as JAX's trainer lays every device):
``--batch`` is the global batch and each data index renders and trains on
its own rows of it; the step is the one-process step on the whole batch.
``--n-model N`` splits the ruled Linears, and their AdamW state, over N
ranks (``parallel.tensor_parallel``). Every rank gathers the checkpoints
and ``--out`` whole (a split state is saved in the one-process format),
rank 0 logs and writes them, the others wait at a barrier; every rank
restores. NCCL is the CUDA backend; it refuses two ranks on one GPU, so
pass ``--backend gloo`` there (and on the CPU).

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
import torch.distributed as dist

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
    fallback). Under torchrun a bare "cuda" is this rank's card
    (LOCAL_RANK modulo the cards)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found; pass --device cpu to run on the CPU")
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
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
    ap.add_argument("--backend", default=None,
                    help="process-group backend under torchrun: nccl (CUDA default) or gloo")
    ap.add_argument("--n-model", type=int, default=1,
                    help="ranks the ruled Linears are split over under torchrun (tensor parallel)")
    args = ap.parse_args(argv)

    from ..checkpoint import restore_train_state, save_params, save_train_state
    from ..data import data_iterator, make_step_batch_fn
    from ..parallel import batch_rows, init_distributed, make_mesh
    from ..train import create_train_state, make_train_loop, make_train_step

    device = resolve_device(args.device)
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(backend=args.backend or ("nccl" if device.type == "cuda" else "gloo"))
        mesh = make_mesh(n_model=args.n_model, device_type=device.type)
    main_rank = mesh is None or dist.get_rank() == 0

    def log(msg):
        if main_rank:
            print(msg, flush=True)

    def sync():  # the other ranks wait for rank 0's writes
        if mesh is not None:
            dist.barrier()

    rows = batch_rows(mesh, args.batch)
    cfg = model_config(args.tiny, args.size)
    model = build_model(cfg, device, remat=not args.tiny)
    dtype = torch.float32 if args.tiny else torch.bfloat16
    state = create_train_state(model, learning_rate=args.lr, mesh=mesh)

    start = 0
    if args.ckpt_dir and os.path.isdir(args.ckpt_dir):
        try:
            state = restore_train_state(args.ckpt_dir, state)
            start = state.step
            log(f"resumed from {args.ckpt_dir} at step {start}")
        except FileNotFoundError as exc:
            if any(d.startswith("step_") for d in os.listdir(args.ckpt_dir)):
                # checkpoints exist but none restored (another config?):
                # starting again from step 0 would overwrite the run
                raise SystemExit(
                    f"checkpoints exist under {args.ckpt_dir} but none restored "
                    f"({exc.__cause__!r}); refusing to start fresh. Point --ckpt-dir "
                    "elsewhere to begin a new run."
                )
            log(f"no restorable checkpoint under {args.ckpt_dir}; starting fresh")

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
            save_train_state(state, args.ckpt_dir, write=main_rank)
            log(f"checkpointed step {now_step} -> {args.ckpt_dir}")
            sync()

    t0 = time.time()
    if args.chunk > 1:
        batch_fn = make_step_batch_fn(1, batch_size=args.batch, im_hw=cfg.resize, device=device,
                                      rows=rows)
        loops = {}

        def loop_for(n):
            if n not in loops:
                loops[n] = make_train_loop(cfg, batch_fn, n, prepare=prepare, compute_dtype=dtype,
                                           mesh=mesh)
            return loops[n]

        i, warm = start, None
        while i < args.steps:
            n = min(args.chunk, args.steps - i)
            state, metrics = loop_for(n)(state)
            i += n
            loss = float(metrics["loss"][-1])
            if warm is None:
                log(f"step {i:5d}  loss {loss:.4f}  (first call: {time.time() - t0:.1f}s)")
                warm = (time.time(), i)
            else:
                rate = args.batch * (i - warm[1]) / (time.time() - warm[0])
                log(f"step {i:5d}  loss {loss:.4f}  ({rate:.1f} img/s)")
            maybe_ckpt(i - n, i)
    else:
        step_fn = make_train_step(cfg, compute_dtype=dtype, mesh=mesh)
        it = data_iterator(1, batch_size=args.batch, im_hw=cfg.resize, start_step=start,
                           device=device, rows=rows)
        for i in range(start, args.steps):
            state, metrics = step_fn(state, prepare(next(it)))
            if (i + 1) % args.log_every == 0 or i == start:
                loss = float(metrics["loss"])
                rate = args.batch * (i + 1 - start) / (time.time() - t0)
                log(f"step {i + 1:5d}  loss {loss:.4f}  ({rate:.1f} img/s)")
            maybe_ckpt(i, i + 1)

    if args.out:
        params = state.model.state_dict()  # whole tensors: a collective when split
        if main_rank:
            save_params(params, args.out)
        log(f"saved {args.out}")
        sync()
    return state


if __name__ == "__main__":
    main()
