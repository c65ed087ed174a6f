"""Multi-process dry run: several processes form one (data, model) mesh.

Port of tools/dryrun_multiprocess.py. ``--procs`` processes (4 by default)
join one gloo group on the CPU (``parallel.init_distributed`` with a file
store) and build one (data, model) mesh (``--n-model`` 2 by default, so
data=2, model=2). Each runs ``--steps`` (2) train steps of the toy config
on its rows of the global batch, its ruled Linears split over the model
axis (``parallel.tensor_parallel``), then one tensor-parallel
``sharded_forward`` batch, and the outputs are gathered over the data axis.
A one-process control on the whole batch runs first. Agreement, as in JAX:
the losses within 1e-5 and the forward's absolute checksum within
1e-4 * max(1, |control|); and, gathered whole, the parameters within
0.1 * lr * steps and Adam's first moments within 1e-6 of the control's;
the replicated parameters bit-equal across each model group after every
step; each rank's AdamW state of the size ``param_shardings`` implies.
Writes docs/artifacts/multiprocess_torch.json (``--out``).

    python -m perspectivefields_tpu_torch.tools.dryrun_multiprocess
    python -m perspectivefields_tpu_torch.tools.dryrun_multiprocess --procs 2 --n-model 1
    python -m perspectivefields_tpu_torch.tools.dryrun_multiprocess --procs 2 --n-model 2 \
        --steps 1 --config trainer --device cuda   # two ranks sharing one GPU (gloo)

``--config trainer`` runs the trainer's full-width model (MiT-b3 at 320^2,
remat) in float32 with TF32 off on a synthetic B=16 batch that each rank
renders its own rows of (``data.make_step_batch_fn(..., rows=...)``); on
the card each rank reports its peak device memory.

The toy batch gives the two halves of the batch different valid-pixel
counts (invalid up-vectors in rows 0-1), and the toy backbone's stochastic
depth is on (rates 0-0.1), so a data-parallel step equals the one-process
step only if the global denominators and masks are used.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ART = os.path.join(REPO, "docs", "artifacts", "multiprocess_torch.json")
LR = 1e-4
BATCH = 8
TRAINER_BATCH = 16


def toy_setup():
    """The JAX dry run's toy config and a seeded global batch (B=8, 64^2)."""
    from ..config import BackboneConfig, GravityHeadConfig, LatitudeHeadConfig, ModelConfig, ParamNetConfig

    cfg = ModelConfig(
        backbone=BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4)),
        gravity=GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
        latitude=LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
        param=ParamNetConfig(
            name="ParamNetConvNextRegress",
            predict_params=("roll", "pitch", "general_vfov", "rel_cx", "rel_cy"),
            input_size=32,
        ),
        recover_rpf=True,
        recover_pp=True,
        resize=(64, 64),
    )
    rng = np.random.default_rng(0)
    batch = {
        "image": rng.normal(size=(BATCH, 64, 64, 3)).astype(np.float32),
        "gt_gravity": rng.normal(size=(BATCH, 64, 64, 2)).astype(np.float32),
        "gt_latitude": rng.uniform(-1, 1, size=(BATCH, 64, 64, 1)).astype(np.float32),
        "gt_params": (rng.normal(size=(BATCH, 5)) * 0.3).astype(np.float32),
    }
    batch["gt_gravity"][:2, :40] = 0.0  # invalid pixels in the first half only
    return cfg, batch


def toy_model(cfg, device="cpu"):
    """Seeded toy weights, each backbone block recomputed in the backward
    pass (remat) as the trainer's are, conditioned as the parity checks
    condition random weights: the latitude head's prediction conv shrunk 100x
    (chip_smoke.seeded_state_dict's rule) so the head is not saturated, and
    the gravity head's prediction bias set to (0, 2) so no pixel's up-vector
    nearly cancels before it is normalised (which would turn a summation
    order's 1e-7 into 1e-4)."""
    from ..models import PersNet
    from ..models.common import init_random_

    model = init_random_(PersNet(cfg, remat=True), seed=0)
    with torch.no_grad():
        for p in model.persformer_heads["latitude_head"].linear_pred_latitude.parameters():
            p.mul_(0.01)
        model.persformer_heads["gravity_head"].linear_pred_gravity.bias.copy_(torch.tensor([0.0, 2.0]))
    return model.to(device)


def trainer_setup(device, rows=None):
    """The trainer's full-width config and model (remat), its latitude
    prediction conv shrunk as ``toy_model``'s, and synthetic batch 0 of a
    B=16 320^2 stream (``rows`` of it), mean-subtracted as the trainer
    does."""
    from ..data import make_step_batch_fn
    from .train import build_model, model_config

    cfg = model_config(False, 320)
    model = build_model(cfg, device, remat=True, seed=0)
    with torch.no_grad():
        for p in model.persformer_heads["latitude_head"].linear_pred_latitude.parameters():
            p.mul_(0.01)
    batch = make_step_batch_fn(3, TRAINER_BATCH, cfg.resize, device=device, rows=rows)(0)
    batch.pop("cams")
    batch["image"] = batch["image"] - torch.tensor(cfg.pixel_mean, device=device)
    return cfg, model, batch


def run(role: str, init: str, rank: int, world: int, n_model: int, steps: int,
        device: str, out_dir: str | None, config: str = "toy", ckpt_dir: str | None = None,
        resume: str | None = None) -> dict:
    """One member of the mesh ("mp") or the one-process control ("solo"):
    ``steps`` train steps, then the forward (tensor-parallel for "mp" with a
    model axis > 1). With ``out_dir`` the first rank saves the whole
    parameters, Adam's first moments, outputs and losses there. With
    ``ckpt_dir`` the train state is checkpointed after the first step under
    ``ckpt_dir/<role>``; with ``resume`` the state then restores the
    checkpoint there and takes one more step (its loss is
    ``resumed_loss``). It runs on one thread with TF32 off and gives the
    caller its settings back."""
    saved = (torch.get_num_threads(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(role, init, rank, world, n_model, steps, torch.device(device), out_dir, config,
                    ckpt_dir, resume)
    finally:
        torch.set_num_threads(saved[0])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[1:]


def _replicas_agree(model, mesh) -> bool:
    """Whether this rank's replicated parameters equal, bit for bit, those of
    the first rank of its model group."""
    from ..parallel.tensor_parallel import model_shard

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters() if model_shard(p) is None])
    first = flat.clone()
    torch.distributed.broadcast(first, group=mesh.get_group("model"), group_src=0)
    return torch.equal(flat, first)


def _run(role, init, rank, world, n_model, steps, dev, out_dir, config, ckpt_dir, resume) -> dict:
    from ..checkpoint import restore_train_state, save_train_state
    from ..parallel import (all_gather_batch, batch_rows, init_distributed, make_mesh,
                            param_shardings, shard_batch, sharded_forward)
    from ..parallel.tensor_parallel import gather_like
    from ..train import create_train_state, make_train_step

    mesh = None
    if role == "mp":
        init_distributed(init, world, rank, backend="gloo")
        mesh = make_mesh(n_data=world // n_model, n_model=n_model, device_type=dev.type)
    if dev.type == "cuda":  # the run's own peak: above what the caller holds
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)

    if config == "trainer":
        cfg, model, local = trainer_setup(dev, batch_rows(mesh, TRAINER_BATCH))
    else:
        cfg, batch_np = toy_setup()
        model = toy_model(cfg, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        local = batch if mesh is None else {k: shard_batch(mesh, v) for k, v in batch.items()}
    expected = None  # the elements of an AdamW moment param_shardings leaves a rank
    if mesh is not None:
        placements = param_shardings(mesh, model)
        expected = sum(p.numel() // (1 if placements[k].is_replicate() else n_model)
                       for k, p in model.named_parameters())
    state = create_train_state(model, learning_rate=LR, mesh=mesh)
    step = make_train_step(cfg, mesh=mesh)
    split = mesh is not None and n_model > 1
    losses, replicas_equal = [], True
    for i in range(steps):
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
        if split:
            replicas_equal &= _replicas_agree(state.model, mesh)
        if ckpt_dir is not None and i == 0:
            save_train_state(state, os.path.join(ckpt_dir, role), write=rank == 0)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses {losses}")
    adam = sum(st["exp_avg"].numel() for st in state.optimizer.state.values())
    model = state.model.eval()
    if split:
        fn, _ = sharded_forward(model, mesh)
        out = fn(local["image"])
    else:
        with torch.no_grad():
            out = model(local["image"])
    if mesh is not None:
        out = {k: all_gather_batch(mesh, v) for k, v in out.items()}
    checksum = float(sum(v.double().abs().sum() for v in out.values()))
    if out_dir is not None:
        params = model.state_dict()  # whole tensors: a collective when split
        names = {id(p): n for n, p in model.named_parameters()}
        moments = {names[id(p)]: gather_like(st["exp_avg"], p).cpu()
                   for p, st in state.optimizer.state.items()}
        if rank == 0:
            torch.save({"params": {k: v.cpu() for k, v in params.items()}, "exp_avg": moments,
                        "outputs": {k: v.cpu() for k, v in out.items()}, "losses": losses},
                       os.path.join(out_dir, f"{role}.pt"))
    result = {
        "role": role,
        "process_id": rank,
        "process_count": world if mesh is not None else 1,
        "mesh": None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "train_losses": losses,
        "inference_abs_checksum": checksum,
        "adam_elements": adam,
        "expected_adam_elements": expected,
        "replicated_bit_equal": replicas_equal if split else None,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) - held if dev.type == "cuda" else None,
    }
    if resume is not None:
        state = restore_train_state(resume, state)
        result["resumed_loss"] = float(step(state, local)[1]["loss"])
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return result


def launch(world: int, n_model: int, steps: int, out_dir: str | None = None,
           timeout: float = 600.0, device: str = "cpu", config: str = "toy",
           ckpt_dir: str | None = None, resume: str | None = None) -> list[dict]:
    """Run ``world`` mesh members as separate processes (a file store under
    a temporary directory) and return their results in rank order. Every
    process is killed if any of them fails or the timeout passes."""
    extra = []
    for flag, value in (("--save-dir", out_dir), ("--ckpt-dir", ckpt_dir), ("--resume", resume)):
        if value:
            extra += [flag, str(value)]
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", __spec__.name, "--role", f"mp:{rank}:{world}", "--init", init,
                 "--n-model", str(n_model), "--steps", str(steps), "--device", device,
                 "--config", config, *extra],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
                env=dict(os.environ, OMP_NUM_THREADS="1"),
            )
            for rank in range(world)
        ]
        deadline = time.monotonic() + timeout
        try:
            results = [_collect(p, f"mp[{i}]", deadline) for i, p in enumerate(procs)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return results


def _collect(proc, tag: str, deadline: float) -> dict:
    try:
        out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{tag} timed out") from None
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(f"--- {tag} output ---\n{out}\n")
        raise RuntimeError(f"{tag} failed rc={proc.returncode}")
    return json.loads(lines[-1][len("RESULT "):])


def compare(out_dir: str) -> dict:
    """The largest differences between the control's and the mesh's saved
    whole parameters and Adam first moments (``solo.pt`` and ``mp.pt``
    under ``out_dir``)."""
    a, b = (torch.load(os.path.join(out_dir, f"{role}.pt"), weights_only=True)
            for role in ("solo", "mp"))
    return {
        "max_param_diff": max((a["params"][k] - b["params"][k]).abs().max().item() for k in a["params"]),
        "max_moment_diff": max((a["exp_avg"][k] - b["exp_avg"][k]).abs().max().item()
                               for k in a["exp_avg"]),
    }


def agree(solo: dict, results: list[dict], diffs: dict, steps: int) -> bool:
    """JAX's bar: every member's losses within 1e-5 of the control's and
    its checksum within 1e-4 * max(1, |control|); every member's AdamW state
    of the size ``param_shardings`` implies, and its replicated parameters
    bit-equal to its model group's first rank's; ``diffs`` (``compare``):
    the parameters within 0.1 * lr * steps, Adam's first moments within
    1e-6."""
    ref = solo["inference_abs_checksum"]
    return diffs["max_param_diff"] <= 0.1 * LR * steps and diffs["max_moment_diff"] <= 1e-6 and all(
        abs(r["inference_abs_checksum"] - ref) <= 1e-4 * max(1.0, abs(ref))
        and all(abs(a - b) <= 1e-5 for a, b in zip(r["train_losses"], solo["train_losses"]))
        and r["replicated_bit_equal"] in (True, None)
        and (not r["train_losses"] or r["adam_elements"] == r["expected_adam_elements"])
        for r in results
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--n-model", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cpu", help="the processes' device (gloo either way)")
    ap.add_argument("--config", default="toy", choices=["toy", "trainer"])
    ap.add_argument("--out", default=ART, help="the artifact's path")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds for the mesh run")
    ap.add_argument("--role", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--save-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resume", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.role:  # a member of the mesh
        _, rank, world = args.role.split(":")
        r = run("mp", args.init, int(rank), int(world), args.n_model, args.steps, args.device,
                args.save_dir, args.config, args.ckpt_dir, args.resume)
        print("RESULT " + json.dumps(r), flush=True)
        return r

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        print("# running the one-process control...", file=sys.stderr, flush=True)
        solo = run("solo", "", 0, 1, 1, args.steps, args.device, tmp, args.config)
        print(f"# control done in {time.perf_counter() - t0:.0f}s; starting the {args.procs}-"
              "process run...", file=sys.stderr, flush=True)
        results = launch(args.procs, args.n_model, args.steps, out_dir=tmp, timeout=args.timeout,
                         device=args.device, config=args.config)
        diffs = compare(tmp)
    ok = agree(solo, results, diffs, args.steps)
    artifact = {
        "config": args.config,
        "what": f"{args.procs}-process gloo (data={args.procs // args.n_model}, model={args.n_model}) "
                f"mesh vs a 1-process control (init_distributed + {args.steps} train steps with "
                "the ruled Linears split over the model axis + tensor-parallel sharded_forward)",
        "torch": torch.__version__,
        "solo": solo,
        "multiprocess": results,
        **diffs,
        "agree": ok,
        "wall_seconds": round(time.perf_counter() - t0, 1),
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
    print(json.dumps(artifact, indent=2))
    if not ok:
        raise SystemExit("the mesh run disagrees with the one-process control")
    return artifact


if __name__ == "__main__":
    main()
