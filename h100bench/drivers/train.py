"""``train``: the training program's step (``train.create_train_state``,
``train.make_train_step``) on the configuration's model, back to back.

Traffic: ``batch``, ``size``, ``pool`` (seeded batches in pinned host
memory; step k copies batch k modulo the pool to the card, as a pinned
loader would), ``cameras_deg``, ``checked_steps``, ``profile.steps``.

Set-up builds one training state and drives it through the window's own
step and feed for ``checked_steps`` steps, each on a different batch,
recording each step's loss, the first step's gradient as AdamW received it
(its first moment after one step over 1 - beta1) and, after the last, each
parameter's change from its initial value. The window then goes on with
the same state. Its clock stops after a synchronize, so every step it
issued has finished.
"""

from __future__ import annotations

import time

import torch

from ..reference import model as ref_model
from ..reference import train as ref_train
from ..yardstick import trace, traffic
from . import common

BETA1 = 0.9  # torch.optim.AdamW's default, which the training program uses
CONTROL = common.CONTROL
FAULTS = ("half_batch", "lr_x1.5")  # planted in the reference put in the program's place

# The numbers ``compare`` reads that decide ``correct``: the median leaf's,
# which the control and the planted faults fail. The losses and the worst
# leaves are read for the record only: no control or fault separates them
# from the program's own rounding (PERF.md, section 2).
COMPARED = ("grad_median_leaf", "change_median_leaf")


def _pool(run) -> list:
    tr, m = run.traffic, run.config["model"]
    return traffic.train_pool(run.seed, tr["pool"], tr["batch"], tr["size"], m["pixel_mean"],
                              run.device, tr["cameras_deg"])


def _to_device(batch: dict, device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def _leaf_norms(tensors) -> list[float]:
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).tolist()


def setup(run):
    from perspectivefields_tpu_torch.models import PersNet
    from perspectivefields_tpu_torch.train import create_train_state, make_train_step

    tr, rc = run.traffic, run.config["run"]
    pcfg = common.port_config(run.config)
    pool = _pool(run)
    run.mark("traffic made")
    model = PersNet(pcfg, use_kernels=False, fuse_ffn=False, fuse_convnext=False,
                    fuse_block=False, remat=rc["remat"])
    model.load_state_dict(common.state_dict(run.config, run.seed, run.device), strict=True)
    model.to(run.device)
    state = create_train_state(model, learning_rate=rc["learning_rate"],
                               weight_decay=rc["weight_decay"], grad_clip=rc["grad_clip"])
    step = make_train_step(pcfg, compute_dtype=getattr(torch, rc["compute_dtype"]))
    run.mark("program built")
    losses, grad_norm = [], None
    for k in range(tr["checked_steps"]):
        state, metrics = step(state, _to_device(pool[k % len(pool)], run.device))
        losses.append(metrics["loss"])
        common.sync(run.device)
        run.mark(f"checked step {k + 1}")
        if k == 0:  # the gradient AdamW received: its first moment over 1 - beta1
            opt = state.optimizer
            grad_norm = _leaf_norms(  # a parameter AdamW did not step has no moment: 0
                opt.state[p]["exp_avg"] / (1.0 - BETA1) if "exp_avg" in opt.state[p]
                else torch.zeros((), device=p.device) for p in model.parameters())
    start = common.state_dict(run.config, run.seed, run.device)
    names = [n for n, _ in model.named_parameters()]
    change = _leaf_norms(p.detach() - start[n] for n, p in model.named_parameters())
    del start
    run.ctx["program_steps"] = {"names": names, "loss": [float(x) for x in losses],
                                "grad_norm": grad_norm, "change_norm": change}
    common.sync(run.device)
    if torch.device(run.device).type == "cuda":
        run.ctx["setup_peak_bytes"] = torch.cuda.max_memory_allocated(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    return {"state": state, "step": step, "pool": pool}


def window(run, st):
    tr = run.traffic
    state, step, pool = st["state"], st["step"], st["pool"]
    first, n = tr["checked_steps"], 0
    t0 = run.start_window()
    while time.perf_counter() - t0 < run.seconds:
        state, _ = step(state, _to_device(pool[(first + n) % len(pool)], run.device))
        n += 1
    common.sync(run.device)
    t1 = time.perf_counter()
    run.ctx.update(window_s=t1 - t0, steps=n, batch=tr["batch"], attempted=n, failed=0)
    if torch.device(run.device).type == "cuda":
        run.ctx["window_peak_bytes"] = torch.cuda.max_memory_allocated(run.device)


def profile(run, st):
    state, step, pool = st["state"], st["step"], st["pool"]

    def stretch():
        for k in range(run.traffic["profile"]["steps"]):
            step(state, _to_device(pool[k % len(pool)], run.device))

    run.ctx["trace"] = trace.profile(stretch, run.device)
    run.ctx["host_trace"] = trace.profile(stretch, run.device, host=True)


def release(run, st):
    st.pop("state")
    st.pop("step")
    common.free(run.device)


def reference_steps(run, pool, rounding=None, rows=None, lr_scale=1.0) -> dict:
    """The reference's ``checked_steps`` steps from the same weights on the
    same batches (``rounding``: the control; ``rows``, a slice of each
    batch, or ``lr_scale``: a planted fault)."""
    tr, rc = run.traffic, run.config["run"]
    m = run.config["model"]
    rc = rc | {"learning_rate": rc["learning_rate"] * lr_scale}
    with common.exact_float32():
        net = ref_model.build(m, common.state_dict(run.config, run.seed, run.device), run.device,
                              rounding)
        batches = [_to_device(pool[k % len(pool)], run.device) for k in range(tr["checked_steps"])]
        keys = tuple(m["param"]["predict_params"])
        factors = tuple(ref_model.PARAM_FACTORS[k] for k in keys)
        out = ref_train.run_steps(net, batches, rc, keys, factors, rows)
        del net, batches
    common.free(run.device)
    return out


def compare(got: dict, ref: dict, detail: dict | None = None) -> dict:
    """The numbers read:

    * ``loss_rel``, ``loss1_rel``: the widest relative gap of a step's loss,
      and the first step's;
    * ``grad_leaf``: the widest gap between a leaf's first-gradient norm and
      the reference's, over the larger of the reference's norm of that leaf
      and of the median leaf; ``grad_median_leaf``: the median leaf's gap,
      steady from seed to seed where the worst leaf swings;
    * ``change_leaf``, ``change_median_leaf``: the same of each leaf's
      change over the steps, over the leaves whose reference gradient is at
      least a thousandth of the median leaf's (the others move under AdamW
      by round-off alone)."""
    if sorted(got["names"]) != sorted(ref["names"]):
        raise ValueError("the program's parameters are not the reference's")
    at = {n: i for i, n in enumerate(got["names"])}
    got = {k: [got[k][at[n]] for n in ref["names"]] for k in ("grad_norm", "change_norm")} | {
        "loss": got["loss"]}
    step_rel = [abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])]
    g_ref = torch.tensor(ref["grad_norm"], dtype=torch.float64)
    g_med = float(g_ref.median())
    grad = (torch.tensor(got["grad_norm"], dtype=torch.float64) - g_ref).abs() / g_ref.clamp_min(g_med)
    moved = g_ref >= 1e-3 * g_med
    c_ref = torch.tensor(ref["change_norm"], dtype=torch.float64)[moved]
    c_got = torch.tensor(got["change_norm"], dtype=torch.float64)[moved]
    change = (c_got - c_ref).abs() / c_ref.clamp_min(float(c_ref.median()))
    if detail is not None:
        gi, ci = int(grad.argmax()), int(change.argmax())
        names = [n for n, m in zip(ref["names"], moved.tolist()) if m]
        detail.update(step_loss_rel=step_rel, losses=[got["loss"], ref["loss"]],
                      grad_worst=[ref["names"][gi], got["grad_norm"][gi], ref["grad_norm"][gi]],
                      change_worst=[names[ci], float(c_got[ci]), float(c_ref[ci])],
                      left_out=len(moved) - len(names))
    return {"loss_rel": max(step_rel), "loss1_rel": step_rel[0], "grad_leaf": float(grad.max()),
            "grad_median_leaf": float(grad.median()), "change_leaf": float(change.max()),
            "change_median_leaf": float(change.median())}


def check(run, st, control=None):
    """Compare the program's checked steps (or, with ``control``, the
    control's or a planted fault's) with the reference's."""
    pool = st["pool"]
    ref = reference_steps(run, pool)
    if control is None:
        got = run.ctx["program_steps"]
    elif control == CONTROL:
        got = reference_steps(run, pool, rounding=CONTROL)
    elif control == "half_batch":
        got = reference_steps(run, pool, rows=slice(0, run.traffic["batch"] // 2))
    elif control == "lr_x1.5":
        got = reference_steps(run, pool, lr_scale=1.5)
    else:
        raise ValueError(f"unknown control {control!r}")
    detail = run.ctx["detail"] = {}
    numbers = compare(got, ref, detail)
    run.compared({k: numbers[k] for k in COMPARED})
    detail["not_compared"] = {k: v for k, v in numbers.items() if k not in COMPARED}
    run.ctx["compared"] = len(got["loss"])
    if not all(map(torch.isfinite, torch.tensor(got["loss"]))):
        run.problems.append(f"non-finite loss {got['loss']}")
