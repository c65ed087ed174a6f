"""The training step: AdamW with a global-norm clip, under bf16 autocast.

Port of perspectivefields_tpu/train/train_step.py without the mesh (one
device; the data-parallel form is future work). ``TrainState`` holds the
module, its optimizer and the step. The optimizer is optax's
``chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay))`` in torch:
``torch.optim.AdamW`` with optax's defaults (betas 0.9 / 0.999, eps 1e-8)
decaying every parameter (optax's mask=None), after optax's clip, which
scales by max / ||g|| only where ||g|| >= max (``clip_by_global_norm_``;
``torch.nn.utils.clip_grad_norm_`` always scales by max / (||g|| + 1e-6)).

Precision: the parameters stay float32 and the forward runs under
``torch.autocast(dtype=torch.bfloat16)``, which is what flax's
``dtype=bfloat16`` does (bf16 compute on f32 parameters). Do not
``.to(bfloat16)`` the module for training: that stores bf16 weights, as
``PerspectiveFields(compute_dtype="bfloat16")`` does for inference.

JAX's ``make_train_loop`` runs ``chunk`` steps in one XLA program
(``lax.scan``); here it is a Python loop of ``chunk`` steps that returns
their metrics stacked.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
from torch import nn

from ..data import seeded_generator
from .losses import total_loss

Schedule = Union[float, Callable[[int], float]]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    learning_rate: Schedule = 1e-4
    grad_clip: Optional[float] = 1.0


def create_train_state(
    model: nn.Module,
    learning_rate: Schedule = 1e-4,
    weight_decay: float = 1e-2,
    grad_clip: Optional[float] = 1.0,
) -> TrainState:
    """Wrap an initialised float32 ``model`` (on its device) with AdamW.

    learning_rate: a float or a function of the step (optax's schedule: the
    update that makes step k + 1 uses ``learning_rate(k)``).
    grad_clip: the global-norm clip (None turns it off). It is on by
    default: the masked field losses spike on batches whose cameras give
    mostly invalid fields, and in JAX an unclipped spike turned a healthy
    run to NaN (JAX create_train_state)."""
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    opt = torch.optim.AdamW(
        model.parameters(), lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )
    return TrainState(model, opt, 0, learning_rate, grad_clip)


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g <- (g / ||g||) * max_norm for
    every g where the global norm ||g|| >= max_norm, else unchanged, without
    a host sync. Returns the global norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


def _make_step_body(cfg, loss_fn: Callable, compute_dtype: torch.dtype):
    def step(state: TrainState, batch: dict):
        model, opt = state.model, state.optimizer
        model.train()
        images = batch["image"]
        dev = images.device
        opt.zero_grad(set_to_none=True)
        # the stochastic-depth masks differ per step and are reproducible:
        # (0, step) seeds them, as JAX folds the step into PRNGKey(0)
        gen = seeded_generator(0, state.step, device=dev)
        with torch.autocast(dev.type, dtype=torch.bfloat16,
                            enabled=compute_dtype == torch.bfloat16):
            out = model(images, generator=gen)
        out = {k: v.float() if v.is_floating_point() else v for k, v in out.items()}
        loss, parts = loss_fn(out, batch, cfg)
        loss.backward()
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:  # as optax: an unreached parameter has a 0 gradient
                p.grad = torch.zeros_like(p)
        if state.grad_clip is not None:
            clip_by_global_norm_([p.grad for p in params], state.grad_clip)
        lr = state.learning_rate
        for g in opt.param_groups:
            g["lr"] = lr(state.step) if callable(lr) else lr
        opt.step()
        state.step += 1
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}
        return state, metrics

    return step


def make_train_step(cfg, loss_fn: Callable = total_loss,
                    compute_dtype: torch.dtype = torch.float32):
    """The train step: (state, batch) -> (state, metrics), updating the
    state in place. batch: ``image`` (B, H, W, 3) normalized NHWC on the
    model's device, plus the gt_* targets of ``losses.total_loss``.
    compute_dtype bfloat16 runs the forward under autocast on the float32
    parameters. The metrics stay on the device (no host sync)."""
    return _make_step_body(cfg, loss_fn, compute_dtype)


def make_train_loop(
    cfg,
    batch_fn: Callable,
    chunk: int,
    loss_fn: Callable = total_loss,
    prepare: Optional[Callable] = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """(state) -> (state, stacked metrics): ``chunk`` steps of
    batch_fn(step) -> prepare -> train step, each metric stacked to
    (chunk,). batch_fn takes the absolute step (``data.make_step_batch_fn``),
    so the stream stays seekable across restarts."""
    step_body = _make_step_body(cfg, loss_fn, compute_dtype)

    def loop(state: TrainState):
        rows = []
        for _ in range(chunk):
            batch = batch_fn(state.step)
            if prepare is not None:
                batch = prepare(batch)
            state, m = step_body(state, batch)
            rows.append(m)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    return loop
