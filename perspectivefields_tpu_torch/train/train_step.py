"""The training step: AdamW with a global-norm clip, under bf16 autocast.

Port of perspectivefields_tpu/train/train_step.py. ``TrainState`` holds the
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

Reproducible on the card, as JAX's step is on a TPU: the forward and
backward run with cuDNN's deterministic convolution algorithms, and the
heads' upsampling has a backward without atomic adds
(``ops.image.up2x_bilinear``), so a seeded run gives the same losses every
time.

On one CUDA device without a mesh, a step replays as one CUDA graph per
batch signature (``graphed_step``, whose docstring has the rules): the
first step of a signature runs eager, the second captures the graph, and
each later step is one graph launch in place of the forward's and
backward's kernel launches, most of an eager step's ~8,900. The graph holds
the zero-grad, the forward under autocast, the losses, the remat backward
and the clip, and gives the eager step's numbers bit for bit (the same
dtypes, deterministic cuDNN algorithms and per-step stochastic-depth
seeds). The AdamW update runs eager after it, on every path, as it is built
here: a capturable AdamW computes its bias corrections in float32 on the
card, and its trajectory would then differ by rounding from the float-lr
one that the CPU and a mesh take. Counters: ``graphed_step.COUNTS``
(``replays``, ``captures``, ``capture_failures`` and ``eager`` by reason:
``cpu``, ``mesh``, ``hooks``, ``first_of_signature``, ``capture_failed``, ...).
Every step opens the span ``train.step`` and, inside it,
``train.optimizer``. An eager step also opens ``train.forward``,
``train.loss``, ``train.backward`` and ``train.clip``; a replay opens
``train.graph_replay`` in their place, and a capture
``train.graph_capture`` around the capture's own (host-only) phase spans.

JAX's ``make_train_loop`` runs ``chunk`` steps in one XLA program
(``lax.scan``); here it is a Python loop of ``chunk`` steps that returns
their metrics stacked.

With a (data, model) ``mesh`` (``parallel.make_mesh``) each rank steps on
its own rows of the global batch (``parallel.batch_rows``) and the step is
the one-process step on the whole batch, as JAX's GSPMD step is: the
losses' denominators are summed over the data group in one all-reduce
(``losses.global_denominators``), so the ranks' gradients sum to the
global loss's; one all-reduce over the data group sums them, and the clip
and the AdamW update then run on the same gradient on every rank of it;
the stochastic-depth masks are the global batch's rows. A model axis > 1
splits the ruled Linears over it (``parallel.tensor_parallel``, the layout
of ``parallel.param_shardings``): each rank holds, steps and keeps AdamW
state for its shards only, as GSPMD's optax state is split; the rest of
the model, its gradients and its state are replicated, bit-equal across
the model group; the clip's norm sums the shards' squares over the model
group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..data import seed_of
from ..parallel.tensor_parallel import model_shard, unsplit_ruled
from ..utils.profiling import trace
from . import graphed_step
from .losses import global_denominators, total_loss

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
    mesh=None,
) -> TrainState:
    """Wrap an initialised float32 ``model`` (on its device) with AdamW.

    learning_rate: a float or a function of the step (optax's schedule: the
    update that makes step k + 1 uses ``learning_rate(k)``).
    grad_clip: the global-norm clip (None turns it off). It is on by
    default: the masked field losses spike on batches whose cameras give
    mostly invalid fields, and in JAX an unclipped spike turned a healthy
    run to NaN (JAX create_train_state).
    mesh: every rank's parameters become the mesh's first rank's
    (``parallel.replicate``), so the ranks start as one; on a model axis > 1
    the ruled Linears are then split over it, in place
    (``parallel.tensor_parallel.split_model_``), before AdamW is built, so
    the optimizer holds this rank's shards only. The split raises where the
    model cannot be split (a kernel route on)."""
    if mesh is not None:
        from ..parallel import replicate
        from ..parallel.tensor_parallel import split_model_

        replicate(mesh, model)
        split_model_(model, mesh)
    lr0 = learning_rate(0) if callable(learning_rate) else learning_rate
    opt = torch.optim.AdamW(
        model.parameters(), lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )
    return TrainState(model, opt, 0, learning_rate, grad_clip)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: a linear ramp from init_value to
    peak_value over warmup_steps, then a cosine decay to end_value that ends
    at step decay_steps (which counts the warmup) and holds there."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")

    def schedule(step: int) -> float:
        if step < warmup_steps:  # optax's linear_schedule; warmup 0 skips it
            return init_value + (peak_value - init_value) * step / warmup_steps
        t = min(step - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         shard_grads: Sequence[torch.Tensor] = (), group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g <- (g / ||g||) * max_norm for
    every g where the global norm ||g|| >= max_norm, else unchanged, without
    a host sync. Returns the global norm.

    shard_grads: the gradients of parameters split over the model group
    ``group`` (``parallel.tensor_parallel``); their squared norms are summed
    over the group, the replicated ``grads``' counted once."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if shard_grads:
        shard_sq = torch.stack(torch._foreach_norm(list(shard_grads))).square().sum()
        dist.all_reduce(shard_sq, group=group)
        norm = torch.sqrt(norm.square() + shard_sq)
        grads = list(grads) + list(shard_grads)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


def _data_group(mesh):
    """(process group, size, index) of this rank on the mesh's data axis."""
    return mesh.get_group("data"), mesh["data"].size(), mesh.get_local_rank("data")


def _all_reduce_sum(tensors: list[torch.Tensor], group) -> None:
    """Sum each tensor over the group in place, in one all-reduce."""
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    for t, r in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(r)


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic convolution algorithms, the caller's setting
    restored after."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _make_step_body(cfg, loss_fn: Callable, compute_dtype: torch.dtype, mesh=None):
    group = model_group = None
    n_model = 1
    if mesh is not None:
        group, n_data, index = _data_group(mesh)
        if "model" in mesh.mesh_dim_names:
            n_model = mesh["model"].size()
            model_group = mesh.get_group("model")
    checked = set()

    def sum_counts(counts: list[torch.Tensor]) -> list[torch.Tensor]:
        _all_reduce_sum(counts, group)
        return counts

    def step(state: TrainState, batch: dict):
        with trace("train.step"):
            model = state.model
            if n_model > 1 and id(model) not in checked:
                whole = unsplit_ruled(model, n_model)
                if whole:  # no silent fallback to the replicated layout
                    raise ValueError(f"a model axis of {n_model} splits {len(whole)} tensors "
                                     f"this model holds whole ({whole[:3]}...): make the state "
                                     "with create_train_state(model, mesh=mesh)")
                checked.add(id(model))
            model.train()
            # the stochastic-depth masks differ per step and are reproducible:
            # (0, step) seeds them, as JAX folds the step into PRNGKey(0)
            seed = seed_of(0, state.step)
            if mesh is None:
                metrics = graphed_step.step(state, batch, phases, seed,
                                            (cfg, loss_fn, compute_dtype, state.grad_clip))
            else:  # the collectives stay eager
                graphed_step.COUNTS.eager["mesh"] += 1
                metrics = phases(state, batch,
                                 torch.Generator(device=batch["image"].device).manual_seed(seed))
            with trace("train.optimizer"):
                lr = state.learning_rate
                for g in state.optimizer.param_groups:
                    g["lr"] = lr(state.step) if callable(lr) else lr
                state.optimizer.step()
            state.step += 1
            return state, metrics

    def phases(state: TrainState, batch: dict, gen: torch.Generator) -> dict:
        """The step's work up to the update: zero-grad, forward, losses,
        backward and clip; the metrics, on the device."""
        model, opt = state.model, state.optimizer
        images = batch["image"]
        dev = images.device
        opt.zero_grad(set_to_none=True)
        rows = None if group is None else (index * images.shape[0], n_data * images.shape[0])
        with _deterministic_cudnn():
            with trace("train.forward"), torch.autocast(
                    dev.type, dtype=torch.bfloat16, enabled=compute_dtype == torch.bfloat16):
                out = model(images, generator=gen, rows=rows)
            with trace("train.loss"):
                out = {k: v.float() if v.is_floating_point() else v for k, v in out.items()}
                if group is None:
                    loss, parts = loss_fn(out, batch, cfg)
                else:
                    reduce = global_denominators(loss_fn, out, batch, cfg, sum_counts)
                    loss, parts = loss_fn(out, batch, cfg, reduce)
            with trace("train.backward"):
                loss.backward()
        params = [p for g in opt.param_groups for p in g["params"]]
        with trace("train.clip"):
            for p in params:
                if p.grad is None:  # as optax: an unreached parameter has a 0 gradient
                    p.grad = torch.zeros_like(p)
            metrics = [loss.detach(), *(v.detach() for v in parts.values())]
            if group is not None:
                # each rank's loss is its share of the global batch's loss
                _all_reduce_sum([p.grad for p in params] + metrics, group)
            if state.grad_clip is not None:
                split = [model_shard(p) is not None for p in params]
                clip_by_global_norm_([p.grad for p, s in zip(params, split) if not s],
                                     state.grad_clip,
                                     [p.grad for p, s in zip(params, split) if s], model_group)
        return dict(zip(["loss", *parts], metrics))

    return step


def make_train_step(cfg, loss_fn: Callable = total_loss,
                    compute_dtype: torch.dtype = torch.float32, mesh=None):
    """The train step: (state, batch) -> (state, metrics), updating the
    state in place. batch: ``image`` (B, H, W, 3) normalized NHWC on the
    model's device, plus the gt_* targets of ``losses.total_loss``.
    compute_dtype bfloat16 runs the forward under autocast on the float32
    parameters. The metrics stay on the device (no host sync). With a
    ``mesh`` the batch is this rank's rows of the global batch, the
    metrics are the global batch's and ``loss_fn`` takes the denominators'
    ``reduce`` as its fourth argument (module docstring)."""
    return _make_step_body(cfg, loss_fn, compute_dtype, mesh)


def make_train_loop(
    cfg,
    batch_fn: Callable,
    chunk: int,
    loss_fn: Callable = total_loss,
    prepare: Optional[Callable] = None,
    compute_dtype: torch.dtype = torch.float32,
    mesh=None,
):
    """(state) -> (state, stacked metrics): ``chunk`` steps of
    batch_fn(step) -> prepare -> train step, each metric stacked to
    (chunk,). batch_fn takes the absolute step (``data.make_step_batch_fn``),
    so the stream stays seekable across restarts; with a ``mesh`` it gives
    this rank's rows (``make_step_batch_fn(..., rows=batch_rows(mesh, B))``)."""
    step_body = _make_step_body(cfg, loss_fn, compute_dtype, mesh)

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
