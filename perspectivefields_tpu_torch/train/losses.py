"""Loss functions on channels-last tensors.

Port of perspectivefields_tpu/train/losses.py; the objectives match the
reference's training losses:

* multi-scale gradient loss: ``msgil_norm_loss`` over 4 dyadic scales of
  masked horizontal / vertical differences of the prediction error
  (reference modeling/persformer_heads/loss_fns.py:5-44);
* gravity regression: 0.1 * msgil + masked L2 over channels, zero-norm
  targets excluded (reference gravity_head.py:199-223);
* latitude regression: 0.1 * msgil + MSE (reference latitude_head.py:221-242),
  plus the overflow penalty on the pre-clamp output;
* classification heads: cross-entropy with ``ignore_index``
  (gravity_head.py:224-232);
* ParamNet: per-parameter MSE or L1 (reference param_network.py:102-128,
  233-241);
* ``meanstd_tanh_norm_loss``: masked MAE + tanh-compressed MAE (reference
  loss_fns.py:46-74).

Masking is by weighted sums, without data-dependent branches, as in JAX.

Data parallelism: every mean here is over the whole batch. ``reduce``
(None on one process) gives a denominator summed over the data-parallel
ranks, so that with each rank's rows the rank's loss is its share of the
global batch's loss: the ranks' losses, and their gradients, sum to the
one-process values whatever each rank's mask counts are. The denominators
carry no gradient and depend only on the batch's masks and shapes, so
``global_denominators`` records every local count first (twelve a step for
the trainer's config: four msgil scales a field head, the two l2 terms, the
overflow penalty, ParamNet's MSE), sums them all in one call and hands them
back in order: one all-reduce a step, before the train step's one
all-reduce of the gradients.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import PARAM_FACTORS

_EPS = 1e-8

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def global_denominators(loss_fn: Callable, outputs: dict, batch: dict, cfg,
                        sum_counts: Callable[[list], list]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ``reduce`` for ``loss_fn(outputs, batch, cfg, reduce)`` whose
    denominators are summed by one call of ``sum_counts`` (a list of local
    counts -> their sums over the ranks, one all-reduce). A first pass of
    ``loss_fn`` without gradient records the local counts in the order it
    asks for them; the returned ``reduce`` hands out their sums in that
    order. The counts are whole numbers in float32, so the sums, and the
    losses, are the ones a separate all-reduce per count gives."""
    counts: list = []

    def record(count: torch.Tensor) -> torch.Tensor:
        counts.append(count)
        return count

    with torch.no_grad():
        loss_fn(outputs, batch, cfg, record)
    totals = iter(sum_counts(counts))
    return lambda count: next(totals)


def _total(count: torch.Tensor, reduce: Reduce) -> torch.Tensor:
    """A denominator over the global batch: ``count`` summed over the
    data-parallel ranks by ``reduce`` (as it is on one process)."""
    return count if reduce is None else reduce(count.detach())


def _mean(x: torch.Tensor, reduce: Reduce) -> torch.Tensor:
    """The global batch's mean of ``x``, this rank's share of it."""
    if reduce is None:
        return x.mean()
    return x.sum() / reduce(x.new_full((), float(x.numel())))


def _one_scale_gradient_loss(diff: torch.Tensor, mask: torch.Tensor, reduce: Reduce = None) -> torch.Tensor:
    """diff, mask: (B, H, W, C); the gradient loss at one scale (stride-2
    differences of the error, masked mean over valid pairs)."""
    mask = mask.to(diff.dtype)
    v_mask = mask[:, :-2, :, :] * mask[:, 2:, :, :]
    v_grad = (diff[:, :-2, :, :] - diff[:, 2:, :, :]).abs() * v_mask
    h_mask = mask[:, :, :-2, :] * mask[:, :, 2:, :]
    h_grad = (diff[:, :, :-2, :] - diff[:, :, 2:, :]).abs() * h_mask
    valid = _total(v_mask.sum() + h_mask.sum(), reduce)
    return (v_grad.sum() + h_grad.sum()) / (valid + _EPS)


def msgil_norm_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                    scales_num: int = 4, reduce: Reduce = None) -> torch.Tensor:
    """Multi-scale gradient loss over power-of-two strided subsamplings.
    pred / gt / mask: (B, H, W, C)."""
    diff = pred - gt
    total = 0.0
    for i in range(scales_num):
        step = 2**i
        total = total + _one_scale_gradient_loss(
            diff[:, ::step, ::step, :], mask[:, ::step, ::step, :], reduce
        )
    return total


def meanstd_tanh_norm_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                           reduce: Reduce = None) -> torch.Tensor:
    """MAE + tanh-compressed MAE over masked pixels, averaged over images.
    Images with <= 100 valid pixels are dropped; 0 when none is left.
    pred / gt / mask: (B, H, W, C)."""
    m = mask.to(pred.dtype)
    per_sum = m.sum(dim=(1, 2, 3))
    keep = (per_sum > 100).to(pred.dtype)
    cnt = per_sum.clamp_min(1.0)
    mae = ((gt - pred).abs() * m).sum(dim=(1, 2, 3)) / cnt
    tanh_mae = ((torch.tanh(0.01 * gt) - torch.tanh(0.01 * pred)).abs() * m).sum(dim=(1, 2, 3)) / cnt
    nb = _total(keep.sum(), reduce)
    total = ((mae + tanh_mae) * keep).sum() / nb.clamp_min(1.0)
    return torch.where(nb > 0, total, torch.zeros_like(total))


def gravity_regression_loss(pred: torch.Tensor, target: torch.Tensor, loss_weight: float = 1.0,
                            reduce: Reduce = None):
    """pred / target: (B, H, W, 2) unit fields; zero-norm targets are
    invalid. Reference gravity_head.py:204-218."""
    mask = torch.linalg.vector_norm(target, dim=-1, keepdim=True) > 1e-5
    mask2 = mask.expand(pred.shape)
    msg = 0.1 * msgil_norm_loss(pred, target, mask2, reduce=reduce) * loss_weight
    sq = ((pred - target) ** 2).sum(dim=-1, keepdim=True)
    l2 = (sq * mask).sum() / (_total(mask.sum(), reduce) + _EPS) * loss_weight
    return {"gravity-msg-normal-loss": msg, "gravity-l2-loss": l2}


def latitude_regression_loss(pred: torch.Tensor, target: torch.Tensor, loss_weight: float = 1.0,
                             raw: Optional[torch.Tensor] = None, reduce: Reduce = None):
    """pred / target: (B, H, W, 1) sin(latitude). Reference
    latitude_head.py:225-237.

    raw: the head's pre-clamp output (``latitude_raw`` in training mode).
    The clamp's gradient is 0 outside [-1, 1], so a saturated head cannot
    train on the l2 / msgil terms alone; the quadratic overflow penalty
    gives it a restoring gradient that grows with the overflow."""
    mask = torch.ones_like(pred, dtype=torch.bool)
    msg = 0.1 * msgil_norm_loss(pred, target, mask, reduce=reduce) * loss_weight
    l2 = _mean((pred - target) ** 2, reduce) * loss_weight
    out = {"latitude-msg-normal-loss": msg, "latitude-l2-loss": l2}
    if raw is not None:
        overflow = (raw.abs() - 1.0).clamp_min(0.0)
        out["latitude-sat-loss"] = _mean(overflow**2, reduce) * loss_weight
    return out


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int,
                       loss_weight: float = 1.0, reduce: Reduce = None) -> torch.Tensor:
    """logits (B, H, W, C), int labels (B, H, W); the mean over labels that
    are not ``ignore_index`` (F.cross_entropy's rule, gravity_head.py:224-232)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * valid).sum() / (_total(valid.sum(), reduce) + _EPS) * loss_weight


def param_loss(pred: torch.Tensor, target: torch.Tensor, loss_weight: float = 1.0,
               kind: str = "mse", reduce: Reduce = None) -> torch.Tensor:
    """(B, P) parameter regression loss; kind "mse" or "l1" (reference
    param_network.py:233-241 and :122-124)."""
    if kind == "l1":
        return _mean((pred - target).abs(), reduce) * loss_weight
    return _mean((pred - target) ** 2, reduce) * loss_weight


def total_loss(outputs: dict, batch: dict, cfg, reduce: Reduce = None) -> tuple[torch.Tensor, dict]:
    """All enabled objectives of a ModelConfig; returns (total, parts) with
    JAX's keys. batch keys (each optional, channels-last): gt_gravity
    (B, H, W, 2) or int bins (B, H, W); gt_latitude (B, H, W, 1) or bins;
    gt_params (B, P) in predict_params order, divided by PARAM_FACTORS.
    reduce: the data-parallel denominator sum (module docstring)."""
    losses = {}
    if cfg.gravity is not None and "gt_gravity" in batch:
        if cfg.gravity.loss_type == "regression":
            losses.update(gravity_regression_loss(
                outputs["pred_gravity"], batch["gt_gravity"], cfg.gravity.loss_weight, reduce
            ))
        else:
            losses["loss_gravity"] = cross_entropy_loss(
                outputs["pred_gravity"], batch["gt_gravity"], cfg.gravity.ignore_value,
                cfg.gravity.loss_weight, reduce,
            )
    if cfg.latitude is not None and "gt_latitude" in batch:
        if cfg.latitude.loss_type == "regression":
            losses.update(latitude_regression_loss(
                outputs["pred_latitude"], batch["gt_latitude"], cfg.latitude.loss_weight,
                raw=outputs.get("latitude_raw"), reduce=reduce,
            ))
        else:
            losses["loss_latitude"] = cross_entropy_loss(
                outputs["pred_latitude"], batch["gt_latitude"], cfg.latitude.ignore_value,
                cfg.latitude.loss_weight, reduce,
            )
    if cfg.param_on and "gt_params" in batch:
        keys = cfg.param.predict_params
        pred = torch.stack([outputs["pred_" + k] for k in keys], dim=-1)
        factors = torch.tensor([PARAM_FACTORS[k] for k in keys], device=pred.device)
        losses["param-loss"] = param_loss(pred / factors, batch["gt_params"], cfg.param.loss_weight,
                                          reduce=reduce)
    total = sum(losses.values())
    return total, losses
