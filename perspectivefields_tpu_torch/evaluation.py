"""Evaluation metrics for perspective fields and camera parameters.

Port of perspectivefields_tpu/evaluation.py: the paper's metrics (arXiv
2212.03239), per-pixel up-vector angular error, per-pixel latitude error and
absolute camera-parameter errors, as batched tensor code. ``evaluate_pairs``
accumulates on the model's device and reads the results back once, at the
end (JAX reads each batch's sums back as it goes); the numbers are the same:
per-batch float32 sums added in float64, float32 histogram counts.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ops.codec import decode_bin, decode_bin_latitude


def up_angular_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-pixel angle (degrees) between predicted and GT up-vectors,
    (..., 2) each. Invalid GT pixels (zero vectors) give 0; mask with
    ``||gt|| > 0`` for means."""
    dot = (pred * gt).sum(dim=-1)
    norm = torch.linalg.vector_norm(pred, dim=-1) * torch.linalg.vector_norm(gt, dim=-1)
    valid = norm > 1e-8
    cos = (dot / torch.where(valid, norm, torch.ones_like(norm))).clamp(-1.0, 1.0)
    return torch.where(valid, torch.rad2deg(torch.arccos(cos)), torch.zeros_like(cos))


def latitude_error(pred_deg: torch.Tensor, gt_deg: torch.Tensor) -> torch.Tensor:
    """Per-pixel absolute latitude error in degrees."""
    return (pred_deg - gt_deg).abs()


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median (the mean of the two middle values for an even
    count; NaNs ignored), which ``torch.median`` is not (it takes the
    lower one)."""
    return torch.nanquantile(x.flatten().double(), 0.5).float()


def field_metrics(pred_up: torch.Tensor, gt_up: torch.Tensor, pred_lat_deg: torch.Tensor,
                  gt_lat_deg: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean / median up angular error and latitude error over a batch.
    Shapes: up (B, H, W, 2), latitude (B, H, W)."""
    ang = up_angular_error(pred_up, gt_up)
    mask = torch.linalg.vector_norm(gt_up, dim=-1) > 1e-8
    ang_mean = (ang * mask).sum() / mask.sum().clamp_min(1)
    lat = latitude_error(pred_lat_deg, gt_lat_deg)
    return {
        "up_mean_deg": ang_mean,
        "up_median_deg": _median(torch.where(mask, ang, torch.full_like(ang, float("nan")))),
        "lat_mean_deg": lat.mean(),
        "lat_median_deg": _median(lat),
    }


# The global medians' resolution: errors lie in [0, 180] degrees, and
# 0.1-degree bins give a streamed median exact to the bin width in O(1)
# memory. The counts are float32, as JAX's, so a bin is exact up to 2^24.
_MEDIAN_BINS = 1800


def _err_hist(err: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Degree errors of any shape -> (_MEDIAN_BINS,) float32 weighted counts."""
    idx = (err.clamp(0.0, 180.0) * (_MEDIAN_BINS / 180.0)).to(torch.int64).clamp_max(_MEDIAN_BINS - 1)
    return torch.bincount(
        idx.flatten(), weights=weights.flatten().to(torch.float32), minlength=_MEDIAN_BINS
    ).to(torch.float32)


def _hist_median(hist) -> float:
    """Median (the lower edge of its 0.1-degree bin) from an error
    histogram: exact for point masses at bin edges (a perfect predictor's
    zeros), at most a bin width off otherwise."""
    hist = np.asarray(hist.cpu() if isinstance(hist, torch.Tensor) else hist)
    total = hist.sum()
    if total <= 0:
        return 0.0
    i = int(np.searchsorted(np.cumsum(hist), total / 2.0))
    return i * 180.0 / _MEDIAN_BINS


def evaluate_pairs(model, batches, max_samples: int | None = None) -> Dict[str, float]:
    """The paper's metrics over an iterable of (image, GT field) batches.

    Means are exact (mask-weighted sums over every pixel); medians are
    global dataset medians streamed through 0.1-degree histograms (not
    per-batch medians averaged). Classification heads are decoded by
    argmax, as postprocess does, so any zoo version or config works.

    The images go in as (image - pixel_mean) / pixel_std through
    ``model._forward_prenormalized_fn``, as JAX's ``evaluate_pairs`` does;
    the trainer subtracts ``pixel_mean`` only (JAX's tools/train.py). The
    two are ported as they are.

    Camera-parameter errors, when a batch carries ``cams``, are taken
    against a centred principal point (general_vfov = vfov, rel_cx = rel_cy
    = 0), which the synthetic crops have; JAX does the same.

    Args:
        model: a ``PerspectiveFields``.
        batches: dicts as ``data.data_iterator`` yields them: ``image``
            (B, H, W, 3) float RGB at the network size, un-normalized;
            ``gt_gravity`` (B, H, W, 2); ``gt_latitude`` (B, H, W, 1)
            sin(lat); optionally ``cams`` (radians).
        max_samples: stop after at least this many images (None: exhaust
            the iterable).

    Returns:
        the metrics (degrees) and ``samples`` (the image count).
    """
    cfg = model.cfg
    dev = model.device
    mean = torch.tensor(cfg.pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(cfg.pixel_std, dtype=torch.float32, device=dev)
    predict_params = tuple(getattr(cfg.param, "predict_params", ()) or ())
    acc = torch.zeros(3, dtype=torch.float64, device=dev)  # up sum, up count, latitude sum
    lat_cnt = 0
    up_hist = torch.zeros(_MEDIAN_BINS, dtype=torch.float32, device=dev)
    lat_hist = torch.zeros(_MEDIAN_BINS, dtype=torch.float32, device=dev)
    param_totals: Dict[str, torch.Tensor] = {}
    n = 0
    with torch.inference_mode():
        for batch in batches:
            b = int(batch["image"].shape[0])
            image = batch["image"].to(dev, torch.float32)
            raw = model._forward_prenormalized_fn((image - mean) / std)
            pg = raw["pred_gravity"].float()
            if cfg.gravity.loss_type == "classification":
                pred_up = decode_bin(pg.argmax(dim=-1), cfg.gravity.num_classes)
            else:
                pred_up = pg
            pl = raw["pred_latitude"].float()
            if cfg.latitude.loss_type == "classification":
                pred_lat = decode_bin_latitude(pl.argmax(dim=-1), cfg.latitude.num_classes)
            else:
                pred_lat = torch.rad2deg(torch.arcsin(pl[..., 0].clamp(-1, 1)))
            gt_up = batch["gt_gravity"].to(dev)
            gt_lat = torch.rad2deg(torch.arcsin(batch["gt_latitude"].to(dev)[..., 0]))

            ang = up_angular_error(pred_up, gt_up)
            mask = (torch.linalg.vector_norm(gt_up, dim=-1) > 1e-8).float()
            lat = latitude_error(pred_lat, gt_lat)
            acc += torch.stack([(ang * mask).sum(), mask.sum(), lat.sum()]).double()
            lat_cnt += lat.numel()
            up_hist += _err_hist(ang, mask)
            lat_hist += _err_hist(lat, torch.ones_like(lat))

            if "cams" in batch:
                cams = {k: v.to(dev) for k, v in batch["cams"].items()}
                zeros = torch.zeros_like(cams["roll"])
                gt_map = {
                    "roll": torch.rad2deg(cams["roll"]),
                    "pitch": torch.rad2deg(cams["elevation"]),
                    "vfov": torch.rad2deg(cams["vfov"]),
                    # synthetic crops are centred: general_vfov == vfov, and
                    # the principal-point offsets are exactly zero
                    "general_vfov": torch.rad2deg(cams["vfov"]),
                    "rel_cx": zeros,
                    "rel_cy": zeros,
                }
                for key in predict_params:
                    pk = f"pred_{key}"
                    if pk in raw and key in gt_map:
                        err = (raw[pk].float() - gt_map[key]).abs().sum().double()
                        k = f"{key}_abs_err"
                        param_totals[k] = param_totals[k] + err if k in param_totals else err
            n += b
            if max_samples is not None and n >= max_samples:
                break
    if n == 0:
        raise ValueError("evaluate_pairs: empty iterable")
    keys = list(param_totals)
    vals = torch.cat([acc, torch.stack([param_totals[k] for k in keys])]) if keys else acc
    vals = vals.tolist()  # the one host sync
    up_sum, up_cnt, lat_sum = vals[:3]
    out = {
        "up_mean_deg": up_sum / max(up_cnt, 1.0),
        "up_median_deg": _hist_median(up_hist),
        "lat_mean_deg": lat_sum / max(lat_cnt, 1.0),
        "lat_median_deg": _hist_median(lat_hist),
    }
    out.update({k: v / n for k, v in zip(keys, vals[3:])})
    out["samples"] = n
    return out


def param_errors(pred: Dict, gt: Dict) -> Dict[str, torch.Tensor]:
    """Absolute errors for the parameters both dicts hold (roll / pitch /
    vfov in degrees, rel_* unitless)."""
    out = {}
    for key in ("roll", "pitch", "vfov", "general_vfov", "rel_cx", "rel_cy", "rel_focal"):
        pk = f"pred_{key}"
        if pk in pred and key in gt:
            out[f"{key}_abs_err"] = (torch.as_tensor(pred[pk]) - torch.as_tensor(gt[key])).abs()
    return out
