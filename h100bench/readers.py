"""What the metric readers under ``metrics/`` share. A reader takes the
run's ``ctx`` and returns a number, or None where the run has nothing to
read for it (the harness then leaves the metric out)."""

from __future__ import annotations

import statistics


def span_mean_ms(ctx: dict, stage: str):
    """The mean of one stage of the synchronized wrap's split, ms."""
    spans = ctx.get("span_ms", {}).get(stage)
    return statistics.fmean(spans) if spans else None


def idle_pct(ctx: dict):
    """The share of the profiled window in which no kernel, copy or set
    ran on the device, %."""
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def stage_ms_per_batch(ctx: dict, stage: str):
    """BatchPredictor's stage timer: seconds of ``stage`` per batch the
    window dispatched, ms."""
    entry = ctx.get("timer", {}).get(stage)
    n = ctx.get("batches_dispatched")
    if not entry or not n:
        return None
    return entry["seconds"] * 1e3 / n
