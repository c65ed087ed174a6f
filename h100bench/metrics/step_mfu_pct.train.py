"""Model FLOPs of one training step (forward and backward, FlopCounterMode on
the reference network; remat's recompute not counted) over the window's
time a step, as a share of the bf16 tensor-core peak, %."""

from h100bench.yardstick import flops, roofline


def read(ctx):
    if not ctx.get("steps"):
        return None
    f = flops.train_step_flops(ctx["config"]["model"], ctx["batch"])
    return 100.0 * f * ctx["steps"] / ctx["window_s"] / roofline.PEAK_TC
