"""Model FLOPs of one forward of the call's batch (FlopCounterMode on the
reference network) over the mean forward time of the synchronized wrap, as
a share of the bf16 tensor-core peak, %."""

from h100bench.readers import span_mean_ms
from h100bench.yardstick import flops, roofline


def read(ctx):
    ms = span_mean_ms(ctx, "forward")
    if not ms:
        return None
    f = flops.forward_flops(ctx["config"]["model"], ctx["batch"])
    return 100.0 * f / (ms * 1e-3) / roofline.PEAK_TC
