"""Device time of the kernels, copies and sets launched inside the
program's ``train.step`` span, per step, in the host-traced stretch, ms."""

from h100bench import spans


def read(ctx):
    return spans.device_ms(ctx.get("host_trace"), "train.step")
