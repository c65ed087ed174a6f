"""Host time of the program's ``train.step`` span, per step, in the
host-traced stretch, ms. The host's tracing slows the issue: compare it
only with itself."""

from h100bench import spans


def read(ctx):
    return spans.host_ms(ctx.get("host_trace"), "train.step")
