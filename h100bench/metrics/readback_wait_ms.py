"""Host time in the program's ``pf.wait`` span (the wait for the copies
back), per span, in the host-traced stretch, ms. A call holds one
``pf.wait``, so this is the wait per call: how far the device lags behind
the host's issue. Host tracing slows the issue, so the device catches up and
this reads lower than the lag of an untraced run, near 0 even where that run
waits: compare it only with itself."""

from h100bench import spans


def read(ctx):
    return spans.host_ms(ctx.get("host_trace"), "pf.wait")
