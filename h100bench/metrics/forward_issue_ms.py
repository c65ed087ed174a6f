"""Host time of the program's ``pf.forward`` span (the copy in's, the device
normalize's and the network's issue), per span, in the host-traced stretch,
ms. The host's tracing slows the issue: compare it only with itself."""

from h100bench import spans


def read(ctx):
    return spans.host_ms(ctx.get("host_trace"), "pf.forward")
