"""Device time of the kernels, copies and sets launched inside the
program's ``pf.forward`` span, per span, in the host-traced stretch, ms.
In ``.batch`` and ``.single`` this includes the input's copy in; in
``.stream`` that copy is issued in ``serving.dispatch`` before
``pf.forward`` and is left out."""

from h100bench import spans


def read(ctx):
    return spans.device_ms(ctx.get("host_trace"), "pf.forward")
