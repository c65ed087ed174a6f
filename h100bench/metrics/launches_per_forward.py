"""Kernels launched inside the program's ``pf.forward`` span, per span, in
the host-traced stretch."""

from h100bench import spans


def read(ctx):
    return spans.launches(ctx.get("host_trace"), "pf.forward")
