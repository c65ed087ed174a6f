"""Kernels launched inside the program's ``train.step`` span, per step, in
the host-traced stretch."""

from h100bench import spans


def read(ctx):
    return spans.launches(ctx.get("host_trace"), "train.step")
