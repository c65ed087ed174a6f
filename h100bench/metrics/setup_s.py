"""From the start of the process to the first timed call, s."""


def read(ctx):
    return ctx.get("setup_s")
