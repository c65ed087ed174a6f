"""Images of every training step of the window, over its seconds (the window
ends on a synchronize)."""


def read(ctx):
    return ctx["steps"] * ctx["batch"] / ctx["window_s"] if ctx.get("steps") else None
