"""Images whose results reached host numpy in the window, over its seconds."""


def read(ctx):
    return ctx["images"] / ctx["window_s"] if ctx.get("images") else None
