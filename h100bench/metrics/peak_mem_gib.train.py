"""torch.cuda.max_memory_allocated over the window, reset at its start, GiB."""


def read(ctx):
    b = ctx.get("window_peak_bytes")
    return b / 2**30 if b else None
