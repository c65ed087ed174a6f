"""Mean postprocess time of a call in the window, from the synchronized wrap, ms."""

from h100bench.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "postprocess")
