"""BatchPredictor's dispatch stage (host issue of the copy in, forward,
pack and copies out) per dispatched batch, ms."""

from h100bench.readers import stage_ms_per_batch


def read(ctx):
    return stage_ms_per_batch(ctx, "dispatch")
