"""BatchPredictor's preprocess stage per dispatched batch, ms."""

from h100bench.readers import stage_ms_per_batch


def read(ctx):
    return stage_ms_per_batch(ctx, "preprocess")
