"""The 95th percentile (linear interpolation) of every request of the window,
each timed from the call to its returned arrays, ms."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
