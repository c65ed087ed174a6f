"""Share of the profiled window with nothing running on the device, %."""

from h100bench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
