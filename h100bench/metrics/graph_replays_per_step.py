"""The program's ``train.graph_replay`` spans over its ``train.step`` spans
in the host-traced stretch: the share of train steps that replayed a CUDA
graph instead of issuing the step's launches one by one. 0.0 where steps
ran but none replayed; None where the trace has no ``train.step``."""

from h100bench import spans


def read(ctx):
    tr = ctx.get("host_trace")
    steps = spans.intervals(tr, "train.step")
    if not steps:
        return None
    return len(spans.intervals(tr, "train.graph_replay")) / len(steps)
