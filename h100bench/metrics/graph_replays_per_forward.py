"""The program's ``pf.graph_replay`` spans over its ``pf.forward`` spans in
the host-traced stretch: the share of forwards that replayed a CUDA graph
instead of issuing the network's launches one by one. 0.0 where forwards
ran but none replayed; None where the trace has no ``pf.forward``."""

from h100bench import spans


def read(ctx):
    tr = ctx.get("host_trace")
    forwards = spans.intervals(tr, "pf.forward")
    if not forwards:
        return None
    return len(spans.intervals(tr, "pf.graph_replay")) / len(forwards)
