"""CPU stand-ins for the CUDA-graph cache (``utils.cuda_graphs``), shared by
the tests of its two clients: a fake graph, a stub of the capture primitive
and the counters read as a tuple."""

import contextlib
import time

from torch.utils._pytree import tree_leaves

from perspectivefields_tpu_torch.utils import cuda_graphs


class FakeGraph:
    """Captures by running the captured function once; replays by running it
    again and writing what it returns into what the capture returned,
    ``delay`` seconds after the replay starts (other threads run then)."""

    def __init__(self, fn, delay=0.0):
        self.fn, self.delay = fn, delay
        self.out = fn()

    def replay(self):
        time.sleep(self.delay)
        for dst, src in zip(tree_leaves(self.out), tree_leaves(self.fn())):
            dst.copy_(src)


def stub(monkeypatch, delay=0.0) -> list:
    """CPU tensors pass the device check, the capture stream is the caller's
    and a capture is a ``FakeGraph``. Returns the fakes captured, in order."""
    graphs = []

    def capture_graph(state, device, fn, generators=()):
        graphs.append(FakeGraph(fn, delay))
        return graphs[-1], graphs[-1].out

    monkeypatch.setattr(cuda_graphs, "device_reason", lambda t: None)
    monkeypatch.setattr(cuda_graphs, "on_capture_stream", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(cuda_graphs, "capture_graph", capture_graph)
    return graphs


def fail_captures(monkeypatch) -> None:
    """Every capture raises, as one of an unsafe call does on the card."""

    def capture_graph(*args):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(cuda_graphs, "capture_graph", capture_graph)


def counts(c: cuda_graphs.Counts) -> tuple:
    return c.replays, c.captures, c.capture_failures, dict(c.eager)


def delta(c: cuda_graphs.Counts, before: tuple) -> tuple:
    """What ``c`` counted since ``counts(c)`` gave ``before``."""
    r, cap, f, e = counts(c)
    eager = {k: v - before[3].get(k, 0) for k, v in e.items() if v != before[3].get(k, 0)}
    return r - before[0], cap - before[1], f - before[2], eager
