"""A profiled stretch of a run and what the benchmark reads from its trace.

``profile`` runs a function under ``torch.profiler``, synchronized on both
ends, writes the Chrome trace to the run's temporary directory, reads it
back and deletes it. By default it records the device's activity alone
(CUPTI: kernels, copies, sets and the runtime calls), which costs the host
little, so the device's idle share reads as in an untraced run; the window
runs from the end of the first synchronize to the end of the last. With
``host=True`` it records the host's ops and ranges too, inside a
``record_function`` range that is the window; that slows the host's issue,
so its idle share reads high, but it tells what the host was doing. ``Trace``
then gives:

* the window and the device's busy time in it (the union of kernel, copy
  and set intervals);
* the device operations that took most time, summed by name;
* the idle gaps of the device, each labelled by the innermost host event
  (an op, a runtime call or a benchmark range) running at its middle, summed
  by label;
* the device time of the kernels launched inside named host ranges: a
  kernel belongs to the range in which its launch call (matched by CUPTI's
  correlation id) ran on the host.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

import torch

WINDOW = "h100bench.window"
_DEVICE = {"kernel", "gpu_memcpy", "memcpy", "gpu_memset", "memset"}
_LAUNCH = {"cuda_runtime", "runtime", "cuda_driver", "driver"}
_HOST = {"cpu_op", "user_annotation"} | _LAUNCH
_LABELLED_GAPS = 5000


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile(fn, device, host: bool = False) -> "Trace":
    """Trace one call of ``fn()``; ``host``: the host's activity too (on
    the CPU it always is: there is no device activity to record)."""
    cuda = torch.device(device).type == "cuda"
    host = host or not cuda
    acts = [torch.profiler.ProfilerActivity.CPU] if host else []
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            _sync(device)
            fn()
            _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """What the benchmark reads from one profiled window (times in s)."""

    def __init__(self, events: list):
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        for e in spans:
            e["cat"] = str(e.get("cat", "")).lower()
        win = [e for e in spans if e["cat"] == "user_annotation" and e["name"] == WINDOW]
        if win:
            w = win[0]
            self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        else:  # device activity alone: between the first and last synchronize
            syncs = sorted(float(e["ts"]) + float(e["dur"]) for e in spans
                           if e["cat"] in _LAUNCH and "Synchronize" in e["name"])
            if len(syncs) < 2:
                raise ValueError("the trace holds neither the benchmark's window nor its synchronizes")
            self.t0, self.t1 = syncs[0], syncs[-1]
            w = {"tid": None}
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.device = [e for e in spans if e["cat"] in _DEVICE
                       and float(e["ts"]) < self.t1 and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        busy = _merge([(max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1))
                       for e in self.device])
        self._busy = busy
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        self._host = sorted((e for e in spans if e["cat"] in _HOST and e["tid"] == w["tid"]
                             and e is not w), key=lambda e: float(e["ts"]))
        self._launch = {e["args"]["correlation"]: float(e["ts"]) for e in spans
                        if e["cat"] in _LAUNCH and "correlation" in e.get("args", {})}

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for e in self.device:
            by[e["name"]] += float(e["dur"]) * 1e-6
        return [[name, s] for name, s in by.most_common(top)]

    def _label(self, t: float, starts: list) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 2000, -1), -1):
            e = self._host[j]
            if float(e["ts"]) + float(e["dur"]) >= t:
                return e["name"]
        return "python"

    def idle_gaps(self, top: int = 10) -> list:
        """Idle seconds of the device in the window, summed by what the host
        was doing (the longest gaps labelled, the rest summed apart)."""
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        gaps = [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps.sort(reverse=True)
        starts = [float(e["ts"]) for e in self._host]
        by = collections.Counter()
        for length, a, b in gaps[:_LABELLED_GAPS]:
            by[self._label((a + b) / 2, starts)] += length * 1e-6
        rest = sum(g[0] for g in gaps[_LABELLED_GAPS:]) * 1e-6
        if rest:
            by["(shorter gaps)"] += rest
        return [[name, s] for name, s in by.most_common(top)]

    def kernel_s_by_range(self, prefix: str) -> dict:
        """Device seconds of the kernels launched inside each host range
        whose name starts with ``prefix``, by range name."""
        ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                         for e in self._host if e["cat"] == "user_annotation"
                         and e["name"].startswith(prefix)))
        starts = [r[0] for r in ranges]
        out = collections.Counter()
        for k in self.kernels:
            t = self._launch.get(k.get("args", {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                out[ranges[i][2]] += float(k["dur"]) * 1e-6
        return dict(out)
