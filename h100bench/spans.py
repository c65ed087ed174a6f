"""The program's own spans in a host-traced stretch (``ctx["host_trace"]``,
a ``yardstick.trace.Trace``): the ``record_function`` ranges that the port's
``utils.profiling.trace`` opens, matched by exact name.

A device operation (kernel, copy or set) belongs to a span when its launch
call, matched by CUPTI's correlation id and on any thread, started on the
host within the span's interval. Each name is matched on its own, so a
kernel launched in a parent span after a child span closed still counts for
the parent (``Trace.kernel_s_by_range`` gives a launch to the range that
started last before it, and drops it when that range had closed). Spans of
one name do not overlap one another.

Where the trace holds no span of the name (a program without spans), every
function here returns None. It reads the ``Trace``'s host events of the
window's thread (``_host``) and its launch times by correlation id
(``_launch``), which ``yardstick/trace.py`` keeps.
"""

from __future__ import annotations

import bisect


def intervals(tr, name: str) -> list:
    """The (start, end) of each span named ``name``, µs, in order."""
    if tr is None:
        return []
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in tr._host
                  if e["cat"] == "user_annotation" and e["name"] == name)


def launched(tr, name: str):
    """The device operations each span named ``name`` launched: one list a
    span, in the spans' order; None where there is no such span."""
    spans = intervals(tr, name)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    out = [[] for _ in spans]
    for op in tr.device:
        t = tr._launch.get(op.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            out[i].append(op)
    return out


def host_ms(tr, name: str):
    """The mean host time of a span named ``name``, ms."""
    spans = intervals(tr, name)
    return sum(b - a for a, b in spans) * 1e-3 / len(spans) if spans else None


def launches(tr, name: str):
    """The mean count of kernels a span named ``name`` launched."""
    ops = launched(tr, name)
    return sum(1 for span in ops for op in span if op["cat"] == "kernel") / len(ops) if ops else None


def device_ms(tr, name: str):
    """The mean device time of the kernels, copies and sets a span named
    ``name`` launched, ms (their durations summed, overlaps counted
    twice)."""
    ops = launched(tr, name)
    return sum(float(op["dur"]) for span in ops for op in span) * 1e-3 / len(ops) if ops else None

