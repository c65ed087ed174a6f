"""``batch``: ``PerspectiveFields.inference_batch`` on ``batch`` uint8 BGR
frames a call, closed loop, back to back.

Traffic: ``batch``, ``image_hw``, ``pool`` (distinct frames; call i sends
frames i*batch.. modulo the pool), ``warm_calls``, ``check.calls`` (calls
whose answers are compared, drawn from the seed among the first
``check.from_calls_per_s`` x seconds calls), ``profile.calls``.

The window counts the images of every call that returned (its results in
host numpy). With ``--trace 1`` the network sits behind the synchronized
wrap for the window (per-call preprocess, forward and postprocess), then a
profiled stretch of ``profile.calls`` calls gives the device's busy time,
and a second, with the host traced and a range around each MiT block, the
host's activity in the idle gaps and the blocks' kernel time.
"""

from __future__ import annotations

import math
import time

import numpy as np

from ..yardstick import trace, traffic
from ..yardstick.synced import SyncedModule
from . import common

CONTROL = common.CONTROL


def _calls(frames: np.ndarray, batch: int) -> list[list]:
    n = len(frames)
    cycle = n // math.gcd(n, batch)
    return [[frames[(c * batch + j) % n] for j in range(batch)] for c in range(cycle)]


def setup(run):
    tr = run.traffic
    frames = traffic.frame_pool(run.seed, tr["pool"], *tr["image_hw"])
    run.mark("traffic made")
    model = common.perspective_fields(run.config, common.state_dict(run.config, run.seed, run.device),
                                      run.device)
    run.mark("program built")
    calls = _calls(frames, tr["batch"])
    # the warm-up's results are held until all have returned, so the pinned
    # host pool already has the blocks that the kept calls will hold
    held = [model.inference_batch(calls[i % len(calls)]) for i in range(tr["warm_calls"])]
    common.sync(run.device)
    del held
    return {"model": model, "calls": calls, "frames": frames}


def window(run, st):
    tr, model, calls = run.traffic, st["model"], st["calls"]
    chk = tr["check"]
    st["check_at"] = set(traffic.sample(
        run.seed, max(chk["calls"], int(chk["from_calls_per_s"] * run.seconds)), chk["calls"]))
    kept, times = {}, []
    if run.trace:
        inner = model.model
        model.model = wrap = SyncedModule(inner, run.device)
    i = failed = 0
    t0 = run.start_window()
    while True:
        ts = time.perf_counter()
        try:
            res = model.inference_batch(calls[i % len(calls)])
        except Exception as exc:  # a failed call counts against the window
            failed += tr["batch"]
            run.log(f"call {i} failed: {exc!r}")
        else:
            if i in st["check_at"]:
                kept[i] = res
        te = time.perf_counter()
        times.append((ts, te))
        i += 1
        if te - t0 >= run.seconds:
            break
    run.ctx.update(window_s=te - t0, images=i * tr["batch"], attempted=i * tr["batch"],
                   failed=failed, batch=tr["batch"])
    if run.trace:
        model.model = inner
        run.ctx["span_ms"] = wrap.split_ms(times)
    st["kept"] = kept


def profile(run, st):
    model, calls, n = st["model"], st["calls"], run.traffic["profile"]["calls"]
    before = common.kernel_launches()

    def stretch():
        for i in range(n):
            model.inference_batch(calls[i % len(calls)])

    def with_block_ranges():
        with common.block_ranges(model.model.backbone):
            stretch()

    run.ctx["trace"] = trace.profile(stretch, run.device)
    after = common.kernel_launches()
    run.log(f"kernel launches a forward: { {k: (after[k] - before[k]) / n for k in after} }")
    run.ctx["host_trace"] = trace.profile(with_block_ranges, run.device, host=True)
    run.ctx["profiled_forwards"] = n


def release(run, st):
    st.pop("model")
    st.pop("calls")
    common.free(run.device)


def samples(run, st) -> tuple[list, list]:
    """The compared frames and the program's answers for them."""
    frames, answers = [], []
    calls = _calls(st["frames"], run.traffic["batch"])
    for i, res in sorted(st["kept"].items()):
        frames += calls[i % len(calls)]
        answers += res
    return frames, answers


def check(run, st, control=None):
    frames, answers = samples(run, st)
    if not answers:
        run.problems.append("no checked call returned")
        return
    common.check_answers(run, frames, answers, None, control)
