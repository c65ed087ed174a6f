"""``single``: ``PerspectiveFields.inference`` on one uint8 BGR image a
request, one closed-loop client.

Traffic: ``sizes_hw`` (sent in seeded rounds, one of each size a round, so
every seed sends the same work), ``pool_per_size`` (distinct frames of each
size, sent in turn), ``warm_rounds``, ``check.requests`` (requests compared,
drawn from the seed among the first ``check.from_requests_per_s`` x seconds
requests; each is copied to pageable memory after its latency is taken),
``profile.requests``.

Each request is timed from the call to its returned arrays. With ``--trace
1`` the network sits behind the synchronized wrap for the window, then a
profiled stretch of ``profile.requests`` requests follows.
"""

from __future__ import annotations

import time

import numpy as np

from ..yardstick import trace, traffic
from ..yardstick.synced import SyncedModule
from . import common

CONTROL = common.CONTROL


class _Requests:
    """The request stream: the size of each request in seeded rounds, the
    frame the next of its size in turn."""

    def __init__(self, seed: int, pools: list, rounds: int):
        self.pools, self.seed = pools, seed
        self.order = traffic.size_order(seed, len(pools), rounds)
        self.sent = [0] * len(pools)

    def frame(self, i: int):
        if i >= len(self.order):  # past the rounds made ahead: make twice as many
            self.order = traffic.size_order(self.seed, len(self.pools), 2 * len(self.order))
        s = self.order[i]
        f = self.pools[s][self.sent[s] % len(self.pools[s])]
        self.sent[s] += 1
        return f


def _pools(run) -> list:
    tr = run.traffic
    return [traffic.frame_pool(run.seed, tr["pool_per_size"], h, w, which=k)
            for k, (h, w) in enumerate(tr["sizes_hw"])]


def setup(run):
    tr = run.traffic
    pools = _pools(run)
    run.mark("traffic made")
    model = common.perspective_fields(run.config, common.state_dict(run.config, run.seed, run.device),
                                      run.device)
    run.mark("program built")
    for _ in range(tr["warm_rounds"]):
        for pool in pools:
            model.inference(pool[0])
    common.sync(run.device)
    return {"model": model, "pools": pools}


def window(run, st):
    tr, model = run.traffic, st["model"]
    chk = tr["check"]
    check_at = set(traffic.sample(
        run.seed, max(chk["requests"], int(chk["from_requests_per_s"] * run.seconds)), chk["requests"]))
    reqs = _Requests(run.seed, st["pools"], int(200 * run.seconds) + 64)
    kept, lat, times = {}, [], []
    if run.trace:
        inner = model.model
        model.model = wrap = SyncedModule(inner, run.device)
    i = failed = 0
    t0 = run.start_window()
    while True:
        img = reqs.frame(i)
        ts = time.perf_counter()
        try:
            res = model.inference(img)
        except Exception as exc:  # a failed request counts against the window
            failed += 1
            run.log(f"request {i} failed: {exc!r}")
            res = None
        te = time.perf_counter()
        lat.append((te - ts) * 1e3)
        times.append((ts, te))
        if res is not None and i in check_at:
            kept[i] = (img, {k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in res.items()})
        i += 1
        if te - t0 >= run.seconds:
            break
    run.ctx.update(window_s=te - t0, latencies_ms=lat, attempted=i, failed=failed)
    if run.trace:
        model.model = inner
        run.ctx["span_ms"] = wrap.split_ms(times)
    st["kept"] = kept


def profile(run, st):
    model, n = st["model"], run.traffic["profile"]["requests"]
    reqs = _Requests(run.seed + 1, st["pools"], n)

    def stretch():
        for i in range(n):
            model.inference(reqs.frame(i))

    run.ctx["trace"] = trace.profile(stretch, run.device)
    run.ctx["host_trace"] = trace.profile(stretch, run.device, host=True)


def release(run, st):
    st.pop("model")
    common.free(run.device)


def check(run, st, control=None):
    kept = [st["kept"][i] for i in sorted(st["kept"])]
    if not kept:
        run.problems.append("no checked request returned")
        return
    frames = [img for img, _ in kept]
    answers = [res for _, res in kept]
    common.check_answers(run, frames, answers, None, control)
