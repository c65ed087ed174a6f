"""``stream``: ``serving.BatchPredictor`` over an endless stream of uint8
BGR frames, closed loop: the next frames are handed over as the predictor
asks for them.

Traffic: ``batch``, ``image_hw``, ``pool`` (the stream cycles through the
pool's distinct frames), ``wire``, ``select``, ``depth``, ``out_wire`` (the
predictor's arguments), ``warm_batches``, ``check.images`` (answers compared,
drawn from the seed among all the window returned), ``profile.batches``.

The window counts the answers the predictor returned (whole batches: the
clock is read after each batch's last answer). The predictor's own stage
timer (``BatchPredictor.timer``) is reset at the window's start.
"""

from __future__ import annotations

import time

from ..yardstick import trace, traffic
from . import common

CONTROL = common.CONTROL


def _predictor(run, model):
    from perspectivefields_tpu_torch.serving import BatchPredictor

    tr = run.traffic
    return BatchPredictor(model, batch_size=tr["batch"], wire=tr["wire"], select=tr["select"],
                          depth=tr["depth"], out_wire=tr["out_wire"])


def setup(run):
    tr = run.traffic
    frames = traffic.frame_pool(run.seed, tr["pool"], *tr["image_hw"])
    run.mark("traffic made")
    model = common.perspective_fields(run.config, common.state_dict(run.config, run.seed, run.device),
                                      run.device)
    run.mark("program built")
    pred = _predictor(run, model)
    for _ in pred.predict_iter(list(frames[: tr["warm_batches"] * tr["batch"]])):
        pass
    common.sync(run.device)
    return {"model": model, "pred": pred, "frames": frames}


def window(run, st):
    tr, pred, frames = run.traffic, st["pred"], st["frames"]
    sent = [0]

    def stream():
        while True:
            yield frames[sent[0] % len(frames)]
            sent[0] += 1

    pred.timer = type(pred.timer)()
    results = []
    it = pred.predict_iter(stream())
    t0 = run.start_window()
    for res in it:
        results.append(res)
        if len(results) % tr["batch"] == 0 and time.perf_counter() - t0 >= run.seconds:
            break
    t1 = time.perf_counter()
    it.close()
    common.sync(run.device)
    run.ctx.update(window_s=t1 - t0, images=len(results), attempted=len(results), failed=0,
                   timer=pred.timer.summary(), batches_dispatched=sent[0] // tr["batch"])
    st["results"] = results


def profile(run, st):
    tr, pred, frames = run.traffic, st["pred"], st["frames"]
    n = tr["profile"]["batches"] * tr["batch"]

    def stretch():
        for _ in pred.predict_iter([frames[i % len(frames)] for i in range(n)]):
            pass

    run.ctx["trace"] = trace.profile(stretch, run.device)
    run.ctx["host_trace"] = trace.profile(stretch, run.device, host=True)


def release(run, st):
    st.pop("pred")
    st.pop("model")
    common.free(run.device)


def check(run, st, control=None):
    results, frames = st["results"], st["frames"]
    if not results:
        run.problems.append("the window returned no answer")
        return
    idx = traffic.sample(run.seed, len(results), run.traffic["check"]["images"])
    sample = [frames[i % len(frames)] for i in idx]
    answers = [results[i] for i in idx]
    common.check_answers(run, sample, answers, run.traffic["select"], control)
