"""The train step's CUDA-graph replay (``train.graphed_step``, a client of
``utils.cuda_graphs``).

On the CPU: the step stays eager with its reason counted; the optimizer is
built with a float learning rate and the step's numbers are those of a
plain AdamW step; successive steps return distinct metrics; hooks on the
model keep a step eager; a model no longer used is collected; and the
cache's rules (a signature's first step eager, then a capture and replays;
the update eager after each replay, with the optimizer's hooks; a restored
checkpoint; two graphs a model; a new storage or a failed capture), with
the device check and the capture primitive stubbed (``_cuda_graph_stub``):
a "graph" that reruns the step on its static batch, which must give the
eager steps' numbers bit for bit.

On the card (``cuda``): replayed steps equal eager steps bit for bit in
losses, parameters and AdamW's moments, with stochastic depth, remat, bf16
autocast and a learning-rate schedule; an optimizer state load replays on
and a moved parameter captures again; a restored checkpoint replays; two
batch shapes give two graphs; a loss that reads the host falls back to
eager for good. No JAX: the card's machine has none.
"""

import copy
import functools
import gc
import weakref

import pytest
import torch

from perspectivefields_tpu_torch import config as tc
from perspectivefields_tpu_torch.checkpoint import restore_train_state, save_train_state
from perspectivefields_tpu_torch.data import make_step_batch_fn, seeded_generator
from perspectivefields_tpu_torch.models import PersNet
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.train import (
    clip_by_global_norm_,
    create_train_state,
    graphed_step,
    make_train_loop,
    make_train_step,
    total_loss,
    warmup_cosine_decay_schedule,
)
from perspectivefields_tpu_torch.utils import cuda_graphs
from perspectivefields_tpu_torch.utils.cuda_graphs import FIRST
from _cuda_graph_stub import counts, delta, fail_captures, stub

CFG = tc.ModelConfig(
    version="custom",
    backbone=tc.BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 2, 1), num_heads=(1, 2, 3, 4),
                               drop_path_rate=0.1),
    gravity=tc.GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    latitude=tc.LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    param=tc.ParamNetConfig(name="ParamNetConvNextRegress",
                            predict_params=("roll", "pitch", "vfov"), input_size=32),
    recover_rpf=True,
    resize=(64, 64),
)
SCHEDULE = warmup_cosine_decay_schedule(0.0, 3e-4, 2, 20)


@functools.lru_cache(maxsize=None)
def _init_state_dict():
    sd = init_random_(PersNet(CFG, remat=True), seed=0).state_dict()
    for key in ("weight", "bias"):  # keep the random head off latitude's clamp
        sd[f"persformer_heads.latitude_head.linear_pred_latitude.{key}"] *= 0.01
    return sd


def _model(device="cpu", remat=True):
    model = PersNet(CFG, remat=remat)
    model.load_state_dict(_init_state_dict())
    return model.to(device)


@functools.lru_cache(maxsize=None)
def _cpu_batches(b=2, size=64):
    fn = make_step_batch_fn(3, batch_size=b, im_hw=(size, size), device="cpu")
    out = []
    for i in range(3):
        batch = fn(i)
        batch.pop("cams")
        batch["image"] = batch["image"] - torch.tensor(CFG.pixel_mean)
        out.append(batch)
    return tuple(out)


def _batches(device="cpu", b=2, size=64):
    return [{k: v.to(device) for k, v in batch.items()} for batch in _cpu_batches(b, size)]


def _run(model, batches, n, step=None, state=None, lr=SCHEDULE):
    """n steps on the batches in turn; the state and each step's metrics."""
    state = state or create_train_state(model, learning_rate=lr)
    step = step or make_train_step(CFG, compute_dtype=torch.bfloat16)
    metrics = []
    for i in range(n):
        state, m = step(state, batches[i % len(batches)])
        metrics.append(m)
    return state, metrics


def _counts():
    return counts(graphed_step.COUNTS)


def _delta(before):
    return delta(graphed_step.COUNTS, before)


def _assert_steps_equal(got, want):
    """Two runs' metrics, parameters and AdamW moments, bit for bit."""
    (s1, m1), (s2, m2) = got, want
    for a, b in zip(m1, m2):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for p, q in zip(s1.model.parameters(), s2.model.parameters()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s1.optimizer.state[p][key], s2.optimizer.state[q][key]), key


# ---------------------------------------------------------------------------
# the CPU path
# ---------------------------------------------------------------------------


def test_a_cpu_step_runs_eager_with_reason_cpu():
    before = _counts()
    _run(_model(), _batches(), 2)
    assert _delta(before) == (0, 0, 0, {"cpu": 2})


def _plain_steps(model, batches, n, lr=SCHEDULE, clip=1.0):
    """A plain AdamW training step written out: a float learning rate set
    before each update, and a fresh seeded generator a step for the
    stochastic-depth masks."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-2)
    losses = []
    for k in range(n):
        batch = batches[k % len(batches)]
        model.train()
        opt.zero_grad(set_to_none=True)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            out = model(batch["image"], generator=seeded_generator(0, k))
        out = {key: v.float() if v.is_floating_point() else v for key, v in out.items()}
        loss, _ = total_loss(out, batch, CFG)
        loss.backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in params], clip)
        for g in opt.param_groups:
            g["lr"] = lr(k)
        opt.step()
        losses.append(loss.detach())
    return losses, opt


def test_the_optimizer_takes_a_float_lr_and_steps_as_plain_adamw():
    state, metrics = _run(_model(), _batches(), 3)
    opt = state.optimizer
    assert all(isinstance(g["lr"], float) and not g["capturable"] for g in opt.param_groups)
    assert opt.param_groups[0]["lr"] == SCHEDULE(2)
    model = _model()
    want, want_opt = _plain_steps(model, _batches(), 3)
    for m, w in zip(metrics, want):
        assert torch.equal(m["loss"], w)
    for p, q in zip(state.model.parameters(), model.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(opt.state[p]["exp_avg_sq"], want_opt.state[q]["exp_avg_sq"])


def test_successive_steps_return_distinct_metrics():
    _, metrics = _run(_model(), _batches(), 2)
    kept = {k: v.clone() for k, v in metrics[0].items()}
    for k in metrics[0]:
        assert metrics[0][k].data_ptr() != metrics[1][k].data_ptr()
        assert torch.equal(metrics[0][k], kept[k])


def _stub_device(monkeypatch):
    """Let CPU steps past the device check, as a current-device CUDA batch."""
    monkeypatch.setattr(cuda_graphs, "device_reason", lambda t: None)


def test_a_hook_on_a_submodule_keeps_the_step_eager(monkeypatch):
    _stub_device(monkeypatch)
    model = _model()
    fired = []
    handle = model.backbone.block2[0].register_forward_hook(lambda *a: fired.append(1))
    before = _counts()
    state, _ = _run(model, _batches(), 2)
    assert _delta(before) == (0, 0, 0, {"hooks": 2})
    assert len(fired) == 2
    handle.remove()
    handle = next(model.parameters()).register_hook(lambda g: g)  # a hook on a parameter
    before = _counts()
    _run(model, _batches(), 1, state=state)
    assert _delta(before) == (0, 0, 0, {"hooks": 1})


def test_a_model_no_longer_used_is_collected(stubbed):
    model = _model()
    state, _ = _run(model, _batches(), 1)
    assert model in graphed_step.CACHE.states
    ref = weakref.ref(model)
    del model, state
    gc.collect()
    assert ref() is None


def _resume(state, path, device="cpu"):
    """Save ``state`` under ``path`` and restore it into a fresh state."""
    save_train_state(state, str(path))
    template = create_train_state(_model(device), learning_rate=SCHEDULE)
    return restore_train_state(str(path), template)


# ---------------------------------------------------------------------------
# the cache's rules, with the capture stubbed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def stubbed(monkeypatch):
    """The shared stub (``_cuda_graph_stub.stub``): the device check passes,
    the warm-up runs on the CPU and a capture is a fake graph that reruns
    the step, gradients included."""
    stub(monkeypatch)


def test_a_signature_runs_eager_then_captures_and_replays_the_eager_numbers(stubbed):
    before = _counts()
    got = _run(_model(), _batches(), 5)
    assert _delta(before) == (4, 1, 0, {FIRST: 1})
    want = _plain_steps(_model(), _batches(), 5)[0]
    for m, w in zip(got[1], want):
        assert torch.equal(m["loss"], w)


def test_a_replayed_step_runs_the_update_eager_with_the_optimizers_hooks(stubbed):
    """The graph ends at the clip: each step, replayed or not, runs AdamW's
    update after it, hooks included, on the gradients the step left."""
    model = _model()
    state = create_train_state(model, learning_rate=SCHEDULE)
    seen = []
    state.optimizer.register_step_pre_hook(
        lambda opt, args, kwargs: seen.append(all(p.grad is not None for p in model.parameters())))
    before = _counts()
    state, _ = _run(model, _batches(), 4, state=state)
    assert _delta(before) == (3, 1, 0, {FIRST: 1})
    assert seen == [True] * 4
    assert state.optimizer.state[next(model.parameters())]["step"] == 4


def test_a_restored_checkpoint_steps_as_the_run_without_the_save(stubbed, tmp_path):
    """Two steps, a save, and three more from the restored state (a new
    model: eager, captured, replayed) give the uninterrupted run's numbers."""
    want = _run(_model(), _batches(), 5)
    state, first = _run(_model(), _batches(), 2)
    restored = _resume(state, tmp_path)
    before = _counts()
    restored, rest = _run(restored.model, _batches()[2:] + _batches()[:2], 3, state=restored)
    assert _delta(before) == (2, 1, 0, {FIRST: 1})
    _assert_steps_equal((restored, first + rest), want)


def test_replayed_metrics_are_not_written_by_later_steps(stubbed):
    _, metrics = _run(_model(), _batches(), 4)
    kept = [{k: v.clone() for k, v in m.items()} for m in metrics]
    for m, k in zip(metrics, kept):
        for key in m:
            assert torch.equal(m[key], k[key])
    assert metrics[2]["loss"].data_ptr() != metrics[3]["loss"].data_ptr()


def test_two_batch_shapes_keep_two_graphs_and_a_third_evicts_the_oldest(stubbed):
    model = _model()
    shapes = [_batches(b=2), _batches(b=3), _batches(b=1)]
    state = create_train_state(model, learning_rate=SCHEDULE)
    step = make_train_step(CFG, compute_dtype=torch.bfloat16)
    before = _counts()
    for batches in shapes[:2]:
        for i in range(2):
            state, _ = step(state, batches[i])
    assert _delta(before) == (2, 2, 0, {FIRST: 2})
    st = graphed_step.CACHE.states[model]
    assert len(st.graphs) == 2
    for i in range(2):
        state, _ = step(state, shapes[2][i])
    assert len(st.graphs) == graphed_step.CACHE.max_graphs == 2
    before = _counts()
    state, _ = step(state, shapes[1][0])  # still kept
    state, _ = step(state, shapes[0][0])  # evicted: captured again (seen before)
    assert _delta(before) == (2, 1, 0, {})


def test_a_new_storage_drops_the_graphs_and_captures_again(stubbed):
    model = _model()
    state, _ = _run(model, _batches(), 3)
    before = _counts()
    _run(model, _batches(), 1, state=state)
    assert _delta(before) == (1, 0, 0, {})
    p = next(model.parameters())
    p.data = p.data.clone()  # a parameter moved to new storage
    before = _counts()
    state, _ = _run(model, _batches(), 2, state=state)
    assert _delta(before) == (2, 1, 0, {})
    sd = copy.deepcopy(state.optimizer.state_dict())
    state.optimizer.load_state_dict(sd)  # new tensors for AdamW's state: not the graph's
    before = _counts()
    _run(model, _batches(), 1, state=state)
    assert _delta(before) == (1, 0, 0, {})


def test_a_capture_that_raises_keeps_its_signature_eager_with_one_warning(stubbed, monkeypatch):
    fail_captures(monkeypatch)
    monkeypatch.setattr(graphed_step.CACHE, "warned", False)
    before = _counts()
    with pytest.warns(RuntimeWarning, match="capture of the train step failed") as caught:
        got = _run(_model(), _batches(), 4)
    assert len([w for w in caught if "train step" in str(w.message)]) == 1
    assert _delta(before) == (0, 0, 1, {FIRST: 1, "capture_failed": 3})
    want = _plain_steps(_model(), _batches(), 4)[0]
    for m, w in zip(got[1], want):
        assert torch.equal(m["loss"], w)


def test_the_train_loop_shares_the_steps_graphs(stubbed):
    model = _model()
    batches = _batches()
    state = create_train_state(model, learning_rate=SCHEDULE)
    loops = [make_train_loop(CFG, lambda k: batches[k % 3], n, compute_dtype=torch.bfloat16)
             for n in (2, 1)]
    before = _counts()
    state, m = loops[0](state)
    state, _ = loops[1](state)
    assert _delta(before) == (2, 1, 0, {FIRST: 1})
    assert m["loss"].shape == (2,)


def test_remat_draws_nothing_from_the_global_generators():
    """The blocks draw no random number inside the checkpoint (the masks
    are drawn outside it, from the step's own generator): a remat step
    leaves the global generator as it was and gives the gradients of a step
    without remat, so a replay's recomputation is the eager one."""
    grads = {}
    for remat in (True, False):
        model = _model(remat=remat).train()
        batch = _batches()[0]
        rng = torch.get_rng_state()
        out = model(batch["image"], generator=seeded_generator(0, 5))
        out = {k: v.float() for k, v in out.items() if v.is_floating_point()}
        total_loss(out, batch, CFG)[0].backward()
        assert torch.equal(torch.get_rng_state(), rng)
        grads[remat] = [p.grad for p in model.parameters()]
    for a, b in zip(grads[True], grads[False]):
        assert (a is None and b is None) or torch.equal(a, b)



# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _eager_twin(device):
    """A model whose steps stay eager: a no-op forward hook on a block."""
    model = _model(device)
    model.backbone.block1[0].register_forward_hook(lambda *a: None)
    return model


@pytest.mark.cuda
def test_replayed_steps_equal_eager_steps_bit_for_bit(cuda_device):
    batches = _batches(cuda_device, b=4)
    before = _counts()
    got = _run(_model(cuda_device), batches, 5)
    assert _delta(before) == (4, 1, 0, {FIRST: 1})
    opt = got[0].optimizer
    assert all(isinstance(g["lr"], float) and not g["capturable"] for g in opt.param_groups)
    want = _run(_eager_twin(cuda_device), batches, 5)
    _assert_steps_equal(got, want)


@pytest.mark.cuda
def test_a_state_load_replays_on_and_a_moved_parameter_captures_again(cuda_device):
    batches = _batches(cuda_device, b=4)
    runs = []
    for model in (_model(cuda_device), _eager_twin(cuda_device)):
        state, metrics = _run(model, batches, 3)
        before = _counts()
        state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
        state, m = _run(model, batches, 2, state=state)
        metrics += m
        after_load = _delta(before)
        p = next(model.parameters())
        p.data = p.data.clone()
        before = _counts()
        state, m = _run(model, batches, 2, state=state)
        runs.append((state, metrics + m))
        if len(runs) == 1:
            assert after_load == (2, 0, 0, {})
            assert _delta(before) == (2, 1, 0, {})
    _assert_steps_equal(*runs)


@pytest.mark.cuda
def test_a_restored_checkpoint_replays(cuda_device, tmp_path):
    batches = _batches(cuda_device, b=4)
    state, _ = _run(_model(cuda_device), batches, 2)
    restored = _resume(state, tmp_path, cuda_device)
    before = _counts()
    _run(restored.model, batches, 3, state=restored)
    assert _delta(before) == (2, 1, 0, {FIRST: 1})


@pytest.mark.cuda
def test_two_batch_shapes_give_two_graphs(cuda_device):
    model = _model(cuda_device)
    state = create_train_state(model, learning_rate=SCHEDULE)
    step = make_train_step(CFG, compute_dtype=torch.bfloat16)
    before = _counts()
    for b in (4, 2):
        for batch in _batches(cuda_device, b=b)[:3]:
            state, _ = step(state, batch)
    assert _delta(before) == (4, 2, 0, {FIRST: 2})
    assert len(graphed_step.CACHE.states[model].graphs) == 2


@pytest.mark.cuda
def test_a_loss_that_reads_the_host_falls_back_to_eager_for_good(cuda_device, monkeypatch):
    def reading(out, batch, cfg):
        loss, parts = total_loss(out, batch, cfg)
        parts["host"] = torch.full_like(loss, loss.item())  # a device-to-host read
        return loss, parts

    monkeypatch.setattr(graphed_step.CACHE, "warned", False)
    batches = _batches(cuda_device, b=4)
    before = _counts()
    step = make_train_step(CFG, loss_fn=reading, compute_dtype=torch.bfloat16)
    with pytest.warns(RuntimeWarning, match="capture of the train step failed") as caught:
        got = _run(_model(cuda_device), batches, 4, step=step)
    assert len([w for w in caught if "train step" in str(w.message)]) == 1
    assert _delta(before) == (0, 0, 1, {FIRST: 1, "capture_failed": 3})
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    want = _run(_eager_twin(cuda_device), batches, 4,
                step=make_train_step(CFG, loss_fn=reading, compute_dtype=torch.bfloat16))
    _assert_steps_equal(got, want)
