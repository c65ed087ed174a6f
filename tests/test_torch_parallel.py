"""The port's parallel path against the one-process path and JAX's rules.

* the tensor-parallel layout: every parameter's placement on a model axis
  equals JAX's ``_spec_for`` on the same parameter (JAX's mesh from the 8
  virtual CPU devices of tests/conftest.py), transposed to torch's layout;
* data parallelism: two gloo processes, each on its half of a toy batch
  whose halves have different valid-pixel counts, with stochastic depth
  on, against the one-process step on the whole batch: losses within
  1e-5 (relative), Adam's first moments within 0.1 * 1e-5 (the clipped
  gradients' 1e-5) and parameters within 0.1 * lr a step after 2 steps;
  the losses' ``reduce`` and ``DropPath``'s rows on one process;
* the tensor-parallel ``sharded_forward`` over two processes (model=2)
  against the one-process forward within 1e-5 * max(1, |ref|), and the
  port's ``tools.dryrun_multiprocess`` (4 processes, data=2, model=2)
  against its one-process control within JAX's 1e-4 relative;
* tensor-parallel training: two gloo processes (data=1, model=2), the
  ruled Linears split, 2 steps against the one-process step (losses 1e-5
  relative, whole parameters within 0.1 * lr * steps, Adam's first moments
  within 1e-6, the replicated parameters bit-equal across the model group,
  AdamW state of the size ``param_shardings`` implies), and train-state
  checkpoints moved between the split state and one process either way;
  in one process, the split Linears' names, shapes and slices against
  ``param_shardings``, the refusals, and the losses' one all-reduce a step;
* ``PerspectiveFields``' split over replicas (``forward_split``) and
  ``BatchPredictor(mesh=...)`` with two CPU replicas and a batch the
  replicas do not divide: bit-equal to the single-device path on each
  replica's rows, and within 1e-4 of it on the whole batch at once (the
  plain ops' rounding depends on the batch size);
* ``init_distributed``, ``make_mesh``, ``batch_rows``, ``shard_batch``,
  ``replicate`` on a one-process group.

Every process test takes a file store under ``tmp_path`` and a timeout of
its own.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from perspectivefields_tpu.models import PersNet as JaxPersNet
from perspectivefields_tpu.parallel import make_mesh as jax_make_mesh
from perspectivefields_tpu.parallel.sharding import _spec_for as jax_spec_for
from perspectivefields_tpu_torch import PerspectiveFields
from perspectivefields_tpu_torch.api import local_replica_devices
from perspectivefields_tpu_torch.checkpoint import flax_to_torch_names
from perspectivefields_tpu_torch.models import PersNet
from perspectivefields_tpu_torch.models.mit import DropPath
from perspectivefields_tpu_torch.parallel import (
    batch_rows,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
from perspectivefields_tpu_torch.parallel.sharding import _spec_for
from perspectivefields_tpu_torch.parallel.tensor_parallel import (
    ColumnLinear,
    RowLinear,
    split_linears_,
    unsplit_ruled,
)
from perspectivefields_tpu_torch.serving import BatchPredictor
from perspectivefields_tpu_torch.tools import dryrun_multiprocess as dryrun
from perspectivefields_tpu_torch.train import create_train_state, losses, make_train_step

TIMEOUT = 240  # seconds for one multi-process run


# ---------------------------------------------------------------------------
# tensor-parallel layout vs JAX's rules
# ---------------------------------------------------------------------------


def _jax_placement(spec: P):
    """JAX's PartitionSpec of a flax leaf as the torch placement of its
    torch tensor: kernels are (in, out) in flax, (out, in) in torch."""
    if spec == P():
        return "replicate"
    if spec == P(None, "model") or spec == P("model"):
        return "shard0"
    assert spec == P("model", None), spec
    return "shard1"


def _torch_placement(pl):
    return "replicate" if pl.is_replicate() else f"shard{pl.dim}"


@pytest.mark.parametrize("n_model", [2, 3])
def test_placements_match_jax_spec_for(n_model):
    """Each parameter of the dry run's toy model: the port's placement on a
    model axis of n_model equals JAX's _spec_for on a (8 // n_model,
    n_model) mesh of the virtual CPU devices (3 leaves odd widths to JAX's
    divisibility fallback)."""
    cfg, _ = dryrun.toy_setup()
    jmodel = JaxPersNet(cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    mesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    want, seen_shards = {}, 0
    for path, leaf in flat:
        path_str = "/".join(p.key for p in path)
        tree: dict = {}
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p.key, {})
        node[path[-1].key] = np.zeros(leaf.shape, np.float32)
        (name, _), = flax_to_torch_names(tree).items()
        want[name] = _jax_placement(jax_spec_for(path_str, leaf.shape, mesh))
    torch_params = dict(PersNet(cfg).named_parameters())
    assert set(torch_params) == set(want)
    for name, p in torch_params.items():
        got = _torch_placement(_spec_for(name, p.shape, n_model))
        assert got == want[name], name
        seen_shards += got != "replicate"
    assert seen_shards > 20


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------


def test_losses_reduce_sums_the_halves_to_the_global_loss():
    """Each half's loss with the global denominators (a reduce that sums
    both halves' counts) adds up to the loss of the whole batch, for every
    regression term, whatever the halves' mask counts."""
    cfg, batch = dryrun.toy_setup()
    rng = np.random.default_rng(1)
    out = {
        "pred_gravity": torch.from_numpy(rng.normal(size=batch["gt_gravity"].shape).astype(np.float32)),
        "pred_latitude": torch.from_numpy(rng.uniform(-1, 1, size=batch["gt_latitude"].shape).astype(np.float32)),
        "latitude_raw": torch.from_numpy(rng.normal(size=batch["gt_latitude"].shape).astype(np.float32) * 2),
    }
    out["pred_gravity"] /= out["pred_gravity"].norm(dim=-1, keepdim=True)
    cfg = dataclasses.replace(cfg, param=None)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    whole, whole_parts = losses.total_loss(out, tb, cfg)
    halves = [slice(0, 4), slice(4, 8)]

    def counts_of(sl):
        recorded = []

        def rec(c):
            recorded.append(c)
            return c
        losses.total_loss({k: v[sl] for k, v in out.items()}, {k: v[sl] for k, v in tb.items()}, cfg, rec)
        return recorded

    per_half = [counts_of(sl) for sl in halves]
    assert any(a != b for a, b in zip(*per_half))  # the halves' counts differ
    total = [a + b for a, b in zip(*per_half)]
    sums, parts = 0.0, {}
    for sl in halves:
        it = iter(total)
        loss, p = losses.total_loss({k: v[sl] for k, v in out.items()},
                                    {k: v[sl] for k, v in tb.items()}, cfg, lambda c: next(it))
        sums = sums + loss
        for k, v in p.items():
            parts[k] = parts.get(k, 0.0) + v
    assert torch.allclose(sums, whole, rtol=1e-6)
    for k, v in whole_parts.items():
        assert torch.allclose(parts[k], v, rtol=1e-5, atol=1e-7), k


def test_drop_path_rows_take_the_global_batch_mask():
    """A rank's rows of the global batch draw the global batch's mask."""
    dp = DropPath(0.5).train()
    x = torch.ones(8, 3, 3, 4)
    whole = dp.sample(x, torch.Generator().manual_seed(3))
    for first in (0, 4):
        rows = dp.sample(x[first:first + 4], torch.Generator().manual_seed(3), rows=(first, 8))
        assert torch.equal(rows, whole[first:first + 4])
    assert whole.float().mean() not in (0.0, 1.0)


def test_data_parallel_step_matches_one_process(tmp_path):
    """Two gloo processes (data=2), each on its half of the toy batch, 2
    steps, against the one-process step on the whole batch."""
    cfg, batch = dryrun.toy_setup()
    valid = (np.linalg.norm(batch["gt_gravity"], axis=-1) > 1e-5).reshape(2, -1).sum(axis=1)
    assert valid[0] != valid[1]  # the halves' mask counts differ
    assert cfg.backbone.drop_path_rate > 0
    steps = 2
    solo = dryrun.run("solo", "", 0, 1, 1, steps, "cpu", str(tmp_path))
    results = dryrun.launch(2, 1, steps, out_dir=str(tmp_path), timeout=TIMEOUT)
    for r in results:
        np.testing.assert_allclose(r["train_losses"], solo["train_losses"], rtol=1e-5)
    a, b = (torch.load(tmp_path / f"{role}.pt", weights_only=True) for role in ("solo", "mp"))
    worst = max((a["params"][k] - b["params"][k]).abs().max().item() for k in a["params"])
    assert worst <= 0.1 * dryrun.LR * steps, worst
    # Adam's first moments mix the steps' clipped gradients, each held to 1e-5
    moments = max((a["exp_avg"][k] - b["exp_avg"][k]).abs().max().item() for k in a["exp_avg"])
    assert moments <= 0.1 * 1e-5, moments


def test_dryrun_run_gives_back_the_callers_settings():
    """run() trains on one thread with TF32 off, then restores the caller's
    thread count and TF32 flags."""
    threads = torch.get_num_threads()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        dryrun.run("solo", "", 0, 1, 1, 0, "cpu", None)
        assert torch.get_num_threads() == 2
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.set_num_threads(threads)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# ---------------------------------------------------------------------------
# tensor parallelism and the dry run
# ---------------------------------------------------------------------------


def test_sharded_forward_matches_one_process(tmp_path):
    """model=2 over two processes, no training step: the forward of the
    sharded parameters against the one-process forward."""
    dryrun.run("solo", "", 0, 1, 1, 0, "cpu", str(tmp_path))
    dryrun.launch(2, 2, 0, out_dir=str(tmp_path), timeout=TIMEOUT)
    want = torch.load(tmp_path / "solo.pt", weights_only=True)["outputs"]
    got = torch.load(tmp_path / "mp.pt", weights_only=True)["outputs"]
    assert set(got) == set(want)
    for k, w in want.items():
        d = (got[k] - w).abs().max().item()
        assert d <= 1e-5 * max(1.0, w.abs().max().item()), (k, d)


def test_dryrun_multiprocess_matches_control(tmp_path):
    """The port's dry run: 4 processes, data=2 x model=2, one step and one
    sharded forward, against its one-process control (JAX's bar)."""
    out = tmp_path / "mp.json"
    art = dryrun.main(["--out", str(out), "--timeout", str(TIMEOUT)])
    assert art["agree"] and out.exists()
    assert [r["mesh"] for r in art["multiprocess"]] == [{"data": 2, "model": 2}] * 4
    ref = art["solo"]["inference_abs_checksum"]
    for r in art["multiprocess"]:
        assert abs(r["inference_abs_checksum"] - ref) <= 1e-4 * max(1.0, abs(ref))


def test_tensor_parallel_step_matches_one_process(tmp_path):
    """data=1 x model=2 over two processes, the ruled Linears split, 2 steps
    against the one-process step; then each layout restores the other's
    step-1 checkpoint and takes step 2 as the uninterrupted run does."""
    steps, ckpt = 2, tmp_path / "ckpt"
    solo = dryrun.run("solo", "", 0, 1, 1, steps, "cpu", str(tmp_path), ckpt_dir=str(ckpt))
    results = dryrun.launch(2, 2, steps, out_dir=str(tmp_path), timeout=TIMEOUT,
                            ckpt_dir=str(ckpt), resume=str(ckpt / "solo"))
    for r in results:
        assert r["mesh"] == {"data": 1, "model": 2}
        np.testing.assert_allclose(r["train_losses"], solo["train_losses"], rtol=1e-5)
        assert r["replicated_bit_equal"] is True
        assert r["adam_elements"] == r["expected_adam_elements"] < solo["adam_elements"]
        # a split state from the one-process checkpoint
        np.testing.assert_allclose(r["resumed_loss"], solo["train_losses"][1], rtol=1e-5)
    diffs = dryrun.compare(str(tmp_path))
    assert diffs["max_param_diff"] <= 0.1 * dryrun.LR * steps, diffs
    assert diffs["max_moment_diff"] <= 1e-6, diffs
    # one process from the split state's checkpoint, which is in the
    # one-process format: the same names and whole shapes
    again = dryrun.run("solo", "", 0, 1, 1, 0, "cpu", None, resume=str(ckpt / "mp"))
    np.testing.assert_allclose(again["resumed_loss"], solo["train_losses"][1], rtol=1e-5)
    a, b = (torch.load(ckpt / role / "step_00000001" / "state.pt", weights_only=True)
            for role in ("solo", "mp"))
    assert {k: v.shape for k, v in a["model"].items()} == {k: v.shape for k, v in b["model"].items()}
    assert {i: {k: v.shape for k, v in st.items()} for i, st in a["optimizer"]["state"].items()} == \
        {i: {k: v.shape for k, v in st.items()} for i, st in b["optimizer"]["state"].items()}


@pytest.mark.parametrize("n_model", [2, 3])
def test_split_linears_follow_param_shardings(n_model):
    """One process, every slice of a model axis of n_model: each Linear a
    rule splits becomes a ColumnLinear (Shard(0)) or RowLinear (Shard(1))
    holding that rank's slice under the same names; every other parameter
    stays as it was (n_model 3 leaves odd widths whole, JAX's fallback)."""
    cfg, _ = dryrun.toy_setup()
    whole = dryrun.toy_model(cfg)
    params = dict(whole.named_parameters())
    for rank in range(n_model):
        split = split_linears_(dryrun.toy_model(cfg), n_model, rank)
        assert unsplit_ruled(split, n_model) == []
        got = dict(split.named_parameters())
        assert list(got) == list(params)
        kinds = set()
        for name, p in params.items():
            placement = _spec_for(name, p.shape, n_model)
            owner = split.get_submodule(name.rsplit(".", 1)[0])
            if placement.is_replicate():
                assert torch.equal(got[name], p), name
                if name.endswith(".weight"):
                    assert type(owner) is not ColumnLinear and type(owner) is not RowLinear, name
                continue
            per = p.shape[placement.dim] // n_model
            want = p.detach().narrow(placement.dim, rank * per, per)
            assert torch.equal(got[name], want), name
            assert isinstance(owner, ColumnLinear if placement.dim == 0 else RowLinear), name
            if name.endswith(".weight"):  # the whole layer's widths
                assert (owner.out_features, owner.in_features) == tuple(p.shape), name
            kinds.add(type(owner))
        assert kinds == {ColumnLinear, RowLinear}
    assert unsplit_ruled(whole, n_model)  # the unsplit model holds ruled tensors whole


def test_tensor_parallel_refusals():
    """A model with a kernel route on does not split; a step on a model axis
    of 2 refuses a state whose model was not split."""
    cfg, batch = dryrun.toy_setup()
    with pytest.raises(ValueError, match="every kernel off"):
        split_linears_(PersNet(cfg, fuse_ffn=True), 2, 0)

    class ModelAxisMesh:  # what the step reads of a (data=1, model=2) mesh
        mesh_dim_names = ("data", "model")

        def __getitem__(self, axis):
            return type("Axis", (), {"size": lambda _: {"data": 1, "model": 2}[axis]})()

        def get_group(self, axis):
            return None

        def get_local_rank(self, axis):
            return 0

    state = create_train_state(dryrun.toy_model(cfg))
    step = make_train_step(cfg, mesh=ModelAxisMesh())
    with pytest.raises(ValueError, match="create_train_state"):
        step(state, {k: torch.from_numpy(v) for k, v in batch.items()})


def test_losses_take_one_all_reduce_a_step(tmp_path, monkeypatch):
    """Under a mesh the losses' twelve denominators are summed in one
    all-reduce (the step's other one sums the gradients); with the counts
    summed over one rank the losses are bit-equal to the one-process ones."""
    cfg, batch = dryrun.toy_setup()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = dryrun.toy_model(cfg).train()
    with torch.no_grad():
        out = model(tb["image"], generator=torch.Generator().manual_seed(0))
    whole, parts = losses.total_loss(out, tb, cfg)
    calls = []

    def sum_counts(counts):
        calls.append(len(counts))
        return counts

    reduce = losses.global_denominators(losses.total_loss, out, tb, cfg, sum_counts)
    got, got_parts = losses.total_loss(out, tb, cfg, reduce)
    assert calls == [12]
    assert torch.equal(got, whole) and all(torch.equal(got_parts[k], v) for k, v in parts.items())

    init_distributed("file://" + str(tmp_path / "store"), 1, 0, backend="gloo")
    try:
        mesh = make_mesh()
        state = create_train_state(model, learning_rate=dryrun.LR, mesh=mesh)
        step = make_train_step(cfg, mesh=mesh)
        reduces = []
        real = dist.all_reduce
        monkeypatch.setattr(dist, "all_reduce", lambda t, **kw: reduces.append(t.numel()) or real(t, **kw))
        for _ in range(2):
            step(state, tb)
        n_params = sum(p.numel() for p in model.parameters())
        assert reduces == [12, n_params + 1 + 6] * 2  # counts; gradients, loss and its 6 parts
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# one process: group, mesh, rows
# ---------------------------------------------------------------------------


def test_one_process_group_mesh_and_rows(tmp_path):
    init_distributed("file://" + str(tmp_path / "store"), 1, 0, backend="gloo")
    try:
        init_distributed("file://" + str(tmp_path / "other"), 1, 0)  # a second call does nothing
        mesh = make_mesh()
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match=r"mesh 2x1 > 1 devices"):
            make_mesh(n_data=2)
        assert batch_rows(mesh, 6) == slice(0, 6)
        assert batch_rows(None, 5) == slice(0, 5)
        x = torch.arange(12.0).reshape(6, 2)
        assert torch.equal(shard_batch(mesh, x), x)
        t = replicate(mesh, torch.ones(3))
        assert torch.equal(t, torch.ones(3))
        m = torch.nn.Linear(2, 2)
        assert replicate(mesh, m) is m
    finally:
        dist.destroy_process_group()


def test_batch_rows_split_and_refuse_uneven():
    class FakeMesh:  # the two calls batch_rows makes of a DeviceMesh
        def __init__(self, n, i):
            self.n, self.i = n, i

        def __getitem__(self, axis):
            return type("Axis", (), {"size": lambda _: self.n})()

        def get_local_rank(self, axis):
            return self.i

    assert [batch_rows(FakeMesh(4, i), 8) for i in range(4)] == [slice(2 * i, 2 * i + 2) for i in range(4)]
    with pytest.raises(ValueError, match="does not divide"):
        batch_rows(FakeMesh(3, 0), 8)


# ---------------------------------------------------------------------------
# PerspectiveFields' split over local replicas and BatchPredictor's mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy_model():
    cfg, _ = dryrun.toy_setup()
    sd = dryrun.toy_model(cfg).state_dict()
    return PerspectiveFields("custom", config=cfg, params=sd, device="cpu")


def _images(n, seed=0, hw=(80, 96)):
    return list(np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8))


def _assert_equal(got: list, want: list, tol=0.0):
    for g, w in zip(got, want, strict=True):
        assert set(g) == set(w)
        for k, v in w.items():
            if isinstance(v, str):
                assert g[k] == v
            else:
                np.testing.assert_allclose(g[k], v, rtol=0, atol=tol * max(1.0, float(np.abs(v).max())),
                                           err_msg=k)


def test_no_split_on_the_cpu_or_one_device(toy_model, monkeypatch):
    assert local_replica_devices("cpu", torch.device("cpu")) is None
    assert toy_model.replica_devices is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert local_replica_devices(None, torch.device("cuda", 0)) is None


def test_default_split_puts_the_models_device_first(monkeypatch):
    """On three local CUDA devices the default split starts with the
    model's own device; a device the caller names keeps the batch there."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert local_replica_devices(None, cuda[1]) == [cuda[1], cuda[0], cuda[2]]
    assert local_replica_devices("cuda", cuda[0]) == cuda
    assert local_replica_devices(torch.device("cuda"), cuda[2]) == [cuda[2], cuda[0], cuda[1]]
    assert local_replica_devices("cuda:1", cuda[1]) is None
    assert local_replica_devices(torch.device("cuda", 0), cuda[0]) is None
    assert local_replica_devices("cpu", torch.device("cpu")) is None


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_split_on_cuda_reuses_the_model_as_its_first_replica():
    """device="cuda" resolves to an indexed device, so a split whose first
    device is the model's own runs the model itself there: no copy is made
    for slot 0."""
    cfg, _ = dryrun.toy_setup()
    m = PerspectiveFields("custom", config=cfg, params=dryrun.toy_model(cfg).state_dict(),
                          device="cuda")
    assert m.device == torch.device("cuda", torch.cuda.current_device())
    x = torch.from_numpy(np.stack([i[:64, :64] for i in _images(4, seed=4)]))
    m.forward_split(x, ["cuda", m.device])
    assert 0 not in m._replicas and set(m._replicas) == {1}


@pytest.mark.parametrize("n_dev", [2, 3])
def test_forward_split_equals_single_path(toy_model, n_dev):
    """5 images over 2 or 3 CPU replicas (the tail zero-padded): each
    replica's rows equal the single path on the same padded rows, and the
    split is within 1e-4 of the single path on the whole batch."""
    m = toy_model
    x = torch.from_numpy(np.stack([i[:64, :64] for i in _images(5)]))
    whole = m._forward_fn(x)
    got = m.forward_split(x, ["cpu"] * n_dev)
    per = -(-5 // n_dev)
    padded = torch.cat([x, torch.zeros((per * n_dev - 5, *x.shape[1:]), dtype=x.dtype)])
    for i in range(n_dev):
        rows = slice(i * per, min((i + 1) * per, 5))
        ref = m._network(m.model, padded[i * per:(i + 1) * per], m.device, False)
        for k in ref:
            assert torch.equal(got[k][rows], ref[k][: rows.stop - rows.start]), (i, k)
    for k, w in whole.items():
        assert got[k].shape == w.shape
        assert (got[k] - w).abs().max() <= 1e-4 * max(1.0, w.abs().max().item()), k
    assert 0 not in m._replicas and set(m._replicas) == set(range(1, n_dev))


def test_inference_batch_split_over_two_replicas(toy_model):
    """inference_batch with replica_devices = 2 CPUs and 5 images: within
    1e-4 of the single-device path on the whole batch, equal on the
    first replica's 3 rows."""
    m = toy_model
    imgs = _images(5, seed=1)
    want = m.inference_batch(imgs)
    first = m.inference_batch(imgs[:3])
    m.replica_devices = [torch.device("cpu")] * 2
    try:
        got = m.inference_batch(imgs)
    finally:
        m.replica_devices = None
    _assert_equal(got, want, tol=1e-4)
    _assert_equal(got[:3], first)


def test_split_replicas_follow_the_weights(toy_model):
    """A replica is made again after the model's weights change in place."""
    m = toy_model
    x = torch.from_numpy(np.stack([i[:64, :64] for i in _images(4, seed=2)]))
    m.forward_split(x, ["cpu", "cpu"])
    old = m._replicas[1][1]
    sd = {k: v.clone() for k, v in m.model.state_dict().items()}
    try:
        with torch.no_grad():
            m.model.persformer_heads["gravity_head"].linear_pred_gravity.bias.add_(0.5)
        got = m.forward_split(x, ["cpu", "cpu"])
        assert m._replicas[1][1] is not old
        ref = m._network(m.model, x[2:], m.device, False)
        assert torch.equal(got["pred_gravity"][2:], ref["pred_gravity"])
    finally:
        m.model.load_state_dict(sd)


@pytest.mark.parametrize("wire", ["u8", "f32"])
def test_batch_predictor_mesh(toy_model, wire):
    """BatchPredictor(mesh=[cpu, cpu]) over 7 images at B=4 (a padded tail)
    against BatchPredictor without a mesh, and use_mesh=False ignores the
    model's replica devices."""
    m = toy_model
    imgs = _images(7, seed=3)
    want = BatchPredictor(m, batch_size=4, wire=wire).predict(imgs)
    bp = BatchPredictor(m, batch_size=4, wire=wire, mesh=["cpu", "cpu"])
    assert bp.mesh == [torch.device("cpu")] * 2
    _assert_equal(bp.predict(imgs), want, tol=1e-4)
    m.replica_devices = [torch.device("cpu")] * 2
    try:
        assert BatchPredictor(m, batch_size=4, wire=wire).mesh == m.replica_devices
        plain = BatchPredictor(m, batch_size=4, wire=wire, use_mesh=False)
        assert plain.mesh is None
        _assert_equal(plain.predict(imgs), want)
    finally:
        m.replica_devices = None


def test_tp_rules_name_real_parameters():
    """Every rule of _TP_RULES names parameters of the flagship model."""
    from perspectivefields_tpu_torch.config import model_zoo
    from perspectivefields_tpu_torch.parallel.sharding import _TP_RULES

    with torch.device("meta"):
        net = PersNet(model_zoo["Paramnet-360Cities-edina-centered"]["config"])
    names = [n for n, _ in net.named_parameters()]
    for pattern, _ in _TP_RULES:
        assert any(re.fullmatch(pattern, n) for n in names), pattern
