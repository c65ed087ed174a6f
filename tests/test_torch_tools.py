"""The port's tools against the JAX package's, on CPU in float32.

* ``train.warmup_cosine_decay_schedule`` against optax's, step for step
  (within 1e-7);
* ``tools.learning_proof``: the JAX tool's model, its JSON line with
  ``--smoke``, and JAX's pass bar asserted (with the artifact written)
  without it;
* ``tools.convert_checkpoint``: on a synthetic released ``.pth`` the same
  ``.npz`` arrays, bit for bit, as JAX's ``load_torch_checkpoint`` +
  ``save_params``; the command line on a toy zoo entry (its sanity
  forward, ``--all``), and without a ``.pth`` a non-zero exit that names
  the download and opens no connection;
* ``tools.export_torch``: tensor for tensor JAX's ``flax_to_torch_names``
  of the same ``.npz``, and the round trip loads strictly;
* ``tools.demo`` on the CPU: the five camera parameters and both PNGs;
* ``tools.train`` under torchrun with two gloo ranks: the one-process
  run's losses, checkpoints from rank 0, a resume.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

from perspectivefields_tpu.checkpoint import flax_to_torch_names as jax_flax_to_torch_names
from perspectivefields_tpu.checkpoint import load_torch_checkpoint
from perspectivefields_tpu.checkpoint.io import load_params as jax_load_params
from perspectivefields_tpu.checkpoint.io import save_params as jax_save_params
from perspectivefields_tpu_torch import PerspectiveFields
from perspectivefields_tpu_torch.checkpoint import load_released, save_params
from perspectivefields_tpu_torch.config import model_zoo
from perspectivefields_tpu_torch.models import PersNet
from perspectivefields_tpu_torch.tools import convert_checkpoint, demo, export_torch, learning_proof
from perspectivefields_tpu_torch.tools import dryrun_multiprocess as dryrun
from perspectivefields_tpu_torch.tools import train as ttrain
from perspectivefields_tpu_torch.train import warmup_cosine_decay_schedule

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes at once; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the schedule and the learning proof
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    (0.0, 3e-4, 50, 500, 3e-6),  # the learning proof's shape
    (0.0, 3e-4, 0, 120, 3e-6),   # no warmup
    (1e-5, 1e-3, 7, 40, 0.0),    # decay to 0, odd warmup
])
def test_schedule_matches_optax(args):
    ours, theirs = warmup_cosine_decay_schedule(*args), optax.warmup_cosine_decay_schedule(*args)
    for step in range(args[3] + 25):  # past decay_steps it holds end_value
        assert abs(ours(step) - float(theirs(step))) <= 1e-7, step


def test_learning_proof_model_is_the_jax_tools():
    cfg, model = learning_proof.build(64, "cpu")
    assert cfg.backbone.dims == (16, 32, 48, 64) and cfg.backbone.depths == (2, 2, 2, 2)
    assert cfg.backbone.num_heads == (1, 2, 3, 4) and cfg.resize == (64, 64)
    for head in (cfg.gravity, cfg.latitude):
        assert (head.loss_type, head.embed_dim, head.fusion_dim) == ("regression", 32, 32)
    assert cfg.param is None and next(model.parameters()).dtype == torch.float32


def test_learning_proof_smoke_prints_its_json_line(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(learning_proof, "ARTIFACT", str(tmp_path / "proof.json"))
    res = learning_proof.main(["--steps", "4", "--chunk", "2", "--batch", "2", "--size", "32",
                               "--eval-batches", "1", "--smoke", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res and line["steps"] == 4 and line["card"] == "cpu"
    for key in ("up_mean_deg", "up_median_deg", "lat_mean_deg", "lat_median_deg"):
        assert np.isfinite(line["before"][key]) and np.isfinite(line["after"][key])
    assert not (tmp_path / "proof.json").exists()  # --smoke writes no artifact


def test_learning_proof_asserts_the_bar(monkeypatch, tmp_path):
    """Without --smoke the artifact is written and JAX's bar is asserted:
    2 steps cannot meet it."""
    monkeypatch.setattr(learning_proof, "ARTIFACT", str(tmp_path / "proof.json"))
    with pytest.raises(AssertionError):
        learning_proof.main(["--steps", "2", "--chunk", "2", "--batch", "2", "--size", "32",
                             "--eval-batches", "1", "--device", "cpu"])
    assert json.loads((tmp_path / "proof.json").read_text())["steps"] == 2


def test_learning_proof_is_reproducible():
    """Its streams and initialisation come from seeds: two runs give the
    same errors and losses."""
    args = ["--steps", "4", "--chunk", "2", "--batch", "2", "--size", "32", "--eval-batches", "1",
            "--smoke", "--device", "cpu"]
    first, second = learning_proof.main(args), learning_proof.main(args)
    for key in ("before", "after", "loss_first", "loss_last"):
        assert first[key] == second[key], key


# ---------------------------------------------------------------------------
# the converters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy():
    """The dry run's toy config without its ParamNet (a full ConvNeXt-T,
    whose 28M weights take seconds to compress) and its weights, saved as a
    released .pth with the extra keys a release carries (a BN counter,
    pixel statistics)."""
    cfg, _ = dryrun.toy_setup()
    cfg = dataclasses.replace(cfg, param=None, recover_rpf=False, recover_pp=False)
    sd = dryrun.toy_model(cfg).state_dict()
    released = dict(sd)
    released["ll_enc.bn1.num_batches_tracked"] = torch.tensor(0)
    released["pixel_mean"] = torch.ones(3, 1, 1)
    return cfg, sd, released


def test_convert_writes_jaxs_npz_bit_for_bit(toy, tmp_path):
    _, _, released = toy
    pth = tmp_path / "toy.pth"
    torch.save({"model": released}, pth)
    save_params(load_released(pth), str(tmp_path / "port.npz"))
    jax_save_params(load_torch_checkpoint(str(pth)), str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 90
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k


@pytest.fixture
def toy_zoo(toy, monkeypatch):
    """A toy entry in the (shared) model zoo, as a release would list it."""
    cfg, _, _ = toy
    entry = {"config": dataclasses.replace(cfg, version="toy"),
             "weights_url": "https://example.invalid/models/toy_rpf.pth", "description": "toy"}
    monkeypatch.setitem(model_zoo, "toy", entry)
    return entry


def test_convert_without_a_pth_exits_and_downloads_nothing(toy_zoo, tmp_path, monkeypatch):
    def no_network(*a, **k):
        raise AssertionError("the converter opened a connection")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    with pytest.raises(SystemExit) as exc:
        convert_checkpoint.main(["--version", "toy", "--out-dir", str(tmp_path), "--device", "cpu"])
    msg = str(exc.value.code)
    assert "https://example.invalid/models/toy_rpf.pth" in msg and str(tmp_path / "toy_rpf.pth") in msg
    with pytest.raises(SystemExit) as exc:
        convert_checkpoint.main(["--all", "--out-dir", str(tmp_path), "--device", "cpu"])
    assert exc.value.code not in (0, None)
    assert os.listdir(tmp_path) == []


def test_convert_cli_all_and_its_sanity_forward(toy, toy_zoo, tmp_path, capsys):
    cfg, sd, released = toy
    torch.save({"model": released}, tmp_path / "toy_rpf.pth")
    written = convert_checkpoint.main(["--all", "--out-dir", str(tmp_path), "--device", "cpu"])
    assert written == [str(tmp_path / "toy.npz")]
    out = capsys.readouterr().out
    assert "wrote" in out and "pred_gravity_original" in out  # the sanity forward ran
    img = np.random.default_rng(0).integers(0, 256, (70, 90, 3), dtype=np.uint8)
    got = PerspectiveFields("toy", params=written[0], device="cpu").inference(img)
    want = PerspectiveFields("toy", params=sd, device="cpu").inference(img)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_export_equals_jaxs_names_and_round_trips(toy, tmp_path):
    cfg, sd, _ = toy
    npz = tmp_path / "p.npz"
    save_params(sd, str(npz))
    got = export_torch.main(["--params", str(npz), "--out", str(tmp_path / "p.pth")])
    want = jax_flax_to_torch_names(jax_load_params(str(npz)))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    blob = torch.load(tmp_path / "p.pth", weights_only=True)
    net = PersNet(cfg)
    net.load_state_dict(blob["model"], strict=True)
    for k, v in sd.items():
        assert torch.equal(net.state_dict()[k], v), k
    # the port's own weights export too, without an .npz
    direct = export_torch.export(net, str(tmp_path / "q.pth"))
    assert all(torch.equal(direct[k], got[k]) for k in got)


# ---------------------------------------------------------------------------
# the demo and the trainer under torchrun
# ---------------------------------------------------------------------------


def test_demo_prints_the_parameters_and_writes_both_pngs(tmp_path, capsys):
    with pytest.warns(UserWarning, match="random initialization"):
        pred = demo.main(["--device", "cpu", "--dtype", "float32", "--output", str(tmp_path)])
    out = capsys.readouterr().out
    for name in ("roll", "pitch", "vfov", "cx", "cy"):
        assert re.search(rf"^{name}: -?\d+\.\d\d$", out, re.M), name
    for png in ("perspective_pred.png", "param_pred.png"):
        data = (tmp_path / png).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 10_000
    assert pred["pred_gravity_original"].shape == (480, 640, 2)


def test_demo_lists_the_zoo(capsys):
    demo.main(["--list"])
    out = capsys.readouterr().out
    assert all(v in out for v in model_zoo)


def _losses(text: str) -> list[float]:
    return [float(m) for m in re.findall(r"^step\s+\d+\s+loss (\S+)", text, re.M)]


def test_train_under_torchrun_matches_one_process(tmp_path):
    """Two gloo ranks (torchrun --standalone) on the --tiny config: the
    losses of the one-process run; rank 0 checkpoints and saves; a second
    run resumes on both ranks."""
    common = ["--tiny", "--size", "64", "--batch", "4", "--chunk", "1", "--log-every", "1",
              "--device", "cpu", "--backend", "gloo"]
    ckpt, out = tmp_path / "ckpt", tmp_path / "p.npz"

    def torchrun(*args):
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
             "-m", "perspectivefields_tpu_torch.tools.train", *common, *args],
            cwd=_REPO, capture_output=True, text=True, timeout=240,
            env={**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1"},
        )
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    first = torchrun("--steps", "2", "--ckpt-dir", str(ckpt), "--ckpt-every", "2", "--out", str(out))
    assert sorted(os.listdir(ckpt)) == ["step_00000002"] and out.exists()
    resumed = torchrun("--steps", "3", "--ckpt-dir", str(ckpt), "--ckpt-every", "1")
    assert resumed.count("resumed from") == 1  # rank 0 logs alone
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = ttrain.main([*[a for a in common if a not in ("--backend", "gloo")], "--steps", "3"])
    solo = _losses(buf.getvalue())
    assert state.step == 3 and len(solo) == 3
    np.testing.assert_allclose(_losses(first) + _losses(resumed), solo, rtol=1e-3)
