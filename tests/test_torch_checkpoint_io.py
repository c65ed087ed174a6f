"""The port's checkpoint I/O: parameters as JAX-layout ``.npz`` both ways,
and train-state checkpoints (JAX checkpoint/io.py's contract), on CPU.

* ``save_params`` writes what JAX's ``load_params`` reads (the same tree as
  JAX's ``convert_torch_state_dict`` of the same weights), and ``load_params``
  reads what JAX's ``save_params`` writes, exactly;
* ``save_train_state`` keeps the newest two ``step_<n>/`` directories;
  ``restore_train_state`` takes the newest usable one, skips a corrupt one
  with a warning, leaves the template as it was after a failed load, and
  raises FileNotFoundError chained to the last failure when none restores;
* a restored state continues bit for bit as the run without the save;
* ``tools.train`` resumes from ``--ckpt-dir`` and refuses to start fresh
  where step directories exist but none restores (JAX tools/train.py:101-118).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from perspectivefields_tpu.checkpoint import io as jax_io
from perspectivefields_tpu.checkpoint.torch_convert import convert_torch_state_dict
from perspectivefields_tpu_torch import checkpoint
from perspectivefields_tpu_torch.data import make_step_batch_fn
from perspectivefields_tpu_torch.models import PersNet
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.tools import train as tool_train
from perspectivefields_tpu_torch.train import create_train_state, make_train_step


CFG = tool_train.model_config(True, 64)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def state_dict():
    return init_random_(PersNet(CFG), seed=3).state_dict()


def test_state_dict_to_jax_equals_jax_converter(state_dict):
    got = dict(_flat(checkpoint.state_dict_to_jax(state_dict)))
    want = dict(_flat(convert_torch_state_dict({k: v.numpy() for k, v in state_dict.items()},
                                               strict=True)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_npz_loads_in_jax(state_dict, tmp_path):
    path = str(tmp_path / "port.npz")
    checkpoint.save_params(state_dict, path)
    got = dict(_flat(jax_io.load_params(path)))
    want = dict(_flat(convert_torch_state_dict({k: v.numpy() for k, v in state_dict.items()},
                                               strict=True)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and back, from a module as well as from a state dict
    net = init_random_(PersNet(CFG), seed=3)
    checkpoint.save_params(net, path)
    back = checkpoint.load_params(path)
    PersNet(CFG).load_state_dict(back, strict=True)
    for k, v in state_dict.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError):
        checkpoint.save_params(net, str(tmp_path / "dir"))


def test_jax_npz_loads_in_the_port(state_dict, tmp_path):
    path = str(tmp_path / "jax.npz")
    jax_io.save_params(convert_torch_state_dict({k: v.numpy() for k, v in state_dict.items()},
                                                strict=True), path)
    back = checkpoint.load_params(path)
    assert back.keys() == state_dict.keys()
    for k, v in state_dict.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def _state(seed=0, cfg=CFG):
    return create_train_state(init_random_(PersNet(cfg), seed=seed), learning_rate=1e-3)


def _batch(step=0):
    b = make_step_batch_fn(0, batch_size=2, im_hw=(64, 64), device="cpu")(step)
    b = {k: v for k, v in b.items() if k != "cams"}
    b["image"] = b["image"] - torch.tensor(CFG.pixel_mean)
    return b


def test_keep_two_and_continue_bit_for_bit(tmp_path):
    step = make_train_step(CFG)
    state = _state()
    for i in range(3):
        state, _ = step(state, _batch(i))
        checkpoint.save_train_state(state, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    # continue without the save ...
    _, m_direct = step(state, _batch(3))
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    # ... and from the restored step 3
    restored = checkpoint.restore_train_state(str(tmp_path), _state(seed=9))
    assert restored.step == 3
    _, m = step(restored, _batch(3))
    assert float(m["loss"]) == float(m_direct["loss"])
    for k, v in restored.model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_corrupt_newest_is_skipped_with_a_warning(tmp_path):
    step = make_train_step(CFG)
    state = _state()
    for i in range(2):
        state, _ = step(state, _batch(i))
        checkpoint.save_train_state(state, str(tmp_path))
    with open(tmp_path / "step_00000002" / "state.pt", "wb") as f:
        f.write(b"garbage")
    with pytest.warns(UserWarning, match="unusable"):
        restored = checkpoint.restore_train_state(str(tmp_path), _state(seed=9))
    assert restored.step == 1


def test_nothing_restorable_raises_chained_and_leaves_the_template(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(str(tmp_path / "missing"), _state())
    # a checkpoint of another model: skipped, the template untouched
    other = dataclasses.replace(CFG, backbone=dataclasses.replace(CFG.backbone, depths=(1, 1, 2, 1)))
    checkpoint.save_train_state(_state(cfg=other), str(tmp_path))
    template = _state(seed=5)
    before = {k: v.clone() for k, v in template.model.state_dict().items()}
    with pytest.warns(UserWarning, match="unusable"), pytest.raises(FileNotFoundError) as info:
        checkpoint.restore_train_state(str(tmp_path), template)
    assert isinstance(info.value.__cause__, ValueError)
    assert template.step == 0
    for k, v in template.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_trainer_resumes_and_refuses_to_start_fresh(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    args = ["--tiny", "--size", "64", "--batch", "2", "--device", "cpu", "--ckpt-dir", ckpt,
            "--ckpt-every", "1", "--chunk", "1"]
    tool_train.main(["--steps", "2", *args])
    state = tool_train.main(["--steps", "3", *args])
    assert state.step == 3 and "resumed from" in capsys.readouterr().out
    assert sorted(os.listdir(ckpt)) == ["step_00000002", "step_00000003"]
    for d in os.listdir(ckpt):
        with open(os.path.join(ckpt, d, "state.pt"), "wb") as f:
            f.write(b"garbage")
    with pytest.warns(UserWarning), pytest.raises(SystemExit, match="refusing to start fresh"):
        tool_train.main(["--steps", "4", *args])


def test_evaluate_reads_the_trainers_npz_and_both_need_a_card_by_default(tmp_path, monkeypatch):
    from perspectivefields_tpu_torch.tools import evaluate as tool_evaluate

    out = str(tmp_path / "p.npz")
    tool_train.main(["--tiny", "--size", "64", "--batch", "2", "--steps", "1", "--device", "cpu",
                     "--out", out])
    res = tool_evaluate.main(["--tiny", "--size", "64", "--batch", "2", "--samples", "4",
                              "--device", "cpu", "--params", out])
    assert res["samples"] == 4 and all(np.isfinite(v) for v in res.values())
    # the default device is the card, with no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool_train.main(["--tiny", "--size", "64", "--steps", "1"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool_evaluate.main(["--tiny", "--size", "64", "--samples", "2"])
