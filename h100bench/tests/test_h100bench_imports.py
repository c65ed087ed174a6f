"""What a run imports, and how the command fails where it cannot run."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from h100bench import harness

REFERENCE = sorted((harness.BENCH / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "math", "numpy", "torch"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # inside the reference package
                assert node.module in (None, "model", "preprocess", "train"), node.module
                continue
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] in allowed, f"{path.name} imports {name}"


def test_a_run_of_every_driver_imports_no_jax():
    code = (
        "from h100bench.tests import tiny\n"
        "from h100bench import harness\n"
        "for wl in ('flagship.batch32', 'flagship.single', 'flagship.stream', 'trainer.b16'):\n"
        "    tiny.run(wl, seconds=0.3)\n"
        "import h100bench.run, h100bench.calibrate\n"
        "print(harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "perspectivefields_tpu_torch_lookalike", sys)
    assert "perspectivefields_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "perspectivefields_tpu.api", sys)
    assert "perspectivefields_tpu" in harness.forbidden_modules()


def _command(cwd):
    bench = harness.load_benchmark()
    return subprocess.run(bench["command"] + ["--workload", "flagship.batch32", "--seed", "1",
                                              "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_command_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _command(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_with_only_the_benchmark_files_the_command_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("workload", sorted(w["name"] for w in harness.load_benchmark()["workloads"]))
def test_a_traffic_files_env_is_set_before_torch_loads(workload):
    env = harness.cell_spec(harness.load_benchmark(), workload)["traffic"].get("env", {})
    assert all(isinstance(k, str) and isinstance(v, str) for k, v in env.items())
    code = (
        "import builtins, json, os\n"
        "seen = {}\n"
        "real = builtins.__import__\n"
        "def imp(name, *a, **k):\n"
        "    if name == 'torch' and not seen:\n"
        f"        seen.update({{k: os.environ.get(k) for k in {sorted(env)!r}}}, torch=1)\n"
        "    return real(name, *a, **k)\n"
        "builtins.__import__ = imp\n"
        "from h100bench import run\n"
        f"run.main(['--workload', {workload!r}, '--seed', '1', '--seconds', '1'])\n"
        "print(json.dumps(seen))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {**env, "torch": 1}
