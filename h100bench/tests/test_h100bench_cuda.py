"""On the chip (marked ``cuda``; skipped without a card): one run of each
cell at its own size comes out correct, and the control, and each planted
training fault, put in the program's place at the cell's own size, come out
not correct. Run them there with

    python3 -m pytest h100bench/tests/test_h100bench_cuda.py -m cuda
"""

from __future__ import annotations

import json
import subprocess

import pytest

from h100bench import calibrate, harness
from h100bench.drivers import train

BENCH = harness.load_benchmark()
CELLS = sorted(w["name"] for w in BENCH["workloads"])


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_run_at_the_cells_size_is_correct(workload):
    _need_card()
    out = subprocess.run(BENCH["command"] + ["--workload", workload, "--seed", str(2**31 + 17),
                                             "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_at_the_cells_size_is_not_correct(workload):
    _need_card()
    spec = harness.cell_spec(BENCH, workload)
    control = harness.driver(spec["traffic"]["driver"]).CONTROL
    assert not calibrate.reading(spec, 2**31 + 23, 2.0, control)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", train.FAULTS)
def test_a_training_fault_at_the_cells_size_is_not_correct(fault):
    _need_card()
    spec = harness.cell_spec(BENCH, "trainer.b16")
    assert not calibrate.reading(spec, 2**31 + 29, 2.0, fault)["correct"]
