"""The repository's root ``conftest.py``: the torch-thread policy of an
xdist worker."""

import importlib.util
import os
from pathlib import Path

import pytest
import torch

# Loaded by path under a name of its own: ``tests/conftest.py`` is also
# called ``conftest``.
_spec = importlib.util.spec_from_file_location(
    "root_conftest", Path(__file__).resolve().parents[1] / "conftest.py"
)
conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(conftest)


@pytest.fixture
def threads():
    n = torch.get_num_threads()
    yield n
    torch.set_num_threads(n)


@pytest.mark.parametrize("workers", [1, 3, 6, 64])
def test_worker_gets_its_share_of_the_cores(monkeypatch, threads, workers):
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(workers))
    conftest.share_cores_among_workers()
    cpus = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    assert torch.get_num_threads() == max(1, cpus // workers)


def test_run_without_workers_keeps_torchs_threads(monkeypatch, threads):
    monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    torch.set_num_threads(3)
    conftest.share_cores_among_workers()
    assert torch.get_num_threads() == 3


@pytest.mark.skipif(not hasattr(os, "sched_getaffinity"), reason="no CPU affinity on this platform")
def test_share_counts_the_cpus_the_process_may_use(monkeypatch, threads):
    """A process pinned to 4 of the host's CPUs splits those 4, not all."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2, 3})
    monkeypatch.setattr(os, "cpu_count", lambda: 64)
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "2")
    conftest.share_cores_among_workers()
    assert torch.get_num_threads() == 2
