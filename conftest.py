"""How pytest runs ``tests/`` across xdist workers: each worker's share of
the cores for torch. ``tests/conftest.py`` sets up JAX's CPU platform; this
file touches neither JAX nor any test."""

import os


def pytest_configure(config):
    share_cores_among_workers()


def usable_cpus():
    """The CPUs this process may run on (its affinity, where the platform
    has one), not every CPU the host shows."""
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count()


def share_cores_among_workers():
    """In an xdist worker, size torch's intra-op pool to the worker's share
    of the cores: at torch's default of one thread per core, the workers'
    parallel regions wait on one another. Runs in ``pytest_configure``, so
    module-level model builds during collection are covered. A run without
    workers keeps torch's default."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return
    import torch

    torch.set_num_threads(max(1, usable_cpus() // int(workers)))
