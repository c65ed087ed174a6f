"""The ``cuda`` marker: a test that needs an NVIDIA GPU; it looks for one
inside the test and skips without one. CPU tests run with few threads a
worker (the workers share the machine)."""

import os


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips on machines without one")
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    import torch

    if not torch.cuda.is_available():
        torch.set_num_threads(2)
