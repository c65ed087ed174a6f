"""Tracing, profiling and a non-finite guard.

Port of perspectivefields_tpu/utils/profiling.py on PyTorch:

* ``trace(name)``: a span, the port's one span facility. Under an active
  profiler it is a ``torch.profiler.record_function`` range, which the
  profiler's Chrome trace holds beside the device's kernels and copies, on
  the same clock; with no profiler it records nothing (a check of one flag).
  For Nsight, run under ``torch.autograd.profiler.emit_nvtx()``, which makes
  every such range an NVTX range;
* ``profile_to(dir)``: ``torch.profiler`` over the CPU and, when present,
  CUDA around a block, written to ``dir`` as a Chrome trace;
* ``StageTimer``: host-side wall time per named stage with an items/s
  summary (serving observability), the same summary format as JAX's; each
  stage is also the span ``serving.<stage>``;
* ``guard_nans(fn)``: runs ``fn`` and raises if any floating tensor it
  returns is not finite (JAX's checkify has no PyTorch counterpart, so the
  check reads the outputs; it waits for the device).

The spans the port opens, each nested in the one before it on its line
(``pf.*``: ``api``; ``serving.*``: ``serving.BatchPredictor``;
``train.*``: ``train.train_step``):

* ``pf.call``: one ``inference_batch`` (or ``inference``) call, holding
  ``pf.preprocess`` (the host resize and normalize into the pinned buffer,
  or the uint8 stack for ``device_preprocess``);
* ``pf.forward``: the network on one device (the copy in, the device
  normalize, the module's call), in every call, every ``BatchPredictor``
  batch and each replica of ``forward_split``; it holds ``pf.graph_replay``
  where the module's forward replays a CUDA graph, or ``pf.graph_capture``
  where it captures one (``models.graphed``);
* ``pf.postprocess`` (casts and postprocess issue), ``pf.copy_out`` (the
  copies to pinned memory and their event), ``pf.wait`` (the host waiting
  for that event), ``pf.unpack`` (the per-image numpy views);
* ``serving.preprocess``, ``serving.dispatch`` (holding ``pf.forward`` and
  ``pf.copy_out``), ``serving.device_wait``, ``serving.decode``;
* ``train.step``, holding ``train.forward``, ``train.loss``,
  ``train.backward``, ``train.clip`` (the zero-fill of unreached gradients,
  any all-reduce, the clip) and ``train.optimizer`` (the learning rate and
  the optimizer's step).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def trace(name: str):
    """A span named ``name``, for a ``with`` block: a ``record_function``
    range while a profiler is active (``torch.profiler``, or ``emit_nvtx``
    for NVTX-reading tools), else a context that does nothing. Whether one
    is active is read at the call."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Profile the block (CPU, and CUDA when present) and write
    ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto).
    Yields the profiler, for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall time per named stage; .summary() gives totals and
    optional throughput."""

    def __init__(self):
        self._acc: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        """Time the block as ``name``; it is the span ``serving.<name>`` too."""
        with trace(f"serving.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._acc[name] += time.perf_counter() - t0
                self._count[name] += items

    def summary(self) -> dict[str, dict]:
        out = {}
        for name, secs in self._acc.items():
            entry = {"seconds": round(secs, 4)}
            if self._count[name]:
                entry["items_per_sec"] = round(self._count[name] / secs, 2)
            out[name] = entry
        return out


def _non_finite(out, path: str = "output"):
    """The path of the first floating tensor in ``out`` (a tensor or nested
    dict / list / tuple of them) that holds a NaN or an infinity, else None."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() and not bool(torch.isfinite(out).all()):
            return path
        return None
    if isinstance(out, dict):
        items = out.items()
    elif isinstance(out, (list, tuple)):
        items = enumerate(out)
    else:
        return None
    for key, val in items:
        found = _non_finite(val, f"{path}[{key!r}]")
        if found is not None:
            return found
    return None


def guard_nans(fn):
    """Wrap ``fn`` so that a NaN or infinity in its outputs raises
    FloatingPointError on the host.

    Usage: guarded = guard_nans(model.forward); out = guarded(x)
    """

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = _non_finite(out)
        if bad is not None:
            raise FloatingPointError(f"non-finite values in {bad}")
        return out

    return wrapper
