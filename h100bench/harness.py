"""The harness: finds a cell's configuration, traffic, limits, driver and
metric readers by the names in ``BENCHMARK.json``, runs the cell once and
assembles the result line.

A run is: the driver's set-up (everything before the first timed call:
imports, kernel builds, weights, the program, the traffic, warm-up), its
measured window, with ``--trace 1`` a short profiled stretch, the release
of the program's state, the comparison with the plain reference, and the
metric readers. ``setup_s`` runs from the start of the process to the first
timed call.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "perspectivefields_tpu")


def process_started() -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (from /proc; where that cannot be read, now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout, so only a checkout's first run builds. (The port's CUDA
    kernels build under its own ``_build/`` and its host library under
    ``native/``, both inside the checkout.)"""
    cache = root / ".h100bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """A cell with its configuration, traffic and limits, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(root / configs[cell["config"]]["file"])
    traffic = _json(BENCH / "workloads" / f"{cell['traffic']}.json")
    limits_path = BENCH / "limits" / f"{workload}.json"
    limits = _json(limits_path) if limits_path.exists() else {}
    return {"cell": cell, "config": cfg, "traffic": traffic, "limits": limits}


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` the per-layer metrics that move one of them."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if m["moves"] in moved
            and workload in m.get("workloads", [workload])]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``; where there is none, ``metrics/<quantity>.py``,
    the quantity being the name up to its first dot, so the cell groups of
    one quantity (``forward_ms.batch``, ``forward_ms.single``) share a file."""
    path = BENCH / "metrics" / f"{name}.py"
    return path if path.exists() else BENCH / "metrics" / f"{name.split('.')[0]}.py"


def reader(name: str):
    """The metric's reader file's ``read``."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"h100bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """One run of one cell: its inputs, what it measured (``ctx``, which the
    metric readers read) and what it compared (``checks``, ``problems``)."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool, device: str,
                 started: float):
        self.cell, self.config = spec["cell"], spec["config"]
        self.traffic, self.limits = spec["traffic"], spec["limits"]
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.started = started
        self.ctx: dict = {"config": self.config, "traffic": self.traffic, "seconds": seconds}
        self.checks: dict = {}
        self.problems: list[str] = []

    def log(self, msg: str) -> None:
        print(f"[h100bench {self.cell['name']}] {msg}", file=sys.stderr, flush=True)

    def mark(self, what: str) -> None:
        """Log how far into the process a step of set-up ended."""
        self.log(f"{what} at {time.perf_counter() - self.started:.2f} s")

    def start_window(self) -> float:
        """Mark the first timed call: set-up ends here."""
        t = time.perf_counter()
        self.ctx["setup_s"] = t - self.started
        return t

    def compared(self, numbers: dict) -> None:
        for key, value in numbers.items():
            self.checks[key] = {"value": value, "limit": self.limits.get(key)}

    @property
    def correct(self) -> bool:
        return (not self.problems and bool(self.checks) and self.ctx.get("failed", 0) == 0
                and all(c["limit"] is not None and c["value"] <= c["limit"]
                        for c in self.checks.values()))


def driver(name: str):
    return importlib.import_module(f"h100bench.drivers.{name}")


def execute(run: Run, control: str | None = None) -> int:
    """Run the cell once; returns the peak of device memory allocated
    before the reference ran (bytes, 0 on the CPU). ``control``: compare
    the control, or a planted fault, in the program's place (the driver's
    ``CONTROL`` or one of its ``FAULTS``; for setting limits)."""
    import torch

    drv = driver(run.traffic["driver"])
    run.mark("imports done")
    state = drv.setup(run)
    drv.window(run, state)
    cuda = torch.device(run.device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    peak = max(peak, run.ctx.get("setup_peak_bytes", 0))
    if run.trace:
        drv.profile(run, state)
    drv.release(run, state)
    drv.check(run, state, control)
    return peak


def result_line(run: Run, bench: dict, peak: int, count: int) -> dict:
    import torch

    cuda = torch.device(run.device).type == "cuda"
    metrics = {}
    for m in cell_metrics(bench, run.cell["name"], run.trace):
        value = reader(m["name"])(run.ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": count, "memory_peak_bytes": peak}
    line = {"correct": run.correct, "attempted": run.ctx.get("attempted", 0),
            "failed": run.ctx.get("failed", 0), "metrics": metrics, "device": device}
    tr = run.ctx.get("trace")
    if run.trace and tr is not None:
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        host = run.ctx.get("host_trace", tr)
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": host.idle_gaps()}
    if run.problems:
        line["problems"] = run.problems[:5]
    line["checks"] = run.checks
    return line
