"""Run one cell of the port's H100 benchmark once.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It loads and warms up the cell's program,
measures for ``--seconds``, compares what the timed path produced with the
plain reference, and prints one JSON line last on standard output: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), ``correct``, the device, and under ``checks`` each number
compared with its limit (also the last lines on standard error). It exits
non-zero, printing no result, without enough CUDA devices or when JAX or the
JAX package was imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from h100bench import harness


def main(argv=None, started: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_benchmark()
    spec = harness.cell_spec(bench, args.workload)
    chips = spec["cell"]["chips"]
    os.environ.update(spec["traffic"].get("env", {}))  # before torch and the port load

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    run = harness.Run(spec, args.seed, args.seconds, bool(args.trace), "cuda:0",
                       harness.process_started() if started is None else started)
    peak = harness.execute(run)
    line = harness.result_line(run, bench, peak, chips)
    bad = harness.forbidden_modules()
    if bad:
        print(f"h100bench: the run imported {bad}", file=sys.stderr)
        return 3
    for name, c in run.checks.items():
        run.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    _started = harness.process_started()
    harness.set_cache_dirs()  # before torch is imported
    sys.exit(main(started=_started))
