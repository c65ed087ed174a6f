"""Read the numbers that decide ``correct`` over many seeds, in one
process, to set each cell's limits (``limits/<cell>.json``).

    python3 -m h100bench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--faults] [--seconds 2] [--out FILE]

For each of ``--seeds`` it runs the cell as a benchmark run does
(``harness.execute``: set-up, a window of ``--seconds`` at the cell's own
load, release, the comparison with the plain reference): the program's
readings. For each of ``--control-seeds`` it does the same with the
control in the program's place (the driver's ``CONTROL``: the reference
computed in float8, one precision step below the bfloat16 the
configurations state): the control's readings, which must fail.
``--faults`` also reads, on the control seeds, each fault the driver plants
in the reference put in the program's place (its ``FAULTS``). One JSON line
per reading on standard output (and in ``--out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

from h100bench import harness


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def reading(spec: dict, seed: int, seconds: float, control: str | None = None,
            device: str = "cuda:0") -> dict:
    """One reading of the program (``control`` None), of the control, or of
    a planted fault."""
    run = harness.Run(spec, seed, seconds, False, device, harness.process_started())
    harness.execute(run, control)
    return {"workload": run.cell["name"], "seed": seed, "kind": control or "program",
            "correct": run.correct, "numbers": {k: c["value"] for k, c in run.checks.items()},
            "problems": run.problems, "compared": run.ctx.get("compared"),
            **{k: run.ctx[k] for k in ("gaps", "bf16_gaps", "detail") if k in run.ctx}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    drv = harness.driver(spec["traffic"]["driver"])
    jobs = [(s, None) for s in args.seeds] + [(s, drv.CONTROL) for s in args.control_seeds]
    if args.faults:
        jobs += [(s, f) for f in getattr(drv, "FAULTS", ()) for s in args.control_seeds]
    lines = []
    for seed, control in jobs:
        line = reading(spec, seed, args.seconds, control)
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    harness.set_cache_dirs()
    sys.exit(main())
