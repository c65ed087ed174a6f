"""A cell cut to a size the CPU runs in seconds, for the CPU tests: the
narrow MiT of the port's own smoke model at 64x64, narrow heads, small
frames and batches, float32 weights (and, for inference, float32 compute, so
the program and the reference agree to rounding)."""

from __future__ import annotations

import copy

from h100bench import harness

BACKBONE = {"name": "tiny", "dims": [8, 16, 24, 32], "depths": [1, 1, 1, 1],
            "num_heads": [1, 2, 3, 4], "sr_ratios": [8, 4, 2, 1], "mlp_ratio": 4,
            "qkv_bias": True, "ln_eps": 1e-6, "drop_path_rate": 0.1}


def spec(workload: str, compute_dtype: str = "float32") -> tuple[dict, dict]:
    """(BENCHMARK.json, the tiny spec of ``workload``), its limits the
    cell's own."""
    bench = harness.load_benchmark()
    out = harness.cell_spec(bench, workload)
    cfg = copy.deepcopy(out["config"])
    m = cfg["model"]
    m["backbone"] = BACKBONE
    for head in ("gravity", "latitude"):
        m[head]["embed_dim"] = m[head]["fusion_dim"] = 16
    m["resize"] = [64, 64]
    if m["param"]["name"] == "ParamNetConvNextRegress":
        m["param"]["input_size"] = 32
    cfg["run"]["compute_dtype"] = compute_dtype
    cfg["init"]["dtype"] = "float32"
    tr = copy.deepcopy(out["traffic"])
    driver = tr["driver"]
    if driver == "batch":
        tr.update(batch=4, image_hw=[96, 128], pool=8, warm_calls=2,
                  check={"calls": 2, "from_calls_per_s": 1}, profile={"calls": 2})
    elif driver == "stream":
        tr.update(batch=4, image_hw=[96, 128], pool=8, warm_batches=2, check={"images": 8},
                  profile={"batches": 2})
    elif driver == "single":
        tr.update(sizes_hw=[[48, 64], [80, 60], [54, 96]], pool_per_size=2, warm_rounds=1,
                  check={"requests": 4, "from_requests_per_s": 2}, profile={"requests": 3})
    else:
        tr.update(batch=4, size=64, pool=3, profile={"steps": 1})
    out.update(config=cfg, traffic=tr)
    return bench, out


def run(workload: str, seed: int = 2**33 + 5, seconds: float = 1.0, trace: bool = False,
        compute_dtype: str = "float32"):
    """One tiny run on the CPU: (the Run, its result line)."""
    bench, sp = spec(workload, compute_dtype)
    r = harness.Run(sp, seed, seconds, trace, "cpu", harness.process_started())
    peak = harness.execute(r)
    return r, harness.result_line(r, bench, peak, 1)
