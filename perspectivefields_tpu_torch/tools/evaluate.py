"""Evaluate a model's field and parameter accuracy on synthetic camera crops.

Port of tools/evaluate.py: a seeded synthetic eval set (random cameras ->
pano crops + analytic GT fields, rendered on the device), the model's
forward, and the paper's metrics: mean / median up-vector angular error,
latitude error and camera-parameter errors.

    python -m perspectivefields_tpu_torch.tools.evaluate \\
        --version Paramnet-360Cities-edina-centered --samples 256 --batch 32
    python -m perspectivefields_tpu_torch.tools.evaluate --params run/params.npz \\
        --tiny --size 64 --device cpu
"""

from __future__ import annotations

import argparse

from .train import model_config, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--version", default="Paramnet-360Cities-edina-centered")
    ap.add_argument("--params", default=None, help=".npz (JAX layout) or released .pth")
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--tiny", action="store_true", help="the trainer's tiny model (smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import PerspectiveFields
    from ..data import data_iterator
    from ..evaluation import evaluate_pairs

    device = resolve_device(args.device)
    if args.tiny:
        # the trainer's --tiny model, so its saved weights load
        model = PerspectiveFields(version="custom", config=model_config(True, args.size),
                                  params=args.params, compute_dtype="float32", device=device)
    else:
        model = PerspectiveFields(version=args.version, params=args.params,
                                  compute_dtype="bfloat16", device=device)
    h, w = model.cfg.resize
    it = data_iterator(args.seed, batch_size=args.batch, im_hw=(h, w), device=device)
    res = evaluate_pairs(model, it, max_samples=args.samples)
    n = res.pop("samples")
    print(f"eval over {n} synthetic crops ({h}x{w}):")
    for k, v in res.items():
        print(f"  {k:16s} {v:8.3f}")
    res["samples"] = n
    return res


if __name__ == "__main__":
    main()
