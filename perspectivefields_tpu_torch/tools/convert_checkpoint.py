"""Convert a released PerspectiveFields checkpoint (.pth) to a flat .npz.

Port of tools/convert_checkpoint.py, local files only: it reads a
reference ``.pth`` (``checkpoint.load_released``), writes JAX's flat
``<version>.npz`` (``state_dict_to_jax`` + ``save_params``, which both
packages read) into the weights directory where ``PerspectiveFields``
finds it, and runs one forward with it. Nothing is downloaded: without the
``.pth`` it exits non-zero and says where to get it and where to put it.

    python -m perspectivefields_tpu_torch.tools.convert_checkpoint \\
        --version Paramnet-360Cities-edina-centered --pth /path/to/paramnet_360cities_edina_rpf.pth
    python -m perspectivefields_tpu_torch.tools.convert_checkpoint --all   # every .pth in --out-dir
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..api import _WEIGHTS_DIR
from ..config import model_zoo
from .train import resolve_device


def pth_candidates(version: str, out_dir: str) -> list[str]:
    """Where a version's released checkpoint may sit in ``out_dir``: the
    release's own file name, then ``<version>.pth``."""
    url = model_zoo[version]["weights_url"]
    return [os.path.join(out_dir, os.path.basename(url)), os.path.join(out_dir, f"{version}.pth")]


def convert_one(version: str, pth: str | None = None, out_dir: str = _WEIGHTS_DIR,
                device="cuda") -> str:
    """``pth`` (None: found in ``out_dir``) -> ``out_dir/<version>.npz``; then
    one forward of a 320x320 image with the written file. Returns the
    .npz path."""
    from .. import PerspectiveFields
    from ..checkpoint import load_released, save_params

    if pth is None:
        found = [p for p in pth_candidates(version, out_dir) if os.path.exists(p)]
        if not found:
            url = model_zoo[version]["weights_url"]
            raise SystemExit(
                f"no checkpoint for {version!r}: download {url} and put it at "
                f"{pth_candidates(version, out_dir)[0]} (or pass --pth); nothing is downloaded here"
            )
        pth = found[0]
    elif not os.path.exists(pth):
        raise SystemExit(f"no such checkpoint: {pth}")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{version}.npz")
    save_params(load_released(pth), out)
    print(f"wrote {out}")

    # sanity: one forward with the converted weights
    model = PerspectiveFields(version=version, params=out, device=resolve_device(str(device)))
    pred = model.inference(img_bgr=np.zeros((320, 320, 3), np.uint8))
    print({k: getattr(v, "shape", v) for k, v in pred.items()})
    return out


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--version", default=None, choices=list(model_zoo))
    ap.add_argument("--pth", default=None, help="the released .pth (default: found in --out-dir)")
    ap.add_argument("--out-dir", default=_WEIGHTS_DIR, help="where the .npz goes")
    ap.add_argument("--all", action="store_true",
                    help="convert every version whose .pth sits in --out-dir")
    ap.add_argument("--device", default="cuda", help="the sanity forward's device: cuda or cpu")
    args = ap.parse_args(argv)
    if args.all:
        versions = [v for v in model_zoo
                    if any(os.path.exists(p) for p in pth_candidates(v, args.out_dir))]
        if not versions:
            raise SystemExit(
                f"no released checkpoint in {args.out_dir}; put them there by the names of "
                + ", ".join(os.path.basename(e["weights_url"]) for e in model_zoo.values())
            )
        return [convert_one(v, None, args.out_dir, args.device) for v in versions]
    if args.version:
        return [convert_one(args.version, args.pth, args.out_dir, args.device)]
    ap.error("pass --version or --all")


if __name__ == "__main__":
    main()
