"""Export weights to a reference-format PyTorch checkpoint.

Port of tools/export_torch.py: a flat ``.npz`` (JAX's or the port's
``save_params``) -> ``{"model": state_dict}`` ``.pth`` with the reference's
module names and torch layouts (``checkpoint.flax_to_torch_names``), which
the reference implementation and ``PerspectiveFields(params=...)`` load.

    python -m perspectivefields_tpu_torch.tools.export_torch --params run/params.npz --out model.pth
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..checkpoint import _unflatten, flax_to_torch_names, state_dict_to_jax


def export(params, out: str) -> dict[str, torch.Tensor]:
    """``params`` (a flat .npz path, or the port's state dict or model) ->
    ``out`` as ``{"model": state_dict}``; returns the state dict."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(params, dict):
        tree = state_dict_to_jax(params)
    else:
        with np.load(params) as z:
            tree = _unflatten({k: z[k] for k in z.files})
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flax_to_torch_names(tree).items()}
    torch.save({"model": sd}, out)
    return sd


def main(argv=None) -> dict[str, torch.Tensor]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--params", required=True, help="flat .npz params")
    ap.add_argument("--out", required=True, help="output .pth path")
    args = ap.parse_args(argv)
    sd = export(args.params, args.out)
    print(f"wrote {args.out} ({len(sd)} tensors)")
    return sd


if __name__ == "__main__":
    main()
