"""GELU with the JAX package's dtype rule (perspectivefields_tpu/ops/
activations.py): the exact erf form at float32, the tanh form at bfloat16,
where both are equally accurate at the output's resolution."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu_form(compute_dtype: torch.dtype) -> str:
    """The ``approximate`` argument of F.gelu that the dtype rule picks."""
    return "tanh" if compute_dtype == torch.bfloat16 else "none"


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate=gelu_form(x.dtype))


def gelu_f32(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """GELU of the float32 tensor ``x`` in float32, in the form the rule
    picks for ``compute_dtype``: what the fused kernels compute between
    their f32 accumulators and the rounding to the compute dtype."""
    return F.gelu(x, approximate=gelu_form(compute_dtype))
