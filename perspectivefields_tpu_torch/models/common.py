"""Helpers shared by the port's modules: channels-last convolution and a
seeded random initialization."""

from __future__ import annotations

import math

import torch
from torch import nn


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW ``nn.Conv2d`` to a channels-last (B, H, W, C) tensor.

    The permutes are views: the conv sees a channels_last-format tensor and
    returns one, so no layout copy is made around it."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def linear_weights(linear: nn.Module) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A Linear's whole weight and bias, for a kernel composed from them. A
    tensor-parallel Linear (``parallel.tensor_parallel``) gathers its
    shards, with their gradient; a plain one gives its own."""
    full = getattr(linear, "full_weights", None)
    return full() if full is not None else (linear.weight, linear.bias)


@torch.no_grad()
def init_random_(module: nn.Module, seed: int) -> nn.Module:
    """Deterministic random weights from ``seed``, in the JAX package's init
    scheme (flax defaults): matrices and conv kernels ~ N(0, 1/fan_in),
    biases 0, norm scales 1. Parameters named ``gamma`` (ConvNeXt layer
    scale) and buffers keep their constructed values."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in sorted(module.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() >= 2:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
        elif leaf == "weight":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
    return module
