"""Model FLOPs of the plain reference network, counted by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device (shapes
only: nothing is computed). Matrix products and convolutions count; the
elementwise work does not.

A convolution's backward counts as its forward once for each gradient it
computes (input, weight). ``FlopCounterMode``'s own formula counts a
grouped convolution's backward as a dense one: 65x the forward of a
depthwise conv of 64 channels where 2x is right, which would put most of
the step's count in the depthwise convs."""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref_model


def _net(model_cfg: dict):
    with torch.device("meta"):
        return ref_model.PersNet(model_cfg)


def forward_flops(model_cfg: dict, batch: int) -> int:
    """FLOPs of one inference forward of ``batch`` images."""
    net = _net(model_cfg).eval()
    h, w = model_cfg["resize"]
    x = torch.empty((batch, h, w, 3), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x)
    return counter.get_total_flops()


def _conv_backward(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                   transposed, output_padding, groups, output_mask, out_shape=None, **kw) -> int:
    if transposed:
        raise ValueError("no transposed convolution in the reference network")
    forward = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def train_step_flops(model_cfg: dict, batch: int) -> int:
    """FLOPs of one training step's forward and backward of ``batch``
    images (no recompute counted)."""
    net = _net(model_cfg).eval()
    h, w = model_cfg["resize"]
    x = torch.empty((batch, h, w, 3), device="meta")
    mapping = {torch.ops.aten.convolution_backward: _conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        out = net(x)
        sum(v.sum() for v in out.values()).backward()
    return counter.get_total_flops()
