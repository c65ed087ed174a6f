"""ConvNeXt trunk (used by ParamNet) in PyTorch, channels-last.

Port of perspectivefields_tpu/models/convnext.py (reference
convnext.py:16-152): stem 4x4/s4 conv + LN; three LN + 2x2/s2 downsamples;
blocks of 7x7 depthwise conv -> LN -> 1x1 expand 4x -> GELU -> 1x1 project
-> layer scale ``gamma`` -> residual; global average pool, LN, linear head.
``fused_blocks`` runs each block as one fused ConvNeXt block
(``kernels.convnext_block``: the CUDA kernel for CUDA tensors, its plain
version on the CPU), as JAX's ``fused_blocks`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.convnext_block import convnext_block
from ..ops.activations import gelu
from .common import conv_nhwc


class ConvNeXtBlock(nn.Module):
    """``fused`` runs the block as one fused ConvNeXt block (same state
    dict)."""

    def __init__(self, dim: int, layer_scale_init: float = 1e-6, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x):
        if self.fused:
            return convnext_block(
                x.contiguous(), self.dwconv.weight, self.dwconv.bias, self.norm.weight,
                self.norm.bias, self.pwconv1.weight, self.pwconv1.bias,
                self.pwconv2.weight, self.pwconv2.bias, self.gamma, eps=self.norm.eps,
            )
        y = self.norm(conv_nhwc(self.dwconv, x))
        y = self.pwconv2(gelu(self.pwconv1(y)))
        return x + y * self.gamma.to(y.dtype)


class ConvNeXt(nn.Module):
    """ConvNeXt-T by default (depths 3/3/9/3, dims 96/192/384/768), the
    configuration ParamNet uses. ``num_classes=0`` returns pooled
    features."""

    def __init__(
        self, num_classes: int = 1000, depths=(3, 3, 9, 3),
        dims=(96, 192, 384, 768), in_ch: int = 3, fused_blocks: bool = False,
    ):
        super().__init__()
        self.downsample_layers = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(in_ch, dims[0], 4, stride=4), nn.LayerNorm(dims[0], eps=1e-6)])]
            + [
                nn.ModuleList([nn.LayerNorm(dims[i - 1], eps=1e-6), nn.Conv2d(dims[i - 1], dims[i], 2, stride=2)])
                for i in range(1, 4)
            ]
        )
        self.stages = nn.ModuleList(
            nn.ModuleList(
                ConvNeXtBlock(dims[i], fused=fused_blocks) for _ in range(depths[i])
            ) for i in range(4)
        )
        self.norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.head = nn.Linear(dims[-1], num_classes) if num_classes else None

    def forward(self, x):
        for i in range(4):
            first, second = self.downsample_layers[i]
            x = second(conv_nhwc(first, x)) if i == 0 else conv_nhwc(second, first(x))
            for blk in self.stages[i]:
                x = blk(x)
        x = self.norm(x.mean(dim=(1, 2)))
        return x if self.head is None else self.head(x)
