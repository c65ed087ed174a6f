"""MiT (Mix Vision Transformer / SegFormer encoder) in PyTorch.

Port of perspectivefields_tpu/models/mit.py (reference:
mix_transformers.py:14-543): four stages of OverlapPatchEmbed (strided conv
+ LN) followed by pre-LN transformer blocks with spatial-reduction
attention and Mix-FFN; outputs the stride 4/8/16/32 maps, channels-last.

SRAttention sends blocks that pass ``kernels.fused_attention.use_kernel``
(at 320^2: the 25 blocks of stages 2-4) to the hand-written CUDA kernel;
the others run the plain path. ``fuse_ffn`` sends every MixFFN to the fused
MixFFN (``kernels.mixffn``: the CUDA kernel for CUDA tensors, its plain
version on the CPU), as JAX's ``fuse_ffn`` does. Stochastic depth is the
identity at inference and is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import BackboneConfig

from ..kernels.fused_attention import fused_attention, use_kernel
from ..kernels.mixffn import mixffn
from ..ops.activations import gelu
from .common import conv_nhwc


def mit_spec(name: str) -> BackboneConfig:
    """Named MiT variants b0-b5 (SegFormer family); the reference ships b3."""
    table = {
        "mitb0": ((32, 64, 160, 256), (2, 2, 2, 2)),
        "mitb1": ((64, 128, 320, 512), (2, 2, 2, 2)),
        "mitb2": ((64, 128, 320, 512), (3, 4, 6, 3)),
        "mitb3": ((64, 128, 320, 512), (3, 4, 18, 3)),
        "mitb4": ((64, 128, 320, 512), (3, 8, 27, 3)),
        "mitb5": ((64, 128, 320, 512), (3, 6, 40, 3)),
    }
    if name not in table:
        raise ValueError(f"unknown MiT variant: {name}")
    dims, depths = table[name]
    return BackboneConfig(name=name, dims=dims, depths=depths)


class SRAttention(nn.Module):
    """Attention with K/V from an (sr x sr)-strided conv + LN of the tokens
    (reference mix_transformers.py:59-141)."""

    def __init__(
        self, dim: int, num_heads: int, sr_ratio: int = 1, qkv_bias: bool = True,
        ln_eps: float = 1e-6, use_kernels: bool = False,
    ):
        super().__init__()
        self.dim, self.num_heads, self.sr_ratio = dim, num_heads, sr_ratio
        self.qkv_bias, self.use_kernels = qkv_bias, use_kernels
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=ln_eps)

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None):
        """x: LN'd (B, H, W, C) map; ``residual`` (same shape) is added to
        the output when given."""
        b, h, w, c = x.shape
        head_dim = self.dim // self.num_heads
        scale = head_dim**-0.5
        if self.sr_ratio > 1:
            kv_in = self.norm(conv_nhwc(self.sr, x)).reshape(b, -1, c)
        else:
            kv_in = x.reshape(b, h * w, c)

        if use_kernel(
            self.use_kernels, self.qkv_bias, h * w, head_dim, kv_in.shape[1], x.device
        ):
            out = fused_attention(
                x.reshape(b, h * w, c).contiguous(), kv_in.contiguous(),
                self.q.weight, self.q.bias, self.kv.weight, self.kv.bias,
                self.proj.weight, self.proj.bias, self.num_heads, scale,
                residual=(
                    None if residual is None
                    else residual.reshape(b, h * w, c).contiguous()
                ),
            )
            return out.reshape(b, h, w, c)

        q = self.q(x).reshape(b, h * w, self.num_heads, head_dim)
        kv = self.kv(kv_in).reshape(b, -1, 2, self.num_heads, head_dim)
        k, v = kv[:, :, 0], kv[:, :, 1]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, h, w, c)
        out = self.proj(out)
        return out if residual is None else residual + out


class DWConv(nn.Module):
    """3x3 depthwise conv (reference DWConv; torch name ``dwconv.dwconv``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x):
        return conv_nhwc(self.dwconv, x)


class MixFFN(nn.Module):
    """fc1 -> 3x3 depthwise conv on the hidden map -> GELU -> fc2.
    ``fused`` runs the whole FFN as one fused MixFFN (same state dict)."""

    def __init__(self, dim: int, hidden_dim: int, fused: bool = False):
        super().__init__()
        self.fused = fused
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.dwconv = DWConv(hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x):
        if self.fused:
            dw = self.dwconv.dwconv
            return mixffn(
                x.contiguous(), self.fc1.weight, self.fc1.bias, dw.weight, dw.bias,
                self.fc2.weight, self.fc2.bias,
            )
        return self.fc2(gelu(self.dwconv(self.fc1(x))))


class Block(nn.Module):
    """Pre-LN transformer block: x + attn(LN(x)); x + ffn(LN(x))."""

    def __init__(
        self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int = 4,
        qkv_bias: bool = True, ln_eps: float = 1e-6, use_kernels: bool = False,
        fuse_ffn: bool = False,
    ):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias, ln_eps, use_kernels)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = MixFFN(dim, dim * mlp_ratio, fuse_ffn)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv + LayerNorm."""

    def __init__(self, in_ch: int, dim: int, patch_size: int, stride: int, ln_eps: float = 1e-6):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch_size, stride=stride, padding=patch_size // 2)
        self.norm = nn.LayerNorm(dim, eps=ln_eps)

    def forward(self, x):
        return self.norm(conv_nhwc(self.proj, x))


class MixViT(nn.Module):
    """Four-stage MiT encoder: (B, H, W, 3) -> stride 4/8/16/32 NHWC maps.

    Attribute names follow the reference state dict (``patch_embed1``,
    ``block1.0.attn.kv``, ``norm1``)."""

    def __init__(
        self, spec: BackboneConfig = BackboneConfig(), use_kernels: bool = False,
        fuse_ffn: bool = False,
    ):
        super().__init__()
        in_ch = 3
        for s in range(4):
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_ch, spec.dims[s], 7 if s == 0 else 3, 4 if s == 0 else 2, spec.ln_eps,
            ))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                Block(
                    spec.dims[s], spec.num_heads[s], spec.sr_ratios[s],
                    spec.mlp_ratio, spec.qkv_bias, spec.ln_eps, use_kernels, fuse_ffn,
                )
                for _ in range(spec.depths[s])
            ))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(spec.dims[s], eps=spec.ln_eps))
            in_ch = spec.dims[s]

    def forward(self, x):
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x)
            x = getattr(self, f"norm{s}")(x)
            outs.append(x)
        return tuple(outs)
