"""MiT (Mix Vision Transformer / SegFormer encoder) in PyTorch.

Port of perspectivefields_tpu/models/mit.py (reference:
mix_transformers.py:14-543): four stages of OverlapPatchEmbed (strided conv
+ LN) followed by pre-LN transformer blocks with spatial-reduction
attention and Mix-FFN; outputs the stride 4/8/16/32 maps, channels-last.

SRAttention sends blocks that pass ``kernels.fused_attention.use_kernel``
(at 320^2: the 25 blocks of stages 2-4) to the hand-written CUDA kernel;
the others run the plain path. ``fuse_ffn`` sends every MixFFN to the fused
MixFFN (``kernels.mixffn``: the CUDA kernel for CUDA tensors, its plain
version on the CPU), as JAX's ``fuse_ffn`` does. ``fuse_block`` runs every
block that JAX's ``fuse_block`` would fuse as one whole-block kernel
(``kernels.fused_block``; at 320^2 the 21 blocks of stages 3-4), and with
``use_kernels`` also sends stage 1's one-head attention to
``kernels.stage1_attention``: each block's route is ``Block.route``.

Training mode (``train()``) adds JAX's stochastic depth (``DropPath``, the
per-block rates of ``drop_path_rate``) and, with ``remat``, recomputes each
block in the backward pass (``torch.utils.checkpoint``). The kernels are
inference-only: a block routed to one raises under autograd.
"""

from __future__ import annotations

import importlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import BackboneConfig

from ..kernels import stage1_attention as s1
from ..kernels.fused_block import fused_block, fused_block_viable, takes_width
from ..kernels.mixffn import mixffn
from ..ops.activations import gelu
from .common import conv_nhwc

# the module (``kernels.fused_attention`` is its function)
fa = importlib.import_module("..kernels.fused_attention", __package__)


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
        ln_eps: float = 1e-6, use_kernels: bool = False, fuse_block: bool = False,
    ):
        super().__init__()
        self.dim, self.num_heads, self.sr_ratio = dim, num_heads, sr_ratio
        self.qkv_bias, self.use_kernels, self.fuse_block = qkv_bias, use_kernels, fuse_block
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=ln_eps)

    def kv_input(self, x: torch.Tensor) -> torch.Tensor:
        """The (B, M, C) tokens K and V are projected from."""
        b, h, w, c = x.shape
        if self.sr_ratio > 1:
            return self.norm(conv_nhwc(self.sr, x)).reshape(b, -1, c)
        return x.reshape(b, h * w, c)

    def weights(self) -> tuple:
        """The projections as the kernels take them: q, kv, proj (out, in)."""
        return (self.q.weight, self.q.bias, self.kv.weight, self.kv.bias,
                self.proj.weight, self.proj.bias)

    def route(self, n_tokens: int, n_keys: int, device) -> str:
        """Which kernel runs the attention: "stage1_attention",
        "fused_attention" or "plain"."""
        if s1.use_kernel(self.use_kernels, self.fuse_block, self.qkv_bias, n_tokens, self.dim,
                         self.num_heads, n_keys, device):
            return "stage1_attention"
        if fa.use_kernel(self.use_kernels, self.qkv_bias, n_tokens, self.dim // self.num_heads,
                         n_keys, device):
            return "fused_attention"
        return "plain"

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None):
        """x: LN'd (B, H, W, C) map; ``residual`` (same shape) is added to
        the output when given."""
        b, h, w, c = x.shape
        head_dim = self.dim // self.num_heads
        scale = head_dim**-0.5
        kv_in = self.kv_input(x)

        route = self.route(h * w, kv_in.shape[1], x.device)
        if route != "plain":
            tokens, kv_in = x.reshape(b, h * w, c).contiguous(), kv_in.contiguous()
            res = None if residual is None else residual.reshape(b, h * w, c).contiguous()
            if route == "stage1_attention":
                out = s1.stage1_attention(tokens, kv_in, *self.weights(), scale, residual=res)
            else:
                out = fa.fused_attention(
                    tokens, kv_in, *self.weights(), self.num_heads, scale, residual=res
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


class DropPath(nn.Module):
    """Per-sample stochastic depth (JAX models/mit.py:DropPath): in training
    a sample's branch is kept with probability 1 - rate and scaled by
    1 / (1 - rate), else zeroed. The identity in eval() and at rate 0. No
    parameters, so no state-dict entry.

    The mask is drawn by ``sample`` (from the caller's ``torch.Generator``,
    or the global one) before the block runs, so a block recomputed in the
    backward pass (``remat``) applies the same mask."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def sample(self, x: torch.Tensor, generator: torch.Generator | None = None,
               rows: tuple[int, int] | None = None):
        """A (B, 1, ..., 1) keep mask for ``x``'s samples, or None where the
        branch passes unchanged (eval, rate 0). rows = (first, total): ``x``
        holds rows first.. of a global batch of ``total`` split over
        data-parallel ranks; the global batch's mask is drawn and this
        rank's rows taken, so every rank draws what one process would."""
        if not self.training or self.rate == 0.0:
            return None
        first, total = (0, x.shape[0]) if rows is None else rows
        shape = (total,) + (1,) * (x.ndim - 1)
        dev = x.device if generator is None else generator.device
        u = torch.rand(shape, generator=generator, device=dev)[first:first + x.shape[0]]
        return u.to(x.device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is None:
            return x
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype, device=x.device))


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
    """Pre-LN transformer block: x + drop(attn(LN(x))); x + drop(ffn(LN(x))).
    ``fuse_block`` runs the block after LN1 as one whole-block kernel where
    ``route`` says so (same state dict)."""

    def __init__(
        self, dim: int, num_heads: int, sr_ratio: int, mlp_ratio: int = 4,
        qkv_bias: bool = True, ln_eps: float = 1e-6, use_kernels: bool = False,
        fuse_ffn: bool = False, fuse_block: bool = False, drop_path: float = 0.0,
    ):
        super().__init__()
        self.fuse_block = fuse_block
        self.drop_path1, self.drop_path2 = DropPath(drop_path), DropPath(drop_path)
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = SRAttention(
            dim, num_heads, sr_ratio, qkv_bias, ln_eps, use_kernels, fuse_block
        )
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = MixFFN(dim, dim * mlp_ratio, fuse_ffn)

    def route(self, b: int, h: int, w: int, device) -> str:
        """Which kernel runs this block on a (b, h, w, C) map on ``device``:
        "fused_block" (its plain version on the CPU) where JAX's Block
        would fuse it (perspectivefields_tpu/models/mit.py:456-469:
        inference, q/kv biases, head_dim 64, ``fused_block_viable``), plus
        the kernel's own limits (``takes_width``: the bf16 kernel stops at
        C = 640); else the attention's route."""
        attn = self.attn
        n_keys = (h // attn.sr_ratio) * (w // attn.sr_ratio)
        hidden = self.mlp.fc1.out_features
        if (
            self.fuse_block
            and not self.training
            and attn.qkv_bias
            and attn.dim % attn.num_heads == 0
            and attn.dim // attn.num_heads == fa.HEAD_DIM
            and n_keys <= fa.MAX_KEYS
            and hidden == 4 * attn.dim
            and fused_block_viable(b, h * w, attn.dim, hidden, n_keys, attn.num_heads)
            and takes_width(attn.dim, self.norm2.weight.dtype)
        ):
            return "fused_block"
        return attn.route(h * w, n_keys, device)

    def drop_masks(self, x: torch.Tensor, generator: torch.Generator | None = None,
                   rows: tuple[int, int] | None = None) -> tuple:
        """The two branches' stochastic-depth masks for ``x`` (None, None in
        eval or at rate 0); ``rows`` as ``DropPath.sample``."""
        return self.drop_path1.sample(x, generator, rows), self.drop_path2.sample(x, generator, rows)

    def forward(self, x, masks: tuple = (None, None)):
        b, h, w, c = x.shape
        if self.route(b, h, w, x.device) == "fused_block":
            ln1 = self.norm1(x)
            attn, mlp, dw = self.attn, self.mlp, self.mlp.dwconv.dwconv
            out = fused_block(
                ln1.reshape(b, h * w, c).contiguous(), attn.kv_input(ln1).contiguous(),
                x.reshape(b, h * w, c).contiguous(), *attn.weights(),
                self.norm2.weight, self.norm2.bias, mlp.fc1.weight, mlp.fc1.bias,
                dw.weight, dw.bias, mlp.fc2.weight, mlp.fc2.bias,
                attn.num_heads, (c // attn.num_heads) ** -0.5, h, w, self.norm2.eps,
            )
            return out.reshape(b, h, w, c)
        x = x + self.drop_path1(self.attn(self.norm1(x)), masks[0])
        return x + self.drop_path2(self.mlp(self.norm2(x)), masks[1])


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
    ``block1.0.attn.kv``, ``norm1``). Stochastic-depth rates rise linearly
    over all blocks from 0 to ``spec.drop_path_rate`` (reference
    mix_transformers.py:306-308). ``remat`` recomputes each block in the
    backward pass instead of keeping its activations (JAX's ``nn.remat``):
    the same state dict and numbers, less memory."""

    def __init__(
        self, spec: BackboneConfig = BackboneConfig(), use_kernels: bool = False,
        fuse_ffn: bool = False, fuse_block: bool = False, remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        total = sum(spec.depths)
        dpr = [spec.drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        in_ch, cur = 3, 0
        for s in range(4):
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                in_ch, spec.dims[s], 7 if s == 0 else 3, 4 if s == 0 else 2, spec.ln_eps,
            ))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                Block(
                    spec.dims[s], spec.num_heads[s], spec.sr_ratios[s],
                    spec.mlp_ratio, spec.qkv_bias, spec.ln_eps, use_kernels, fuse_ffn,
                    fuse_block, dpr[cur + i],
                )
                for i in range(spec.depths[s])
            ))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(spec.dims[s], eps=spec.ln_eps))
            in_ch = spec.dims[s]
            cur += spec.depths[s]

    def forward(self, x, generator: torch.Generator | None = None,
                rows: tuple[int, int] | None = None):
        """``generator`` draws the stochastic-depth masks in training (None:
        the global generator); ``rows`` places ``x`` in a data-parallel
        global batch (``DropPath.sample``)."""
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                masks = blk.drop_masks(x, generator, rows)
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(blk, x, masks, use_reentrant=False)
                else:
                    x = blk(x, masks)
            x = getattr(self, f"norm{s}")(x)
            outs.append(x)
        return tuple(outs)
