"""Dense decode heads (SegFormer-MLP decoder pyramid) and the low-level
encoder, in PyTorch.

Port of perspectivefields_tpu/models/heads.py (decode_head.py,
gravity_head.py:139-176): per-scale linear embed -> 3x3 conv -> top-down
FeatureFusion chain -> conv over concat(up2x(_c1), low-level features) -> 2x
upsample -> 3x3 conv -> 1x1 prediction, with the JAX package's three exact
rewrites of that dataflow, on by default as there:

* ``fuse_embed``: the linear embed and its 3x3 conv as one 3x3 conv whose
  kernel is their product, plus the embed bias pushed through the conv on a
  ones map (the zero padding drops taps at the borders);
* ``fuse_conv0``: fusion1's 2x upsample composed into conv0's ``_c1`` rows:
  four per-phase 3x3 convs at the coarse grid, then depth-to-space;
* ``fuse_tail``: the tail's upsample and conv1 as four phase convs at the
  coarse grid, ReLU and the 1x1 per phase, then depth-to-space.

The two phase forms recompute their 2-px output frame (where the bilinear
edge clamp meets the conv's zero padding) with the plain path on 3-px slabs.
Every mode has the same state dict. Channels-last tensors in and out.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import resize_bilinear
from .common import conv_nhwc


def _up2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, 2 * x.shape[-3], 2 * x.shape[-2])


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm: y = (x - mean) / sqrt(var + eps) * weight + bias
    with stored statistics (reference perspectivefields.py:70-83). The four
    tensors are parameters, as in JAX's FrozenBatchNorm, whose trainer's
    AdamW updates them like every other parameter; the state-dict names
    are the reference's."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return x * inv.to(x.dtype) + (self.bias - self.running_mean * inv).to(x.dtype)


class LowLevelEncoder(nn.Module):
    """7x7/s2 conv (no bias) + frozen BN + ReLU -> stride-2 features."""

    def __init__(self, feat_dim: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, feat_dim, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(feat_dim)

    def forward(self, x):
        return F.relu(self.bn1(conv_nhwc(self.conv1, x)))


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, plus a skip that carries relu(x)
    (the reference's in-place ReLU, decode_head.py:224-256)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        skip = F.relu(x)
        out = F.relu(conv_nhwc(self.conv1, skip))
        return conv_nhwc(self.conv2, out) + skip


class FeatureFusionBlock(nn.Module):
    """x (+ RCU(lateral)) -> RCU -> 2x bilinear upsample
    (decode_head.py:259-288). Without a lateral input there is no
    ``resConfUnit1``; ``upsample=False`` returns the RCU output, for a
    caller that composes the upsample into its next conv."""

    def __init__(self, features: int, has_lateral: bool, upsample: bool = True):
        super().__init__()
        self.upsample = upsample
        if has_lateral:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x, lateral=None):
        if lateral is not None:
            x = x + self.resConfUnit1(lateral)
        x = self.resConfUnit2(x)
        return _up2x(x) if self.upsample else x


class _Linear(nn.Module):
    """The reference's MLP wrapper: torch name ``linear_cX.proj``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, out_dim)

    def forward(self, x):
        return self.proj(x)


class _ConvModule(nn.Module):
    """The reference's ConvModule wrapper: torch name ``conv_fuse_convX.conv``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1)

    def forward(self, x):
        return conv_nhwc(self.conv, x)


# Per-dimension phase weights of the 2x bilinear upsample (align_corners=
# False): row = conv tap in (-1, 0, 1), column = input offset in (-1, 0, 1).
# Output pixel 2i + d + tap is a two-tap blend of input pixels; collecting
# the terms per input offset gives these matrices for phase d = 0 and 1.
_W_PHASE0 = ((0.75, 0.25, 0.0), (0.25, 0.75, 0.0), (0.0, 0.75, 0.25))
_W_PHASE1 = ((0.25, 0.75, 0.0), (0.0, 0.75, 0.25), (0.0, 0.25, 0.75))


@functools.lru_cache(maxsize=None)
def _phase_matrices(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """_W_PHASE0/1 as f32 tensors on ``device``, made once: a copy from host
    lists inside the forward would wait for the device each call. Made
    outside inference mode even when first asked for inside it, so a later
    training forward can save them for its backward."""
    with torch.inference_mode(False):
        return tuple(
            torch.tensor(m, dtype=torch.float32, device=device) for m in (_W_PHASE0, _W_PHASE1)
        )


def phase_kernels(k: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv kernel (O, I, 3, 3) applied after a 2x bilinear upsample,
    as four 3x3 kernels at the coarse grid stacked on the output channels:
    (4O, I, 3, 3), phase p = 2 di + dj first. Composed in f32."""
    w = _phase_matrices(k.device)
    kf = k.float()
    return torch.cat(
        [torch.einsum("pa,qb,oipq->oiab", wv, wh, kf) for wv in w for wh in w], dim=0
    )


def depth_to_space(z: torch.Tensor, c: int) -> torch.Tensor:
    """(B, h, w, 4c) with phase p = 2 di + dj on the channels -> (B, 2h, 2w,
    c) with that phase at pixel (2i + di, 2j + dj); a fresh tensor."""
    b, h, w, _ = z.shape
    return z.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)


def paste_frame(y: torch.Tensor, x: torch.Tensor, plain) -> torch.Tensor:
    """Overwrite the 2-px frame of ``y`` = f(x) at twice x's resolution with
    ``plain`` (f's plain path) on 3-px slabs of x: full-width rows keep the
    exact horizontal clamp, full-height columns the vertical one. In place
    on ``y``, a fresh tensor; inference only."""
    y[:, :2] = plain(x[:, :3])[:, :2]
    y[:, -2:] = plain(x[:, -3:])[:, -2:]
    y[:, :, :2] = plain(x[:, :, :3])[:, :, :2]
    y[:, :, -2:] = plain(x[:, :, -3:])[:, :, -2:]
    return y


class SegFormerDecoder(nn.Module):
    """Decoder shared by the gravity and latitude heads; ``field`` names the
    prediction conv (``linear_pred_gravity`` / ``linear_pred_latitude``).
    ``fuse_embed``, ``fuse_conv0`` and ``fuse_tail`` pick JAX's exact
    rewrites (module docstring); they may be changed on a built module."""

    def __init__(
        self, field: str, out_channels: int, in_dims, ll_dim: int = 64,
        embed_dim: int = 768, fusion_dim: int = 256, fuse_embed: bool = True,
        fuse_conv0: bool = True, fuse_tail: bool = True,
    ):
        super().__init__()
        self.field = field
        self.fusion_dim = fusion_dim
        for i, d in enumerate(in_dims, start=1):
            setattr(self, f"linear_c{i}", _Linear(d, embed_dim))
            setattr(self, f"linear_c{i}_proc", nn.Conv2d(embed_dim, fusion_dim, 3, padding=1))
        self.fusion4 = FeatureFusionBlock(fusion_dim, has_lateral=False)
        self.fusion3 = FeatureFusionBlock(fusion_dim, has_lateral=True)
        self.fusion2 = FeatureFusionBlock(fusion_dim, has_lateral=True)
        self.fusion1 = FeatureFusionBlock(fusion_dim, has_lateral=True)
        self.conv_fuse_conv0 = _ConvModule(fusion_dim + ll_dim, 64)
        self.conv_fuse_conv1 = _ConvModule(64, 32)
        setattr(self, f"linear_pred_{field}", nn.Conv2d(32, out_channels, 1))
        self.fuse_embed, self.fuse_conv0, self.fuse_tail = fuse_embed, fuse_conv0, fuse_tail

    @property
    def fuse_conv0(self) -> bool:
        return not self.fusion1.upsample

    @fuse_conv0.setter
    def fuse_conv0(self, on: bool) -> None:
        self.fusion1.upsample = not on  # fuse_conv0 takes fusion1's upsample

    @property
    def pred(self) -> nn.Conv2d:
        return getattr(self, f"linear_pred_{self.field}")

    # ---------------------------------------------------------------- embed

    def _embed_proc(self, c, i: int):
        emb, proc = getattr(self, f"linear_c{i}").proj, getattr(self, f"linear_c{i}_proc")
        if not self.fuse_embed:
            return conv_nhwc(proc, emb(c))
        cdt = proc.weight.dtype
        # compose in f32, cast once
        k = torch.einsum("ec,feij->fcij", emb.weight.float(), proc.weight.float()).to(cdt)
        y = F.conv2d(c.to(cdt).permute(0, 3, 1, 2), k, padding=1)
        # the embed bias reaches every tap that lands inside the zero-padded
        # embedded map: a 3x3 conv of a ones map
        kb = torch.einsum("e,feij->fij", emb.bias.float(), proc.weight.float()).to(cdt)
        ones = torch.ones((1, 1, c.shape[1], c.shape[2]), dtype=cdt, device=c.device)
        bias_map = F.conv2d(ones, kb[:, None], padding=1)
        return (y + bias_map + proc.bias.to(cdt)[:, None, None]).permute(0, 2, 3, 1)

    # ---------------------------------------------------------------- conv0

    def _conv(self, x, k):
        return F.conv2d(x.permute(0, 3, 1, 2), k, padding=1).permute(0, 2, 3, 1)

    def _plain_conv0_c1(self, a, k_c1):
        """conv3x3(upsample2x(a), k_c1): the _c1 rows of conv0, no bias."""
        return self._conv(_up2x(a), k_c1)

    def _fused_conv0_c1(self, a, k_c1):
        """The same at a's own grid: four phase convs, depth-to-space, the
        frame pasted from the plain path."""
        kp = phase_kernels(k_c1).to(k_c1.dtype)
        y = depth_to_space(self._conv(a, kp), k_c1.shape[0])
        return paste_frame(y, a, lambda s: self._plain_conv0_c1(s, k_c1))

    # ----------------------------------------------------------------- tail

    def _plain_tail(self, x):
        """2x upsample -> conv1 + ReLU -> 1x1 prediction."""
        y = F.relu(self.conv_fuse_conv1(_up2x(x)))
        return conv_nhwc(self.pred, y)

    def _fused_tail(self, x):
        """upsample + conv1 as four phase convs at x's grid (out 4 x 32),
        bias and ReLU, the 1x1 per phase, depth-to-space, the frame pasted
        from the plain path."""
        conv1 = self.conv_fuse_conv1.conv
        cdt = conv1.weight.dtype
        kp = phase_kernels(conv1.weight).to(cdt)
        z = F.relu(self._conv(x, kp) + conv1.bias.repeat(4))
        b, h, w, _ = z.shape
        c1 = conv1.weight.shape[0]
        wp = self.pred.weight[:, :, 0, 0]
        y4 = z.reshape(b, h, w, 4, c1) @ wp.t() + self.pred.bias
        y = depth_to_space(y4.reshape(b, h, w, -1), wp.shape[0])
        return paste_frame(y, x, self._plain_tail)

    def pyramid(self, hl_features):
        """The embeds and the top-down FeatureFusion chain: fusion1's output,
        2x upsampled unless ``fuse_conv0`` composes that upsample into conv0
        (the decoder tail's input ``a``)."""
        c1, c2, c3, c4 = hl_features
        x = self.fusion4(self._embed_proc(c4, 4))
        x = self.fusion3(x, self._embed_proc(c3, 3))
        x = self.fusion2(x, self._embed_proc(c2, 2))
        return self.fusion1(x, self._embed_proc(c1, 1))

    def back_end(self, x, ll_features):
        """conv0 over concat(fusion1's output, ll) + ReLU, then the tail:
        the function of the decoder-tail kernel. ``x`` is ``pyramid``'s
        output in the current mode."""
        # two split convs summed, then the bias (JAX's order); with
        # fuse_conv0 the _c1 rows run at the coarse grid
        conv0 = self.conv_fuse_conv0.conv
        k_c1, k_ll = conv0.weight[:, : self.fusion_dim], conv0.weight[:, self.fusion_dim :]
        x_c1 = self._fused_conv0_c1(x, k_c1) if self.fuse_conv0 else self._conv(x, k_c1)
        x = F.relu(x_c1 + self._conv(ll_features, k_ll) + conv0.bias)
        return self._fused_tail(x) if self.fuse_tail else self._plain_tail(x)

    def forward(self, hl_features, ll_features):
        return self.back_end(self.pyramid(hl_features), ll_features)
