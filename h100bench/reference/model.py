"""Plain float32 PerspectiveFields network: the benchmark's reference.

A frozen copy of the plain paths of the PyTorch port's modules (MiT-b3
encoder, the low-level encoder, the SegFormer decode heads with their plain
dataflow, ConvNeXt-T and both ParamNet variants), in plain ``torch`` ops with
no kernel, no fused rewrite and no cache. It imports nothing of the program.
Attribute names follow the released state dict, so one state dict loads into
both. Channels-last tensors, as the port's.

Every product (Linear, convolution and the two attention products) goes
through ``Rounding``: the identity for the reference itself; for the
control, the same network computed one precision step below the bfloat16
that the configurations state, as float8 training takes its products: both
operands rounded to e4m3 and the gradient that enters the product's
backward to e5m2, each with a per-tensor scale of its own; or bfloat16
round trips, the yardstick of how much a seed's weights amplify rounding at
the configurations' own precision.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _scaled(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` with a per-tensor scale that maps its
    largest magnitude to ``largest``, and back."""
    scale = largest / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


# mode: (operands in the forward pass, the gradient entering a product's backward)
_FORMATS = {
    "bf16": (_bf16, _bf16),
    "fp8": (lambda t: _scaled(t, torch.float8_e4m3fn, 448.0),
            lambda g: _scaled(g, torch.float8_e5m2, 57344.0)),
}


class _RoundOperand(torch.autograd.Function):
    """Rounds in the forward pass; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, t, fn):
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGradient(torch.autograd.Function):
    """The identity in the forward pass; rounds the gradient in the backward."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Rounding:
    """What the products compute in: None (float32), "bf16" (bfloat16, the
    precision the configurations state) or "fp8" (float8 with per-tensor
    scales: e4m3 operands, e5m2 gradients). ``rnd(t)`` rounds an operand;
    ``rnd.grad(y)`` rounds the gradient that reaches a product's output."""

    def __init__(self, mode: str | None = None):
        if mode is not None and mode not in _FORMATS:
            raise ValueError(f"unknown rounding {mode!r}")
        self.mode = mode

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode is None:
            return t
        return _RoundOperand.apply(t, _FORMATS[self.mode][0])

    def grad(self, y: torch.Tensor) -> torch.Tensor:
        if self.mode is None:
            return y
        return _RoundGradient.apply(y, _FORMATS[self.mode][1])


def _gelu(x):
    return F.gelu(x)  # the exact erf form, as the port's float32 rule


class Linear(nn.Module):
    def __init__(self, rnd: Rounding, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.rnd = rnd
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return self.rnd.grad(F.linear(self.rnd(x), self.rnd(self.weight), self.bias))


class Conv(nn.Module):
    """A 2-D convolution on channels-last tensors (weights (O, I/g, k, k))."""

    def __init__(self, rnd: Rounding, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True):
        super().__init__()
        self.rnd = rnd
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight = nn.Parameter(torch.empty(c_out, c_in // groups, k, k))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def forward(self, x):
        y = F.conv2d(self.rnd(x.permute(0, 3, 1, 2)), self.rnd(self.weight), self.bias,
                     self.stride, self.padding, 1, self.groups)
        return self.rnd.grad(y).permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, self.eps)


def up2x(x):
    """2x bilinear upsample (align_corners=False) of (B, H, W, C)."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


# ------------------------------------------------------------------- MiT-b3


class SRAttention(nn.Module):
    def __init__(self, rnd, dim, heads, sr, ln_eps):
        super().__init__()
        self.rnd, self.heads, self.sr_ratio = rnd, heads, sr
        self.q = Linear(rnd, dim, dim)
        self.kv = Linear(rnd, dim, 2 * dim)
        self.proj = Linear(rnd, dim, dim)
        if sr > 1:
            self.sr = Conv(rnd, dim, dim, sr, stride=sr)
            self.norm = LayerNorm(dim, ln_eps)

    def forward(self, x):
        b, h, w, c = x.shape
        hd = c // self.heads
        kv_in = self.norm(self.sr(x)).reshape(b, -1, c) if self.sr_ratio > 1 else x.reshape(b, -1, c)
        q = self.q(x).reshape(b, h * w, self.heads, hd)
        kv = self.kv(kv_in).reshape(b, -1, 2, self.heads, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        qk = torch.einsum("bnhd,bmhd->bhnm", self.rnd(q), self.rnd(k))
        logits = self.rnd.grad(qk) * hd**-0.5
        p = torch.softmax(logits, dim=-1)
        out = self.rnd.grad(torch.einsum("bhnm,bmhd->bnhd", self.rnd(p), self.rnd(v)))
        out = out.reshape(b, h, w, c)
        return self.proj(out)


class MixFFN(nn.Module):
    def __init__(self, rnd, dim, hidden):
        super().__init__()
        self.fc1 = Linear(rnd, dim, hidden)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = Conv(rnd, hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = Linear(rnd, hidden, dim)

    def forward(self, x):
        return self.fc2(_gelu(self.dwconv.dwconv(self.fc1(x))))


class Block(nn.Module):
    """x + drop(attn(LN(x))); x + drop(ffn(LN(x))). ``rate`` is the block's
    stochastic-depth rate; the masks are handed in by the caller."""

    def __init__(self, rnd, dim, heads, sr, mlp_ratio, ln_eps, rate):
        super().__init__()
        self.rate = rate
        self.norm1 = LayerNorm(dim, ln_eps)
        self.attn = SRAttention(rnd, dim, heads, sr, ln_eps)
        self.norm2 = LayerNorm(dim, ln_eps)
        self.mlp = MixFFN(rnd, dim, dim * mlp_ratio)

    def _drop(self, x, mask):
        if mask is None:
            return x
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, x, masks=(None, None)):
        x = x + self._drop(self.attn(self.norm1(x)), masks[0])
        return x + self._drop(self.mlp(self.norm2(x)), masks[1])


class PatchEmbed(nn.Module):
    def __init__(self, rnd, c_in, dim, k, stride, ln_eps):
        super().__init__()
        self.proj = Conv(rnd, c_in, dim, k, stride=stride, padding=k // 2)
        self.norm = LayerNorm(dim, ln_eps)

    def forward(self, x):
        return self.norm(self.proj(x))


class MixViT(nn.Module):
    def __init__(self, rnd, bb: dict):
        super().__init__()
        depths = bb["depths"]
        total = sum(depths)
        rates = [bb["drop_path_rate"] * i / max(total - 1, 1) for i in range(total)]
        c_in, cur = 3, 0
        for s in range(4):
            dim = bb["dims"][s]
            setattr(self, f"patch_embed{s + 1}", PatchEmbed(
                rnd, c_in, dim, 7 if s == 0 else 3, 4 if s == 0 else 2, bb["ln_eps"]))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                Block(rnd, dim, bb["num_heads"][s], bb["sr_ratios"][s], bb["mlp_ratio"],
                      bb["ln_eps"], rates[cur + i]) for i in range(depths[s])))
            setattr(self, f"norm{s + 1}", LayerNorm(dim, bb["ln_eps"]))
            c_in, cur = dim, cur + depths[s]

    def blocks(self):
        return [blk for s in range(1, 5) for blk in getattr(self, f"block{s}")]

    def forward(self, x, masks=None):
        """``masks``: a list of (mask1, mask2) per block in order, or None."""
        outs, i = [], 0
        for s in range(1, 5):
            x = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                x = blk(x, masks[i] if masks is not None else (None, None))
                i += 1
            x = getattr(self, f"norm{s}")(x)
            outs.append(x)
        return outs


# ---------------------------------------------------- low-level encoder, heads


class FrozenBatchNorm(nn.Module):
    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.running_mean = nn.Parameter(torch.empty(features))
        self.running_var = nn.Parameter(torch.empty(features))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        return x * inv + (self.bias - self.running_mean * inv)


class LowLevelEncoder(nn.Module):
    def __init__(self, rnd, feat=64):
        super().__init__()
        self.conv1 = Conv(rnd, 3, feat, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(feat)

    def forward(self, x):
        return F.relu(self.bn1(self.conv1(x)))


class RCU(nn.Module):
    def __init__(self, rnd, f):
        super().__init__()
        self.conv1 = Conv(rnd, f, f, 3, padding=1)
        self.conv2 = Conv(rnd, f, f, 3, padding=1)

    def forward(self, x):
        skip = F.relu(x)
        return self.conv2(F.relu(self.conv1(skip))) + skip


class Fusion(nn.Module):
    def __init__(self, rnd, f, lateral):
        super().__init__()
        if lateral:
            self.resConfUnit1 = RCU(rnd, f)
        self.resConfUnit2 = RCU(rnd, f)

    def forward(self, x, lateral=None):
        if lateral is not None:
            x = x + self.resConfUnit1(lateral)
        return up2x(self.resConfUnit2(x))


class Decoder(nn.Module):
    """The SegFormer-MLP decode head: embeds, top-down fusion, conv over
    concat(up2x(fused), low-level), then up2x -> conv -> 1x1 prediction."""

    def __init__(self, rnd, field, out_ch, in_dims, embed_dim, fusion_dim, ll_dim=64):
        super().__init__()
        self.field = field
        for i, d in enumerate(in_dims, start=1):
            lin = nn.Module()
            lin.proj = Linear(rnd, d, embed_dim)
            setattr(self, f"linear_c{i}", lin)
            setattr(self, f"linear_c{i}_proc", Conv(rnd, embed_dim, fusion_dim, 3, padding=1))
        self.fusion4 = Fusion(rnd, fusion_dim, False)
        self.fusion3 = Fusion(rnd, fusion_dim, True)
        self.fusion2 = Fusion(rnd, fusion_dim, True)
        self.fusion1 = Fusion(rnd, fusion_dim, True)
        for name, (ci, co) in (("conv_fuse_conv0", (fusion_dim + ll_dim, 64)),
                               ("conv_fuse_conv1", (64, 32))):
            mod = nn.Module()
            mod.conv = Conv(rnd, ci, co, 3, padding=1)
            setattr(self, name, mod)
        setattr(self, f"linear_pred_{field}", Conv(rnd, 32, out_ch, 1))

    def _embed(self, c, i):
        return getattr(self, f"linear_c{i}_proc")(getattr(self, f"linear_c{i}").proj(c))

    def forward(self, hl, ll):
        c1, c2, c3, c4 = hl
        x = self.fusion4(self._embed(c4, 4))
        x = self.fusion3(x, self._embed(c3, 3))
        x = self.fusion2(x, self._embed(c2, 2))
        x = self.fusion1(x, self._embed(c1, 1))
        x = F.relu(self.conv_fuse_conv0.conv(torch.cat([x, ll], dim=-1)))
        x = F.relu(self.conv_fuse_conv1.conv(up2x(x)))
        return getattr(self, f"linear_pred_{self.field}")(x)


# ------------------------------------------------------- ConvNeXt, ParamNet


class ConvNeXtBlock(nn.Module):
    def __init__(self, rnd, dim):
        super().__init__()
        self.dwconv = Conv(rnd, dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, 1e-6)
        self.pwconv1 = Linear(rnd, dim, 4 * dim)
        self.pwconv2 = Linear(rnd, 4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        y = self.pwconv2(_gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + y * self.gamma


class ConvNeXt(nn.Module):
    """ConvNeXt-T (depths 3/3/9/3, dims 96/192/384/768)."""

    def __init__(self, rnd, num_classes, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)):
        super().__init__()
        self.downsample_layers = nn.ModuleList(
            [nn.ModuleList([Conv(rnd, 3, dims[0], 4, stride=4), LayerNorm(dims[0], 1e-6)])]
            + [nn.ModuleList([LayerNorm(dims[i - 1], 1e-6), Conv(rnd, dims[i - 1], dims[i], 2, stride=2)])
               for i in range(1, 4)])
        self.stages = nn.ModuleList(
            nn.ModuleList(ConvNeXtBlock(rnd, dims[i]) for _ in range(depths[i])) for i in range(4))
        self.norm = LayerNorm(dims[-1], 1e-6)
        self.head = Linear(rnd, dims[-1], num_classes)

    def forward(self, x):
        for i in range(4):
            first, second = self.downsample_layers[i]
            x = second(first(x))
            for blk in self.stages[i]:
                x = blk(x)
        return self.head(self.norm(x.mean(dim=(1, 2))))


PARAM_FACTORS = {"roll": 90.0, "pitch": 90.0, "vfov": 90.0, "general_vfov": 90.0,
                 "rel_focal": 1.0, "rel_cx": 1.0, "rel_cy": 1.0}


def resize_nearest(x, out_h, out_w):
    """F.interpolate(mode="nearest") of (B, H, W, C)."""
    h, w = x.shape[1:3]
    ih = torch.arange(out_h, device=x.device) * h // out_h
    iw = torch.arange(out_w, device=x.device) * w // out_w
    return x.index_select(1, ih).index_select(2, iw)


class ParamNet(nn.Module):
    """``ParamNet``: ConvNeXt over the full-resolution field, 5 outputs
    (roll, pitch, vfov scaled by 90; rel_focal = 1/2/tan of the raw third
    output). ``ParamNetConvNextRegress``: the field nearest-resized to
    ``input_size``, one output per predicted parameter times its factor.
    The missing parameters are filled as the port fills them: rel_cx =
    rel_cy = 0, general_vfov = vfov."""

    def __init__(self, rnd, pcfg: dict):
        super().__init__()
        self.cfg = pcfg
        n_out = 5 if pcfg["name"] == "ParamNet" else len(pcfg["predict_params"])
        self.backbone = ConvNeXt(rnd, n_out)

    def forward(self, gravity, latitude):
        cfg = self.cfg
        field = torch.cat([gravity, latitude], dim=-1)
        if cfg["name"] == "ParamNet":
            x = self.backbone(field)
            out = {"pred_roll": x[:, 0] * 90.0, "pred_pitch": x[:, 1] * 90.0,
                   "pred_vfov": x[:, 2] * 90.0, "pred_rel_focal": 0.5 / torch.tan(x[:, 2])}
        else:
            x = self.backbone(resize_nearest(field, cfg["input_size"], cfg["input_size"]))
            out = {f"pred_{k}": x[:, i] * PARAM_FACTORS[k] for i, k in enumerate(cfg["predict_params"])}
        zeros = torch.zeros_like(out["pred_roll"])
        out.setdefault("pred_rel_cx", zeros)
        out.setdefault("pred_rel_cy", zeros)
        out.setdefault("pred_general_vfov", out["pred_vfov"])
        return out


# ----------------------------------------------------------------- the net


class PersNet(nn.Module):
    """The whole network of a configuration file's ``model`` section:
    normalized (B, H, W, 3) -> pred_gravity (unit vectors), pred_latitude
    (sin latitude, clamped; in training also ``latitude_raw``) and, with a
    ParamNet, the camera parameters."""

    def __init__(self, model_cfg: dict, rounding: str | None = None):
        super().__init__()
        rnd = Rounding(rounding)
        bb = model_cfg["backbone"]
        self.backbone = MixViT(rnd, bb)
        self.ll_enc = LowLevelEncoder(rnd)
        heads = {}
        for field, out_ch in (("gravity", 2), ("latitude", 1)):
            hc = model_cfg[field]
            if hc["loss_type"] != "regression":
                raise ValueError("the reference covers the regression heads only")
            heads[f"{field}_head"] = Decoder(rnd, field, out_ch, bb["dims"], hc["embed_dim"],
                                             hc["fusion_dim"])
        self.persformer_heads = nn.ModuleDict(heads)
        self.param_net = ParamNet(rnd, model_cfg["param"]) if model_cfg.get("param") else None

    def forward(self, x, masks=None):
        hl = self.backbone(x, masks)
        ll = self.ll_enc(x)
        g = self.persformer_heads["gravity_head"](hl, ll)
        g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True).clamp_min(1e-12)
        lat_raw = self.persformer_heads["latitude_head"](hl, ll)
        lat = lat_raw.clamp(-1.0, 1.0)
        out = {"pred_gravity": g, "pred_latitude": lat}
        if self.training:
            out["latitude_raw"] = lat_raw
        if self.param_net is not None:
            out.update(self.param_net(g, lat))
        return out


def build(model_cfg: dict, state_dict: dict, device, rounding: str | None = None) -> PersNet:
    """The reference network in float32 on ``device`` with ``state_dict``'s
    values (every name must match)."""
    with torch.device("meta"):
        net = PersNet(model_cfg, rounding)
    net = net.to_empty(device=device)
    missing = set(net.state_dict()) ^ set(state_dict)
    if missing:
        raise KeyError(f"state dict names differ from the reference's: {sorted(missing)[:5]}")
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(state_dict[name].to(device=device, dtype=torch.float32))
    return net


def fan_in(shape) -> int:
    return math.prod(shape[1:])
