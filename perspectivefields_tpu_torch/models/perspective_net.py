"""Top-level PersNet: backbone + low-level encoder + decode heads + ParamNet.

Port of perspectivefields_tpu/models/perspective_net.py (reference
perspectivefields.py:223-272): a normalized (B, H, W, 3) batch at network
resolution -> raw network-resolution fields (+ camera parameters).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig

from .heads import LowLevelEncoder, SegFormerDecoder
from .mit import MixViT
from .paramnet import ParamNetHead

_EPS = 1e-12


class PersNet(nn.Module):
    """Attribute names follow the reference state dict: ``backbone``,
    ``ll_enc``, ``persformer_heads.{gravity,latitude}_head``, ``param_net``.

    ``use_kernels`` gates the attention kernels; ``fuse_ffn``,
    ``fuse_convnext`` and ``fuse_block`` run every MixFFN, every ParamNet
    ConvNeXt block and every eligible MiT block fused, as the JAX PersNet's
    flags of the same names do. The kernels are inference-only; train with
    all four off, as JAX's trainer does. ``remat`` recomputes each backbone
    block in the backward pass (JAX's ``remat``)."""

    def __init__(
        self, cfg: ModelConfig, use_kernels: bool = False, fuse_ffn: bool = False,
        fuse_convnext: bool = False, fuse_block: bool = False, remat: bool = False,
    ):
        super().__init__()
        self.cfg = cfg
        self.backbone = MixViT(cfg.backbone, use_kernels, fuse_ffn, fuse_block, remat)
        self.ll_enc = LowLevelEncoder()
        heads = {}
        for field, hc in (("gravity", cfg.gravity), ("latitude", cfg.latitude)):
            if hc is not None:
                heads[f"{field}_head"] = SegFormerDecoder(
                    field, hc.out_channels, cfg.backbone.dims,
                    embed_dim=hc.embed_dim, fusion_dim=hc.fusion_dim,
                )
        self.persformer_heads = nn.ModuleDict(heads)
        self.param_net = (
            ParamNetHead(cfg.param, cfg.recover_pp, fuse_convnext) if cfg.param_on else None
        )

    def forward(
        self, images: torch.Tensor, generator: torch.Generator | None = None
    ) -> dict[str, torch.Tensor]:
        """images: normalized (B, H, W, 3) in the model's dtype. Returns
        channels-last pred_gravity (B, H, W, 2), pred_latitude (B, H, W, 1)
        and, with a ParamNet, (B,) camera parameters. In training mode a
        regression latitude head also gives ``latitude_raw``, its pre-clamp
        output, which the overflow penalty reads; ``generator`` draws the
        stochastic-depth masks (None: the global generator)."""
        cfg = self.cfg
        hl = self.backbone(images, generator)
        ll = self.ll_enc(images)
        out: dict[str, torch.Tensor] = {}
        if cfg.gravity is not None:
            g = self.persformer_heads["gravity_head"](hl, ll)
            if cfg.gravity.loss_type == "regression":
                # F.normalize over channels (gravity_head.py:180-181)
                g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True).clamp_min(_EPS)
            out["pred_gravity"] = g
        if cfg.latitude is not None:
            lat = self.persformer_heads["latitude_head"](hl, ll)
            if cfg.latitude.loss_type == "regression":
                # the reference's hard clamp (gradient 0 outside [-1, 1]); a
                # saturated head trains through the overflow penalty on the
                # raw value (train.losses.latitude_regression_loss)
                if self.training:
                    out["latitude_raw"] = lat
                lat = lat.clamp(-1.0, 1.0)
            out["pred_latitude"] = lat
        if self.param_net is not None:
            out.update(self.param_net(out["pred_gravity"], out["pred_latitude"]))
        return out
