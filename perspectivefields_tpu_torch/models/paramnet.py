"""ParamNet: dense field -> global camera parameters, in PyTorch.

Port of perspectivefields_tpu/models/paramnet.py, ``"ParamNet"`` branch
(reference param_network.py:34-100): ConvNeXt(num_classes=5) over the
full-resolution concat(gravity, latitude) field; roll/pitch/vfov are the
outputs scaled by 90, and ``rel_focal = 1/2/tan(x[:, 2])`` keeps the
reference's quirk (tan of the raw output, param_network.py:66).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ParamNetConfig

from .convnext import ConvNeXt


class ParamNetHead(nn.Module):
    """Camera-parameter regressor over predicted fields (NHWC)."""

    def __init__(
        self, cfg: ParamNetConfig, recover_pp: bool = False, fused_blocks: bool = False,
    ):
        super().__init__()
        if cfg.name != "ParamNet":
            raise NotImplementedError(
                f"ParamNet variant {cfg.name!r} is not ported yet "
                "(ROADMAP A5: ParamNetConvNextRegress, resize_nearest, "
                "general_vfov_to_focal)"
            )
        self.recover_pp = recover_pp
        self.backbone = ConvNeXt(num_classes=5, fused_blocks=fused_blocks)

    def forward(self, pred_gravity, pred_latitude) -> dict[str, torch.Tensor]:
        """pred_gravity (B, H, W, 2), pred_latitude (B, H, W, 1) -> dict of
        (B,) parameters, always with pred_general_vfov / pred_rel_cx /
        pred_rel_cy (the backfill of perspectivefields.py:260-271)."""
        x = self.backbone(torch.cat([pred_gravity, pred_latitude], dim=-1))
        if self.recover_pp:
            focal = x[:, 2]
            gvfov = torch.rad2deg(2.0 * torch.atan(1.0 / (2.0 * focal)))
            return {
                "pred_roll": x[:, 0] * 90.0,
                "pred_pitch": x[:, 1] * 90.0,
                "pred_rel_focal": focal,
                "pred_rel_cx": x[:, 3],
                "pred_rel_cy": x[:, 4],
                "pred_rel_pp": x[:, 3:5],
                "pred_general_vfov": gvfov,
                "pred_vfov": gvfov,
            }
        vfov = x[:, 2] * 90.0
        zeros = torch.zeros_like(vfov)
        return {
            "pred_roll": x[:, 0] * 90.0,
            "pred_pitch": x[:, 1] * 90.0,
            "pred_vfov": vfov,
            "pred_rel_focal": 1.0 / 2.0 / torch.tan(x[:, 2]),
            "pred_rel_cx": zeros,
            "pred_rel_cy": zeros,
            "pred_general_vfov": vfov,
        }
