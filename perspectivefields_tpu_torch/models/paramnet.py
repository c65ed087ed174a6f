"""ParamNet: dense field -> global camera parameters, in PyTorch.

Port of perspectivefields_tpu/models/paramnet.py (reference
param_network.py:11-231), both variants:

* ``"ParamNet"``: ConvNeXt(num_classes=5) over the full-resolution
  concat(gravity, latitude) field; roll/pitch/vfov are the outputs scaled by
  90, and ``rel_focal = 1/2/tan(x[:, 2])`` keeps the reference's quirk (tan
  of the raw output, param_network.py:66);
* ``"ParamNetConvNextRegress"``: the field nearest-downsampled to
  ``input_size``, ConvNeXt(len(predict_params)), each output times its
  ``PARAM_FACTORS`` scale.

Missing parameters are backfilled as in JAX: rel_cx = rel_cy = 0,
general_vfov = vfov, rel_focal from the closed-form general_vfov_to_focal.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import PARAM_FACTORS, ParamNetConfig
from ..ops.geometry import general_vfov_to_focal
from ..ops.image import resize_nearest
from .convnext import ConvNeXt


class ParamNetHead(nn.Module):
    """Camera-parameter regressor over predicted fields (NHWC)."""

    def __init__(
        self, cfg: ParamNetConfig, recover_pp: bool = False, fused_blocks: bool = False,
    ):
        super().__init__()
        if cfg.name not in ("ParamNet", "ParamNetConvNextRegress"):
            raise ValueError(f"unknown paramnet: {cfg.name}")
        self.cfg = cfg
        self.recover_pp = recover_pp
        self.backbone = ConvNeXt(num_classes=cfg.num_outputs, fused_blocks=fused_blocks)

    def forward(self, pred_gravity, pred_latitude) -> dict[str, torch.Tensor]:
        """pred_gravity (B, H, W, 2), pred_latitude (B, H, W, 1) -> dict of
        (B,) parameters, always with pred_general_vfov / pred_rel_cx /
        pred_rel_cy / pred_rel_focal (the backfill of
        perspectivefields.py:260-271)."""
        cfg = self.cfg
        field = torch.cat([pred_gravity, pred_latitude], dim=-1)
        if cfg.name == "ParamNetConvNextRegress":
            x = self.backbone(resize_nearest(field, cfg.input_size, cfg.input_size))
            param = {f"pred_{key}": x[:, i] * PARAM_FACTORS[key]
                     for i, key in enumerate(cfg.predict_params)}
        elif self.recover_pp:
            x = self.backbone(field)
            focal = x[:, 2]
            gvfov = torch.rad2deg(2.0 * torch.atan(1.0 / (2.0 * focal)))
            param = {
                "pred_roll": x[:, 0] * 90.0,
                "pred_pitch": x[:, 1] * 90.0,
                "pred_rel_focal": focal,
                "pred_rel_cx": x[:, 3],
                "pred_rel_cy": x[:, 4],
                "pred_rel_pp": x[:, 3:5],
                "pred_general_vfov": gvfov,
                "pred_vfov": gvfov,
            }
        else:
            x = self.backbone(field)
            param = {
                "pred_roll": x[:, 0] * 90.0,
                "pred_pitch": x[:, 1] * 90.0,
                "pred_vfov": x[:, 2] * 90.0,
                "pred_rel_focal": 1.0 / 2.0 / torch.tan(x[:, 2]),
            }
        if "pred_rel_cx" not in param:
            zeros = torch.zeros_like(next(iter(param.values())))
            param["pred_rel_cx"] = param["pred_rel_cy"] = zeros
        if "pred_general_vfov" not in param:
            param["pred_general_vfov"] = param["pred_vfov"]
        if "pred_rel_focal" not in param:
            param["pred_rel_focal"] = general_vfov_to_focal(
                param["pred_rel_cx"], param["pred_rel_cy"], 1.0, param["pred_general_vfov"],
                degree=True,
            )
        return param
