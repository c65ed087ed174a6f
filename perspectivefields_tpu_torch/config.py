"""Configuration of the port: frozen dataclasses + the 5-version model zoo.

The port's own copy of perspectivefields_tpu/config.py (the port imports
nothing of the JAX package); tests/test_torch_api.py holds the two equal
field by field. The reference drives model construction through a yacs
CfgNode tree merged with per-version YAML (reference:
perspective2d/config/config.py:4-137 and perspectivefields.py:86-131); a
typed, frozen dataclass per zoo version covers the knobs it reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """MiT (SegFormer encoder) spec. Defaults = mit_b3
    (reference: modeling/backbone/mix_transformers.py:511-535)."""

    name: str = "mitb3"
    dims: Tuple[int, ...] = (64, 128, 320, 512)
    depths: Tuple[int, ...] = (3, 4, 18, 3)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratio: int = 4
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    drop_path_rate: float = 0.1  # train-time stochastic depth


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """Dense decode-head spec (gravity or latitude).

    loss_type 'regression' => gravity: 2ch unit vectors, latitude: 1ch
    sin(lat); 'classification' => gravity: 73 bins (last invalid), latitude:
    180 bins. Reference: config/config.py:37-48 + per-version yaml.
    """

    loss_type: str = "regression"
    num_classes: int = 1
    loss_weight: float = 1.0
    ignore_value: int = -1
    embed_dim: int = 768
    fusion_dim: int = 256

    @property
    def out_channels(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GravityHeadConfig(HeadConfig):
    num_classes: int = 73
    ignore_value: int = 72

    @property
    def out_channels(self) -> int:
        return 2 if self.loss_type == "regression" else self.num_classes


@dataclasses.dataclass(frozen=True)
class LatitudeHeadConfig(HeadConfig):
    num_classes: int = 1

    @property
    def out_channels(self) -> int:
        return 1 if self.loss_type == "regression" else self.num_classes


@dataclasses.dataclass(frozen=True)
class ParamNetConfig:
    """Field -> camera-parameter regressor spec.

    name 'ParamNet': ConvNeXt-tiny trunk on the full-res 3ch field, 5 outputs
    (reference: param_network.py:34-100). name 'ParamNetConvNextRegress':
    field nearest-downsampled to input_size first, len(predict_params)
    outputs (param_network.py:171-231).
    """

    name: str = "ParamNetConvNextRegress"
    predict_params: Tuple[str, ...] = ("roll", "pitch", "vfov")
    input_size: int = 64
    loss_weight: float = 1.0
    loss_type: str = "regression"

    @property
    def num_outputs(self) -> int:
        if self.name == "ParamNet":
            return 5
        return len(self.predict_params)


# Per-parameter output scale factors (reference: param_network.py:183-191).
PARAM_FACTORS = {
    "roll": 90.0,
    "pitch": 90.0,
    "vfov": 90.0,
    "rel_focal": 1.0,
    "rel_cx": 1.0,
    "rel_cy": 1.0,
    "general_vfov": 90.0,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full model spec for one zoo version."""

    version: str = "custom"
    backbone: BackboneConfig = BackboneConfig()
    gravity: Optional[GravityHeadConfig] = GravityHeadConfig()
    latitude: Optional[LatitudeHeadConfig] = LatitudeHeadConfig()
    param: Optional[ParamNetConfig] = None
    recover_pp: bool = False
    recover_rpf: bool = False
    # preprocessing (reference: config/config.py:12,20,77-78)
    input_format: str = "BGR"
    resize: Tuple[int, int] = (320, 320)  # (H, W)
    pixel_mean: Tuple[float, ...] = (103.53, 116.28, 123.675)  # BGR Caffe means
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0)

    @property
    def param_on(self) -> bool:
        return self.param is not None and (self.recover_rpf or self.recover_pp)


# ---------------------------------------------------------------------------
# Model zoo: the 5 released versions (reference: perspectivefields.py:86-118
# + perspective2d/config/*.yaml). Weight URLs kept for the checkpoint
# converter of the JAX package.
# ---------------------------------------------------------------------------

_HF = "https://huggingface.co/spaces/jinlinyi/PerspectiveFields/resolve/main/models"

model_zoo = {
    "PersNet-360Cities": {
        "config": ModelConfig(
            version="PersNet-360Cities",
            gravity=GravityHeadConfig(loss_type="classification", num_classes=73),
            latitude=LatitudeHeadConfig(loss_type="classification", num_classes=180),
            param=None,
        ),
        "weights_url": f"{_HF}/cvpr2023.pth",
        "description": "Trained on 360cities. Predicts perspective fields.",
    },
    "Paramnet-360Cities-edina-centered": {
        "config": ModelConfig(
            version="Paramnet-360Cities-edina-centered",
            gravity=GravityHeadConfig(loss_type="regression"),
            latitude=LatitudeHeadConfig(loss_type="regression"),
            # yaml says NAME: ParamNet (full-res field input, 5-out ConvNeXt)
            # reference: config/paramnet_360cities_edina_rpf.yaml
            param=ParamNetConfig(
                name="ParamNet", predict_params=("roll", "pitch", "vfov"), input_size=64
            ),
            recover_rpf=True,
        ),
        "weights_url": f"{_HF}/paramnet_360cities_edina_rpf.pth",
        "description": (
            "Trained on 360cities and EDINA dataset. Assumes centered principal "
            "point. Predicts roll, pitch and fov."
        ),
    },
    "Paramnet-360Cities-edina-uncentered": {
        "config": ModelConfig(
            version="Paramnet-360Cities-edina-uncentered",
            gravity=GravityHeadConfig(loss_type="regression"),
            latitude=LatitudeHeadConfig(loss_type="regression"),
            param=ParamNetConfig(
                name="ParamNetConvNextRegress",
                predict_params=("roll", "pitch", "general_vfov", "rel_cx", "rel_cy"),
                input_size=64,
            ),
            recover_rpf=True,
            recover_pp=True,
        ),
        "weights_url": f"{_HF}/paramnet_360cities_edina_rpfpp.pth",
        "description": (
            "Trained on 360cities and EDINA dataset. Predicts roll, pitch, fov "
            "and principal point."
        ),
    },
    "PersNet_Paramnet-GSV-centered": {
        "config": ModelConfig(
            version="PersNet_Paramnet-GSV-centered",
            gravity=GravityHeadConfig(loss_type="regression"),
            latitude=LatitudeHeadConfig(loss_type="regression"),
            param=ParamNetConfig(
                name="ParamNet", predict_params=("roll", "pitch", "vfov"), input_size=320
            ),
            recover_rpf=True,
        ),
        "weights_url": f"{_HF}/paramnet_gsv_rpf.pth",
        "description": (
            "Trained on GSV. Assumes centered principal point. Predicts roll, "
            "pitch and fov."
        ),
    },
    "PersNet_Paramnet-GSV-uncentered": {
        "config": ModelConfig(
            version="PersNet_Paramnet-GSV-uncentered",
            gravity=GravityHeadConfig(loss_type="regression"),
            latitude=LatitudeHeadConfig(loss_type="regression"),
            param=ParamNetConfig(
                name="ParamNetConvNextRegress",
                predict_params=("roll", "pitch", "general_vfov", "rel_cx", "rel_cy"),
                input_size=64,
                loss_weight=0.1,
            ),
            recover_rpf=True,
            recover_pp=True,
        ),
        "weights_url": f"{_HF}/paramnet_gsv_rpfpp.pth",
        "description": "Trained on GSV. Predicts roll, pitch, fov and principal point.",
    },
}
