"""Reference-style YAML config compatibility.

Port of perspectivefields_tpu/config_yaml.py onto the port's own
``config.py`` and ``models.mit.mit_spec``. Users of the reference carry
yacs-style YAML files (reference: perspective2d/config/*.yaml, defaults at
config/config.py:4-137). This module maps that schema onto the frozen
dataclasses so existing configs keep working:

    cfg = load_reference_yaml("my_model.yaml")
    model = PerspectiveFields(version="custom", config=cfg)

``yaml`` is imported inside ``load_reference_yaml`` only.

Only the knobs the reference actually reads are honored (the FPN_* subtree is
dead config, flagged "not used" at config/config.py:72).
"""

from __future__ import annotations

from typing import Optional

from .config import (
    GravityHeadConfig,
    LatitudeHeadConfig,
    ModelConfig,
    ParamNetConfig,
)

_DEFAULTS = {
    "INPUT": {"FORMAT": "BGR"},
    "DATALOADER": {"RESIZE": [320, 320]},
    "MODEL": {
        "GRAVITY_ON": False,
        "LATITUDE_ON": False,
        "RECOVER_RPF": False,
        "RECOVER_PP": False,
        "BACKBONE": {"NAME": "mitb3"},
        "GRAVITY_DECODER": {
            "LOSS_TYPE": "classification",
            "NUM_CLASSES": 73,
            "IGNORE_VALUE": 72,
            "LOSS_WEIGHT": 1.0,
        },
        "LATITUDE_DECODER": {
            "LOSS_TYPE": "regression",
            "NUM_CLASSES": 1,
            "IGNORE_VALUE": -1,
            "LOSS_WEIGHT": 1.0,
        },
        "PARAM_DECODER": {
            "NAME": "ParamNet",
            "LOSS_TYPE": "regression",
            "LOSS_WEIGHT": 1.0,
            "PREDICT_PARAMS": ["roll", "pitch", "rel_focal", "rel_cx", "rel_cy"],
            "INPUT_SIZE": 320,
        },
        "PIXEL_MEAN": [103.53, 116.28, 123.675],
        "PIXEL_STD": [1.0, 1.0, 1.0],
    },
}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def from_reference_dict(raw: dict, version: str = "custom") -> ModelConfig:
    """Build a ModelConfig from a yacs-style nested dict (the reference's
    defaults merged under it)."""
    cfg = _merge(_DEFAULTS, raw)
    m = cfg["MODEL"]

    gravity: Optional[GravityHeadConfig] = None
    if m.get("GRAVITY_ON"):
        g = m["GRAVITY_DECODER"]
        gravity = GravityHeadConfig(
            loss_type=g["LOSS_TYPE"],
            num_classes=int(g["NUM_CLASSES"]),
            ignore_value=int(g["IGNORE_VALUE"]),
            loss_weight=float(g["LOSS_WEIGHT"]),
        )
    latitude: Optional[LatitudeHeadConfig] = None
    if m.get("LATITUDE_ON"):
        l = m["LATITUDE_DECODER"]
        latitude = LatitudeHeadConfig(
            loss_type=l["LOSS_TYPE"],
            num_classes=int(l["NUM_CLASSES"]),
            ignore_value=int(l["IGNORE_VALUE"]),
            loss_weight=float(l["LOSS_WEIGHT"]),
        )
    param: Optional[ParamNetConfig] = None
    if m.get("RECOVER_RPF") or m.get("RECOVER_PP"):
        p = m["PARAM_DECODER"]
        param = ParamNetConfig(
            name=p["NAME"],
            predict_params=tuple(p["PREDICT_PARAMS"]),
            input_size=int(p["INPUT_SIZE"]),
            loss_weight=float(p["LOSS_WEIGHT"]),
            loss_type=p["LOSS_TYPE"],
        )

    from .models.mit import mit_spec

    return ModelConfig(
        version=version,
        backbone=mit_spec(m["BACKBONE"]["NAME"]),
        gravity=gravity,
        latitude=latitude,
        param=param,
        recover_rpf=bool(m.get("RECOVER_RPF")),
        recover_pp=bool(m.get("RECOVER_PP")),
        input_format=cfg["INPUT"]["FORMAT"],
        resize=tuple(cfg["DATALOADER"]["RESIZE"]),
        pixel_mean=tuple(m["PIXEL_MEAN"]),
        pixel_std=tuple(m["PIXEL_STD"]),
    )


def load_reference_yaml(path: str, version: str = "custom") -> ModelConfig:
    """Load a reference-format YAML config file."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return from_reference_dict(raw, version)
