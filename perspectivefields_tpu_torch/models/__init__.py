"""PyTorch modules of the port (channels-last at their public forwards): MiT
(SegFormer) backbones, ConvNeXt, the decode heads, ParamNet and the
assembled PersNet."""

from .convnext import ConvNeXt
from .heads import LowLevelEncoder, SegFormerDecoder
from .mit import MixViT, mit_spec
from .paramnet import ParamNetHead
from .perspective_net import PersNet

__all__ = [
    "MixViT",
    "mit_spec",
    "ConvNeXt",
    "SegFormerDecoder",
    "LowLevelEncoder",
    "ParamNetHead",
    "PersNet",
]
