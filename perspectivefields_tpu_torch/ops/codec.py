"""Field <-> classification-bin codecs, on channels-last tensors.

Port of perspectivefields_tpu/ops/codec.py (reference
perspective2d/utils/utils.py:94-162):

* up-vector fields are angle bins over [0, 360) with ``num_bin - 1`` real
  bins; the last bin marks invalid (zero-vector) pixels and decodes to the
  zero vector;
* latitude maps in degrees [-90, 90] are bucketized into ``num_classes``
  uniform bins; decoding returns the bin centres.
"""

from __future__ import annotations

import math

import torch


def encode_bin(vector_field: torch.Tensor, num_bin: int) -> torch.Tensor:
    """(..., 2) field (cos, sin) -> (...) int32 angle bins; bin ``num_bin -
    1`` from rounding wraps to 0, all-zero vectors map to it."""
    angle = torch.remainder(
        torch.atan2(vector_field[..., 1], vector_field[..., 0]) / math.pi * 180.0 + 180.0,
        360.0,
    )
    angle_bin = torch.round(angle / (360.0 / (num_bin - 1))).to(torch.int32)
    angle_bin = torch.where(angle_bin == num_bin - 1, 0, angle_bin)
    invalid = (vector_field == 0).all(dim=-1)
    return torch.where(invalid, num_bin - 1, angle_bin).to(torch.int32)


def decode_bin(angle_bin: torch.Tensor, num_bin: int) -> torch.Tensor:
    """(...) integer bins -> (..., 2) float32 unit up-vectors; the invalid
    bin decodes to the zero vector."""
    angle = angle_bin.to(torch.float32) * (360.0 / (num_bin - 1)) - 180.0
    angle = angle / 180.0 * math.pi
    vec = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
    invalid = (angle_bin == num_bin - 1)[..., None]
    return torch.where(invalid, torch.zeros((), dtype=vec.dtype, device=vec.device), vec)


def _latitude_edges(num_classes: int, device) -> torch.Tensor:
    """The ``num_classes`` lower bin edges -90, -90 + s, ... (s = 180 / n),
    made from a count so that exactly ``num_classes`` come out."""
    bin_size = 180.0 / num_classes
    return -90.0 + bin_size * torch.arange(num_classes, dtype=torch.float32, device=device)


def encode_bin_latitude(latimap: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Degrees -> int32 class bins, as torch.bucketize(right=False) over the
    interior boundaries."""
    boundaries = _latitude_edges(num_classes, latimap.device)[1:]
    return torch.bucketize(latimap.to(torch.float32), boundaries, right=False).to(torch.int32)


def decode_bin_latitude(binmap: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Class bins -> bin-centre degrees (float32)."""
    centres = _latitude_edges(num_classes, binmap.device) + 90.0 / num_classes
    return centres[binmap.long()]
