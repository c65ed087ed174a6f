"""Prediction postprocess: network-resolution fields -> original-size fields.

Port of perspectivefields_tpu/ops/postprocess.py on channels-last batches
(B, H, W, C) instead of a vmapped single image:

* ``pf_postprocess``: torch-bilinear resize back to the original size;
* ``postprocess_gravity``: (classification: argmax, then decode the angle
  bin) scale the vectors by (W/w, H/h) *before* the resize, then
  renormalize (reference gravity_head.py:237-261);
* ``postprocess_latitude``: regression: resize, then asin -> degrees;
  classification: argmax, decode the bin centre, then resize
  (latitude_head.py:195-219).
"""

from __future__ import annotations

import torch

from .codec import decode_bin, decode_bin_latitude
from .image import resize_bilinear

_EPS = 1e-12


def pf_postprocess(result: torch.Tensor, img_size, output_height: int, output_width: int):
    """Crop (..., H, W, C) predictions to ``img_size`` and resize them to
    (output_height, output_width)."""
    result = result[..., : img_size[0], : img_size[1], :]
    return resize_bilinear(result, output_height, output_width)


def postprocess_gravity(
    pred: torch.Tensor, image_size, out_h: int, out_w: int,
    loss_type: str = "regression", num_classes: int = 73,
):
    """(B, h, w, 2) up-vector field or (B, h, w, num_classes) logits ->
    (B, out_h, out_w, 2) unit vectors."""
    vec = decode_bin(pred.argmax(dim=-1), num_classes) if loss_type == "classification" else pred
    scale = torch.tensor(
        [out_w / image_size[1], out_h / image_size[0]], dtype=vec.dtype,
        device=vec.device,
    )
    vec = pf_postprocess(vec * scale, image_size, out_h, out_w)
    norm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True).clamp_min(_EPS)
    return vec / norm


def postprocess_latitude(
    pred: torch.Tensor, image_size, out_h: int, out_w: int,
    loss_type: str = "regression", num_classes: int = 180,
):
    """(B, h, w, 1) sin-latitude or (B, h, w, num_classes) logits ->
    (B, out_h, out_w) degrees."""
    if loss_type == "regression":
        lat = pf_postprocess(pred, image_size, out_h, out_w)[..., 0]
        return torch.rad2deg(torch.asin(lat.clamp(-1.0, 1.0)))
    lat = decode_bin_latitude(pred.argmax(dim=-1), num_classes)[..., None]
    return pf_postprocess(lat, image_size, out_h, out_w)[..., 0]
