"""Plain tensor functions of the port: field codecs, camera geometry, image
resampling, pano crops and postprocess (the JAX package's ``ops`` names;
``activations`` too)."""

from .codec import (
    decode_bin,
    decode_bin_latitude,
    encode_bin,
    encode_bin_latitude,
)
from .geometry import (
    abs_vvp,
    general_vfov,
    general_vfov_to_focal,
    lat_field,
    lat_field_general,
    relative_horizon_line,
    relative_vvp,
    rotation_matrix,
    up_field,
    up_field_general,
    vfov_to_focal_rel,
)
from .image import (
    make_resize_matrix,
    pil_resize_uint8,
    resize_bilinear,
    resize_nearest,
)
from .pano import (
    crop_distortion,
    crop_equi_with_fields,
    equi2pers,
    grid_sample_equi,
)
from .postprocess import pf_postprocess

__all__ = [
    "encode_bin",
    "decode_bin",
    "encode_bin_latitude",
    "decode_bin_latitude",
    "rotation_matrix",
    "general_vfov",
    "general_vfov_to_focal",
    "vfov_to_focal_rel",
    "relative_vvp",
    "relative_horizon_line",
    "abs_vvp",
    "up_field",
    "lat_field",
    "up_field_general",
    "lat_field_general",
    "make_resize_matrix",
    "resize_bilinear",
    "resize_nearest",
    "pil_resize_uint8",
    "pf_postprocess",
    "equi2pers",
    "crop_equi_with_fields",
    "crop_distortion",
    "grid_sample_equi",
]
