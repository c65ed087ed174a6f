"""Host-side utilities of the port: the field drawings (``draw``,
``visualizer``; matplotlib and cv2 are imported only by the functions that
draw), profiling (``profiling``) and the CUDA-graph cache under the
inference forward and the train step (``cuda_graphs``)."""

from .draw import (
    blend_color,
    draw_from_r_p_f,
    draw_from_r_p_f_cx_cy,
    draw_horizon_line,
    draw_latitude_field,
    draw_perspective_fields,
    draw_prediction_distribution,
    draw_up_field,
    draw_vanishing,
)
from .profiling import StageTimer, guard_nans, profile_to, trace
from .visualizer import VisImage, VisualizerPerspective

__all__ = [
    "draw_perspective_fields",
    "draw_up_field",
    "draw_latitude_field",
    "draw_from_r_p_f",
    "draw_from_r_p_f_cx_cy",
    "draw_horizon_line",
    "draw_vanishing",
    "blend_color",
    "draw_prediction_distribution",
    "VisImage",
    "VisualizerPerspective",
    "trace",
    "profile_to",
    "StageTimer",
    "guard_nans",
]
