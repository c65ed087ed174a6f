"""High-level drawing helpers (host-side numpy, cv2, matplotlib).

Port of perspectivefields_tpu/utils/draw.py (reference
perspective2d/utils/utils.py:165-480): blend predicted or analytic
perspective fields over an image, render fields generated from camera
parameters (the paper's "easy visual check for correctness"), horizon
lines, and pred-vs-gt hexbin distributions. The analytic fields come from
the port's ``ops.geometry`` on the CPU. cv2 and matplotlib are imported by
the functions that use them, so the package imports without either.

Field layout here is channels-last (H, W, 2); channel-first inputs are
auto-detected and transposed for convenience.
"""

from __future__ import annotations

import numpy as np

from ..ops.geometry import (
    general_vfov_to_focal,
    lat_field,
    lat_field_general,
    up_field,
    up_field_general,
)
from .visualizer import VisualizerPerspective


def _as_hwc_field(field: np.ndarray) -> np.ndarray:
    field = np.asarray(field)
    if field.ndim == 3 and field.shape[0] == 2 and field.shape[-1] != 2:
        field = field.transpose(1, 2, 0)
    return field


def draw_up_field(
    img_rgb, vector_field, color=None, density=10, arrow_inv_len=20, return_img=True
):
    """Draw the up-vector field as arrows on a grid of (W//density,
    H//density) anchors, arrow length = diagonal // arrow_inv_len.

    Reference: utils.py:209-250."""
    vector_field = _as_hwc_field(vector_field)
    vis = VisualizerPerspective(np.asarray(img_rgb).copy())
    im_h, im_w = img_rgb.shape[:2]
    x, y = np.meshgrid(
        np.arange(0, im_w, max(im_w // density, 1)),
        np.arange(0, im_h, max(im_h // density, 1)),
    )
    x, y = x.ravel(), y.ravel()
    arrow_len = np.sqrt(im_w**2 + im_h**2) // arrow_inv_len
    end = vector_field[y, x, :] * arrow_len
    out = vis.draw_arrow(x, y, end[:, 0], -end[:, 1], color=color)
    return out.get_image() if return_img else out


def draw_latitude_field(
    img_rgb, latimap=None, binmap=None, alpha_contourf=0.4, alpha_contour=0.9,
    return_img=True,
):
    """Draw the latitude contour blend; latimap in radians.

    Reference: utils.py:403-429."""
    vis = VisualizerPerspective(np.asarray(img_rgb).copy())
    out = vis.draw_lati(latimap, alpha_contourf, alpha_contour)
    return out.get_image() if return_img else out


def draw_perspective_fields(
    img_rgb, up, latimap, color=None, density=10, arrow_inv_len=20, return_img=True
):
    """Latitude blend + up-vector arrows in one image; latimap in radians.

    Reference: utils.py:165-206."""
    up = _as_hwc_field(up)
    vis = VisualizerPerspective(np.asarray(img_rgb).copy())
    vis.draw_lati(np.asarray(latimap))
    im_h, im_w = img_rgb.shape[:2]
    x, y = np.meshgrid(
        np.arange(0, im_w, max(im_w // density, 1)),
        np.arange(0, im_h, max(im_h // density, 1)),
    )
    x, y = x.ravel(), y.ravel()
    arrow_len = np.sqrt(im_w**2 + im_h**2) // arrow_inv_len
    end = up[y, x, :] * arrow_len
    if color is None:
        color = (0, 1, 0)
    out = vis.draw_arrow(x, y, end[:, 0], -end[:, 1], color=color)
    return out.get_image() if return_img else out


def draw_from_r_p_f(
    img, roll, pitch, vfov, mode, up_color=None, alpha_contourf=0.4,
    alpha_contour=0.9, draw_up=True, draw_lat=True,
):
    """Generate analytic fields from (roll, pitch, vfov) and draw them.

    mode: 'deg' or 'rad'. Reference: utils.py:253-321."""
    im_h, im_w = img.shape[:2]
    if mode == "deg":
        roll, pitch, vfov = np.radians([roll, pitch, vfov])
    elif mode != "rad":
        raise ValueError("mode must be 'deg' or 'rad'")
    lati_deg = lat_field(vfov, im_w, im_h, pitch, roll).numpy()
    up = up_field(vfov, im_w, im_h, pitch, roll).numpy()
    if draw_lat:
        img = draw_latitude_field(
            img, np.radians(lati_deg), alpha_contourf=alpha_contourf,
            alpha_contour=alpha_contour,
        )
    if draw_up:
        img = draw_up_field(img, up, color=up_color)
    return img


def draw_from_r_p_f_cx_cy(
    img, roll, pitch, vfov, rel_cx, rel_cy, mode, up_color=None,
    alpha_contourf=0.4, alpha_contour=0.9, draw_up=True, draw_lat=True,
):
    """Generate analytic fields for an off-center principal point and draw.

    Reference: utils.py:324-400 (gvfov -> rel_focal via the closed-form solve
    instead of scipy fsolve)."""
    im_h, im_w = img.shape[:2]
    if mode == "deg":
        roll, pitch, vfov = np.radians([roll, pitch, vfov])
    elif mode != "rad":
        raise ValueError("mode must be 'deg' or 'rad'")
    rel_focal = float(general_vfov_to_focal(rel_cx, rel_cy, 1, vfov, False))
    lati_deg = lat_field_general(rel_focal, im_w, im_h, pitch, roll, rel_cx, rel_cy).numpy()
    up = up_field_general(rel_focal, im_w, im_h, pitch, roll, rel_cx, rel_cy).numpy()
    if draw_lat:
        img = draw_latitude_field(
            img, np.radians(lati_deg), alpha_contourf=alpha_contourf,
            alpha_contour=alpha_contour,
        )
    if draw_up:
        img = draw_up_field(img, up, color=up_color)
    return img


def draw_horizon_line(img, horizon, color, thickness=3):
    """Line between (0, h0*H) and (W, h1*H). Reference: utils.py:432-453."""
    import cv2

    im_h, im_w = img.shape[:2]
    output = img.copy()
    cv2.line(
        output,
        (0, int(horizon[0] * im_h)),
        (im_w, int(horizon[1] * im_h)),
        color,
        thickness,
    )
    return output


def draw_vanishing(
    img, horizon, vvp, pad=(1, 1), arrow_len=30, grid_step=20
):
    """Render horizon line + VVP + up-vector arrows on a padded canvas.

    Capability parity with the reference's opencv vanishing-point debug view
    (panocam.py:755-803): the image is centered on a canvas padded by
    `pad` image-sizes so an out-of-frame VVP stays visible.
    """
    import cv2

    img = img.astype(float) / 255 if img.dtype == np.uint8 else img.copy()
    im_h, im_w, im_c = img.shape
    canvas = np.ones((im_h * (pad[0] * 2 + 1), im_w * (pad[1] * 2 + 1), im_c))
    oh, ow = pad[0] * im_h, pad[1] * im_w
    canvas[oh : oh + im_h, ow : ow + im_w] = img

    if np.all(np.isfinite(horizon)):
        cv2.line(
            canvas,
            (int(ow), int(oh + horizon[0] * im_h)),
            (int(ow + im_w), int(oh + horizon[1] * im_h)),
            (1, 0, 0),
            3,
        )
    finite_vvp = np.all(np.isfinite(vvp[:2]))
    if finite_vvp:
        vvp_abs = np.array([vvp[0] * im_w + ow, vvp[1] * im_h + oh])
        cv2.circle(canvas, (int(vvp_abs[0]), int(vvp_abs[1])), 5, (1, 0, 0), -1)

    gx, gy = np.meshgrid(
        np.arange(ow, ow + im_w + grid_step, grid_step),
        np.arange(oh, oh + im_h + grid_step, grid_step),
    )
    start = np.stack((gx.ravel(), gy.ravel())).T.astype(float)
    if finite_vvp:
        d = vvp_abs - start
        d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        arrow = d * vvp[2] * arrow_len
    else:
        d = np.array([im_h * (horizon[1] - horizon[0]), -im_w], float)
        d /= max(np.linalg.norm(d), 1e-12)
        arrow = np.tile(d * arrow_len, (len(start), 1))
    for s, e in zip(start.astype(int), (start + arrow).astype(int)):
        cv2.arrowedLine(canvas, tuple(s), tuple(e), (0, 1, 0), 1, tipLength=0.1)
    return (255 * canvas).astype(np.uint8)


def blend_color(img, color, alpha=0.2):
    """Alpha-blend a color overlay onto an image (both HWC uint8/float).

    Reference: panocam.py:806-832."""
    fg = img[:, :, :3].astype(float) * (1.0 if img.dtype == np.uint8 else 255.0)
    bg = color[:, :, :3].astype(float) * (1.0 if color.dtype == np.uint8 else 255.0)
    out = alpha * fg + (1.0 - alpha) * bg
    return np.clip(out, 0, 255).astype(np.uint8)


def draw_prediction_distribution(pred, gt):
    """Hexbin of predictions vs ground truth -> RGB array.

    Reference: utils.py:456-480."""
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_agg import FigureCanvasAgg

    fig = plt.figure()
    plt.hexbin(gt, pred)
    plt.xlabel("gt")
    plt.ylabel("pred")
    lo = min(np.min(gt), np.min(pred))
    hi = max(np.max(gt), np.max(pred))
    plt.xlim(lo, hi)
    plt.ylim(lo, hi)
    plt.gca().set_aspect("equal", adjustable="box")
    canvas = FigureCanvasAgg(fig)
    s, (width, height) = canvas.print_to_buffer()
    buffer = np.frombuffer(s, dtype="uint8").reshape(height, width, 4)
    plt.close(fig)
    return buffer[:, :, :3].copy()
