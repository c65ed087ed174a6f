"""Demo: predict and draw the perspective fields of one image.

Port of demo/demo.py: prints roll / pitch / vfov / cx / cy (ParamNet
versions) and writes the field drawing ``perspective_pred.png`` and the
drawing of the fields the predicted camera gives, ``param_pred.png``.
Without ``--image`` it runs on the JAX demo's synthetic image. Reading an
image file and drawing need cv2 and matplotlib; the prediction needs
neither.

    python -m perspectivefields_tpu_torch.tools.demo --image path/to.jpg \\
        --version Paramnet-360Cities-edina-centered --output debug/
    python -m perspectivefields_tpu_torch.tools.demo --device cpu --dtype float32
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .train import resolve_device

PARAM_KEYS = {"roll": "pred_roll", "pitch": "pred_pitch", "vfov": "pred_general_vfov",
              "cx": "pred_rel_cx", "cy": "pred_rel_cy"}


def load_image_bgr(path: str | None) -> np.ndarray:
    """The image at ``path`` (BGR, cv2), or the JAX demo's synthetic
    480x640 image (a sky and a ground band plus seeded noise)."""
    if path is None:
        rng = np.random.default_rng(0)
        img = np.zeros((480, 640, 3), np.uint8)
        img[:240] = (200, 160, 120)
        img[240:] = (60, 90, 120)
        img += rng.integers(0, 30, img.shape, dtype=np.uint8)
        return img
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def camera_params(pred: dict) -> dict[str, float]:
    """roll, pitch, vfov (degrees), cx, cy of a ParamNet version's
    prediction."""
    return {name: float(pred[key]) for name, key in PARAM_KEYS.items()}


def resize_fix_aspect(img_rgb, up, lat, target_width=640):
    import cv2

    h, w = img_rgb.shape[:2]
    factor = target_width / w
    tw, th = target_width, int(h * factor)
    return cv2.resize(img_rgb, (tw, th)), cv2.resize(up, (tw, th)), cv2.resize(lat, (tw, th))


def draw(img_bgr: np.ndarray, pred: dict, output: str) -> list[str]:
    """Write the field drawing and, with camera parameters, the drawing of
    the camera's analytic fields into ``output``; returns the paths."""
    import cv2

    from ..utils.draw import draw_from_r_p_f_cx_cy, draw_perspective_fields

    os.makedirs(output, exist_ok=True)
    img_rgb = np.ascontiguousarray(img_bgr[:, :, ::-1])
    up = pred["pred_gravity_original"]
    lat = np.radians(pred["pred_latitude_original"])
    img_rgb_s, up_s, lat_s = resize_fix_aspect(img_rgb, up, lat)
    paths = [os.path.join(output, "perspective_pred.png")]
    field_vis = draw_perspective_fields(img_rgb_s, up_s, lat_s, color=(0, 1, 0))
    cv2.imwrite(paths[0], field_vis[:, :, ::-1])
    if "pred_roll" in pred:
        p = camera_params(pred)
        param_vis = draw_from_r_p_f_cx_cy(
            img_rgb_s, p["roll"], p["pitch"], p["vfov"], p["cx"], p["cy"], "deg", up_color=(0, 1, 0)
        ).astype(np.uint8)
        paths.append(os.path.join(output, "param_pred.png"))
        cv2.imwrite(paths[1], param_vis[:, :, ::-1])
    return paths


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--image", default=None, help="input image path (BGR)")
    ap.add_argument("--version", default="Paramnet-360Cities-edina-centered",
                    help="model zoo version (see --list)")
    ap.add_argument("--weights", default=None, help="converted .npz or released .pth")
    ap.add_argument("--output", default="debug", help="output folder")
    ap.add_argument("--list", action="store_true", help="list zoo versions")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="compute dtype")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import PerspectiveFields

    if args.list:
        PerspectiveFields.versions()
        return {}
    img_bgr = load_image_bgr(args.image)  # fail fast before the model is built
    model = PerspectiveFields(version=args.version, params=args.weights, compute_dtype=args.dtype,
                              device=resolve_device(args.device))
    pred = model.inference(img_bgr=img_bgr)
    if model.param_on:
        for name, value in camera_params(pred).items():
            print(f"{name}: {value:.2f}")
    draw(img_bgr, pred, args.output)
    print(f"saved visualizations to {args.output}/")
    return pred


if __name__ == "__main__":
    main()
