"""The port's drawings (utils/draw.py, utils/visualizer.py) against the JAX
package's, on the same inputs: each drawn image within 1 LSB per pixel.

The fields drawn come from JAX's geometry (numpy arrays, as the drawings
take them); the analytic drawings (``draw_from_r_p_f*``) compute theirs
with each package's own geometry, which agree within 1e-4 degrees
(tests/test_torch_geometry.py).
"""

import numpy as np
import pytest

from perspectivefields_tpu.ops import lat_field, up_field
from perspectivefields_tpu.utils import draw as jdraw
from perspectivefields_tpu.utils import visualizer as jvis
from perspectivefields_tpu_torch.utils import draw as tdraw
from perspectivefields_tpu_torch.utils import visualizer as tvis

LSB = 1


def _img(h=60, w=80, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _fields(h=60, w=80):
    vfov, el, ro = np.radians([70.0, 20.0, 5.0])
    up = np.asarray(up_field(vfov, w, h, el, ro))
    lat = np.radians(np.asarray(lat_field(vfov, w, h, el, ro)))
    return up, lat


def _same(got, want, lsb=LSB):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= lsb


def test_draw_up_field():
    img, (up, _) = _img(), _fields()
    _same(tdraw.draw_up_field(img, up), jdraw.draw_up_field(img, up))
    # channels-first fields are transposed as in JAX
    _same(tdraw.draw_up_field(img, up.transpose(2, 0, 1), color=(1, 0, 0)),
          jdraw.draw_up_field(img, up.transpose(2, 0, 1), color=(1, 0, 0)))


def test_draw_latitude_field():
    img, (_, lat) = _img(), _fields()
    _same(tdraw.draw_latitude_field(img, lat), jdraw.draw_latitude_field(img, lat))
    _same(tdraw.draw_latitude_field(img, lat, alpha_contourf=0.2, alpha_contour=0.5),
          jdraw.draw_latitude_field(img, lat, alpha_contourf=0.2, alpha_contour=0.5))


def test_draw_perspective_fields():
    img, (up, lat) = _img(), _fields()
    _same(tdraw.draw_perspective_fields(img, up, lat, color=(0, 1, 0)),
          jdraw.draw_perspective_fields(img, up, lat, color=(0, 1, 0)))


@pytest.mark.parametrize("mode,args", [("deg", (5.0, 20.0, 70.0)), ("rad", tuple(np.radians([-10.0, -15.0, 55.0])))])
def test_draw_from_r_p_f(mode, args):
    img = _img(seed=1)
    _same(tdraw.draw_from_r_p_f(img, *args, mode), jdraw.draw_from_r_p_f(img, *args, mode))


def test_draw_from_r_p_f_cx_cy():
    img = _img(seed=2)
    _same(tdraw.draw_from_r_p_f_cx_cy(img, 5.0, 20.0, 70.0, 0.1, -0.1, "deg", up_color=(0, 1, 0)),
          jdraw.draw_from_r_p_f_cx_cy(img, 5.0, 20.0, 70.0, 0.1, -0.1, "deg", up_color=(0, 1, 0)))
    with pytest.raises(ValueError):
        tdraw.draw_from_r_p_f_cx_cy(img, 5.0, 20.0, 70.0, 0.0, 0.0, "grad")


def test_draw_horizon_line_and_vanishing():
    img = _img(seed=3)
    _same(tdraw.draw_horizon_line(img, (0.4, 0.6), (255, 0, 0)),
          jdraw.draw_horizon_line(img, (0.4, 0.6), (255, 0, 0)))
    for vvp in ((0.3, 2.5, 1.0), (np.inf, np.inf, 1.0)):
        _same(tdraw.draw_vanishing(img, (0.4, 0.6), np.array(vvp)),
              jdraw.draw_vanishing(img, (0.4, 0.6), np.array(vvp)))


def test_blend_color_and_distribution():
    a, b = _img(seed=4), _img(seed=5)
    _same(tdraw.blend_color(a, b, 0.3), jdraw.blend_color(a, b, 0.3))
    rng = np.random.default_rng(6)
    gt = rng.normal(size=200)
    pred = gt + 0.1 * rng.normal(size=200)
    _same(tdraw.draw_prediction_distribution(pred, gt), jdraw.draw_prediction_distribution(pred, gt))


def test_visualizer_primitives():
    img = _img(seed=7)
    outs = []
    for mod in (tvis, jvis):
        v = mod.VisualizerPerspective(img)
        v.draw_text("pitch 12", (40, 10))
        v.draw_box((5, 5, 30, 25))
        v.draw_circle((50, 40), (1, 0, 0))
        v.draw_line([0, 79], [10, 50], (0, 0, 1))
        v.draw_lati(_fields()[1], contour_only=True)
        outs.append(v.get_output().get_image())
    _same(*outs)
