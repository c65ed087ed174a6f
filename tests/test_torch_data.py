"""The port's synthetic training data against the JAX package's, on CPU.

JAX's threefry draws cannot be reproduced in torch, so the parity checks
feed JAX's own sampled cameras (and its pano noise) to the port:
``render_batch`` against JAX's ``make_batch_generator`` batch, regression
and classification targets; ``pano_from_noise`` against JAX's
``synthetic_pano`` (its ``jax.image.resize(..., "linear")`` against
``F.interpolate(bilinear, align_corners=False)``). The port's own streams
are checked for seekability and determinism.

Tolerances: images 255 * 1e-4 (bilinear taps of coordinates an ulp
apart); up fields, sin-latitude and normalized parameters 1e-5; the pano
1e-4 on its 0-255 scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu import data as jax_data
from perspectivefields_tpu_torch import data


IMG_TOL, FIELD_TOL = 255 * 1e-4, 1e-5
HW = (48, 64)


@pytest.fixture(scope="module")
def pano():
    return np.asarray(jax_data.synthetic_pano(jax.random.PRNGKey(3), 128, 256))


@pytest.mark.parametrize("classes", [None, (73, 180)], ids=["regression", "classification"])
def test_render_batch_with_jax_cams_matches_jax(pano, classes):
    kw = {} if classes is None else {"gravity_classes": classes[0], "latitude_classes": classes[1]}
    want = jax_data.make_batch_generator(*HW, **kw)(jax.random.PRNGKey(5), jnp.asarray(pano), 6)
    cams = {k: torch.tensor(np.asarray(v)) for k, v in want["cams"].items()}
    got = data.render_batch(cams, torch.tensor(pano), *HW, **kw)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), atol=IMG_TOL)
    np.testing.assert_allclose(got["gt_params"].numpy(), np.asarray(want["gt_params"]),
                               atol=FIELD_TOL)
    if classes is None:
        assert got["image"].shape == (6, *HW, 3) and got["gt_latitude"].shape == (6, *HW, 1)
        for key in ("gt_gravity", "gt_latitude"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=FIELD_TOL)
    else:
        # bins: a field an ulp from a bin edge may land in the next bin
        for key in ("gt_gravity", "gt_latitude"):
            g, w = got[key].numpy(), np.asarray(want[key])
            assert g.dtype == np.int32 and g.shape == w.shape == (6, *HW)
            assert (g == w).mean() > 0.999 and np.abs(g.astype(int) - w).max() <= 1


def test_pano_from_noise_matches_jax_synthetic_pano():
    key = jax.random.PRNGKey(11)
    ph, pw = 96, 200
    want = np.asarray(jax_data.synthetic_pano(key, ph, pw))
    # the noise JAX draws inside synthetic_pano
    noise = np.asarray(jax.random.uniform(key, (ph // 8, pw // 8, 3))) * 60
    got = data.pano_from_noise(torch.tensor(noise, dtype=torch.float32), ph, pw).numpy()
    assert got.shape == (ph, pw, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bilinear_upsample_equals_jax_linear_resize():
    # the claim pano_from_noise rests on, at several ratios and odd sizes
    rng = np.random.default_rng(0)
    for (h, w), (oh, ow) in (((4, 5), (32, 40)), ((7, 3), (21, 17)), ((12, 25), (96, 200))):
        x = rng.uniform(0, 60, (h, w, 3)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (oh, ow, 3), "linear"))
        got = torch.nn.functional.interpolate(
            torch.tensor(x).permute(2, 0, 1)[None], size=(oh, ow), mode="bilinear",
            align_corners=False,
        )[0].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_camera_sampler_ranges_and_determinism():
    s = data.CameraSampler()
    cams = s.sample(data.seeded_generator(0, 1), 4000)
    for name, (lo, hi) in (("vfov", s.vfov), ("elevation", s.elevation), ("roll", s.roll),
                           ("azimuth", s.azimuth)):
        deg = np.degrees(cams[name].numpy())
        assert deg.min() >= lo and deg.max() <= hi
        assert deg.min() < lo + 1 and deg.max() > hi - 1  # covers the range
    again = s.sample(data.seeded_generator(0, 1), 4000)
    for k in cams:
        torch.testing.assert_close(cams[k], again[k], rtol=0, atol=0)


def test_data_iterator_seekable_and_matches_step_batch_fn():
    """Batch i is a pure function of (seed, i): an iterator started at
    start_step=k yields what the (k+1)-th next() of a fresh one does, and
    make_step_batch_fn(seed)(k) the same (tools/train.py's resume rule)."""
    kw = dict(batch_size=2, im_hw=(32, 32), device="cpu")
    it0 = data.data_iterator(1, **kw)
    for _ in range(3):
        b3 = next(it0)
    b3_seek = next(data.data_iterator(1, start_step=2, **kw))
    b3_fn = data.make_step_batch_fn(1, **kw)(2)
    for b in (b3_seek, b3_fn):
        for key in ("image", "gt_gravity", "gt_latitude", "gt_params"):
            torch.testing.assert_close(b[key], b3[key], rtol=0, atol=0)
        for key in b3["cams"]:
            torch.testing.assert_close(b["cams"][key], b3["cams"][key], rtol=0, atol=0)
    b0 = next(data.data_iterator(1, **kw))
    assert not torch.equal(b0["image"], b3["image"])  # batches differ
    other = next(data.data_iterator(2, **kw))
    assert not torch.equal(other["cams"]["vfov"], b0["cams"]["vfov"])  # seeds differ


def test_batches_are_made_on_the_pano_device_and_are_finite():
    b = data.make_step_batch_fn(0, batch_size=3, im_hw=(40, 56), device="cpu")(0)
    assert b["image"].device.type == "cpu" and b["image"].shape == (3, 40, 56, 3)
    for key in ("image", "gt_gravity", "gt_latitude", "gt_params"):
        assert torch.isfinite(b[key]).all()
    assert float(b["image"].min()) >= 0.0 and float(b["image"].max()) <= 255.0
    np.testing.assert_allclose(torch.linalg.vector_norm(b["gt_gravity"], dim=-1).numpy(), 1.0,
                               atol=1e-5)
