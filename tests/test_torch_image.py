"""The port's device-side resizes, fused preprocess and native list entry
points against the JAX package's, on CPU in f32 (seeded numpy inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perspectivefields_tpu import native as jax_native
from perspectivefields_tpu.ops import image as jax_image
from perspectivefields_tpu_torch import native
from perspectivefields_tpu_torch.ops import image

MEAN = np.array([103.53, 116.28, 123.675], np.float32)
STD = np.array([2.0, 1.0, 3.0], np.float32)


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize(
    "method,in_shape,out_hw",
    [
        ("pil_bilinear", (2, 40, 52, 3), (17, 23)),  # taps, downscale
        ("pil_bilinear", (2, 13, 9, 3), (30, 20)),  # taps, upscale
        ("pil_bilinear", (2, 20, 16, 8), (10, 8)),  # exact 2x: phase form (C >= 8)
        ("pil_bilinear", (2, 20, 16, 3), (10, 8)),  # exact 2x, C < 8: taps
        ("nearest", (2, 21, 17, 4), (8, 40)),
        ("torch_bilinear", (2, 11, 7, 8), (22, 14)),  # JAX's 2x phase form
        ("torch_bilinear", (2, 11, 7, 3), (5, 30)),
    ],
)
def test_resize_bilinear_matches_jax(method, in_shape, out_hw):
    x = _normal(0, in_shape)
    got = image.resize_bilinear(torch.from_numpy(x), *out_hw, method=method).numpy()
    want = np.asarray(jax_image.resize_bilinear(jnp.asarray(x), *out_hw, method))
    assert got.shape == want.shape == (*in_shape[:-3], *out_hw, in_shape[-1])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("axis", [-3, -2])
def test_2x_phase_forms_match_jax_and_the_matrices(axis):
    x = _normal(1, (2, 12, 10, 8))
    n = x.shape[axis]
    up = image._up2x_axis_torch(torch.from_numpy(x), axis).numpy()
    np.testing.assert_allclose(
        up, np.asarray(jax_image._up2x_axis_torch(jnp.asarray(x), axis)), atol=1e-6
    )
    down = image._down2x_axis_pil(torch.from_numpy(x), axis).numpy()
    np.testing.assert_allclose(
        down, np.asarray(jax_image._down2x_axis_pil(jnp.asarray(x), axis)), atol=1e-6
    )
    for got, method, out in ((up, "torch_bilinear", 2 * n), (down, "pil_bilinear", n // 2)):
        m = image.make_resize_matrix(n, out, method)
        want = np.moveaxis(np.tensordot(m, np.moveaxis(x, axis, 0), axes=1), 0, axis)
        np.testing.assert_allclose(got, want, atol=1e-5)
    # resize_bilinear's 2x torch-bilinear upsample is F.interpolate's kernel
    y = torch.from_numpy(x)
    both = image._up2x_axis_torch(image._up2x_axis_torch(y, -3), -2)
    interp = F.interpolate(y.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(both.numpy(), interp.numpy(), atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 1, 1, 3), (2, 2, 3, 4), (3, 5, 7, 2), (1, 10, 10, 8)])
def test_up2x_bilinear_is_resize_bilinear_with_its_gradient(shape):
    """The heads' upsample: resize_bilinear's forward bit for bit, and
    F.interpolate's gradient (float64) from the deterministic adjoint."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=shape)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(shape[0], 2 * shape[1], 2 * shape[2], shape[3])))
    got = image.up2x_bilinear(x)
    want = image.resize_bilinear(x, 2 * shape[1], 2 * shape[2])
    assert torch.equal(got, want)
    (grad_got,) = torch.autograd.grad(got, x, g)
    (grad_want,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(grad_got, grad_want, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(image.up2x_bilinear, (x.detach()[:1].requires_grad_(),))


def test_up2x_bilinear_gradient_keeps_the_input_dtype():
    x = torch.from_numpy(_normal(4, (2, 6, 5, 8))).to(torch.bfloat16).requires_grad_()
    image.up2x_bilinear(x).float().square().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    xf = x.detach().float().requires_grad_()
    image.resize_bilinear(xf, 12, 10).square().sum().backward()
    torch.testing.assert_close(x.grad.float(), xf.grad, rtol=1e-2, atol=1e-2)


def test_phase_path_promotes_integer_input():
    x = _u8(2, (1, 8, 8, 8))
    got = image.resize_bilinear(torch.from_numpy(x), 4, 4, method="pil_bilinear")
    assert got.dtype == torch.float32
    want = np.asarray(jax_image.resize_bilinear(jnp.asarray(x), 4, 4, "pil_bilinear"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_existing_torch_bilinear_callers_keep_f_interpolate():
    x = torch.from_numpy(_normal(3, (2, 9, 7, 64)))
    want = F.interpolate(x.permute(0, 3, 1, 2), size=(18, 14), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(image.resize_bilinear(x, 18, 14), want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown resize method"):
        image.resize_bilinear(x, 4, 4, method="bicubic")


def test_device_pil_resize_within_one_lsb_of_exact():
    """The float 'pil_bilinear' resize of a uint8 image stays within 1 LSB
    of the bit-exact host resize (tests/test_image.py's bound)."""
    img = _u8(4, (480, 640, 3))
    exact = native.pil_resize_uint8(img, 320, 320).astype(np.float32)
    approx = image.resize_bilinear(torch.from_numpy(img), 320, 320, method="pil_bilinear")
    assert np.max(np.abs(np.round(approx.numpy()) - exact)) <= 1.0
    fn = image.make_resize((480, 640), (320, 320), "pil_bilinear", "cpu")
    torch.testing.assert_close(fn(torch.from_numpy(img)), approx, atol=0, rtol=0)


@pytest.mark.parametrize("method", ["pil_bilinear", "torch_bilinear"])
def test_fused_preprocess_matches_jax(method):
    img = _u8(7, (2, 64, 48, 3))
    got = image.make_fused_preprocess((64, 48), (32, 24), MEAN, STD, torch.float32, method)(
        torch.from_numpy(img)
    )
    assert got.dtype == torch.float32 and got.shape == (2, 32, 24, 3)
    want = jax_image.make_fused_preprocess((64, 48), (32, 24), MEAN, STD, jnp.float32, method)(
        jnp.asarray(img)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-5)
    ref = (image.resize_bilinear(torch.from_numpy(img), 32, 24, method).numpy() - MEAN) / STD
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-5)
    bf16 = image.make_fused_preprocess((64, 48), (32, 24), MEAN, STD, torch.bfloat16, method)
    out = bf16(torch.from_numpy(img))
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= 2.0  # bf16 steps at |x| ~ 130


# ------------------------------------------------------- native list entry points


@pytest.fixture(params=["native", "numpy"])
def backend(request, monkeypatch):
    """The port's native module on its C++ path and on its numpy path."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
    elif native.backend() != "native":
        pytest.skip("the native library did not build here")
    return request.param


def _frames(seed, n, hw=(50, 70)):
    return [_u8(seed + i, (*hw, 3)) for i in range(n)]


@pytest.mark.parametrize("flip", [False, True])
def test_resize_list_u8_bit_exact(backend, flip):
    frames = _frames(10, 3)
    got = native.resize_list_u8(frames, 32, 40, bgr_flip=flip, pad_to=5)
    assert got.shape == (5, 32, 40, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_native.resize_list_u8(frames, 32, 40, flip, pad_to=5))
    np.testing.assert_array_equal(got[3], got[2])
    np.testing.assert_array_equal(got[:3], native.resize_batch_u8(np.stack(frames), 32, 40, flip))
    np.testing.assert_array_equal(
        got[:3], jax_native.resize_batch_u8(np.stack(frames), 32, 40, bgr_flip=flip)
    )


@pytest.mark.parametrize("flip", [False, True])
def test_preprocess_list_bit_exact(backend, flip):
    frames = _frames(20, 2, hw=(90, 70))
    got = native.preprocess_list(frames, 48, 40, MEAN, STD, bgr_flip=flip, pad_to=4)
    assert got.shape == (4, 48, 40, 3) and got.dtype == np.float32
    want = jax_native.preprocess_list(frames, 48, 40, MEAN, STD, bgr_flip=flip, pad_to=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[:2], native.preprocess_batch(np.stack(frames), 48, 40, MEAN, STD, bgr_flip=flip)
    )


def test_list_functions_write_into_out(backend):
    frames = _frames(30, 2)
    out = np.full((3, 16, 16, 3), 7, np.uint8)
    assert native.resize_list_u8(frames, 16, 16, pad_to=3, out=out) is out
    np.testing.assert_array_equal(out, jax_native.resize_list_u8(frames, 16, 16, pad_to=3))
    outf = torch.empty((2, 16, 16, 3)).numpy()  # e.g. a pinned tensor's view
    native.preprocess_list(frames, 16, 16, MEAN, STD, out=outf)
    np.testing.assert_array_equal(outf, jax_native.preprocess_list(frames, 16, 16, MEAN, STD))
    batch = np.empty((2, 16, 16, 3), np.float32)
    native.preprocess_batch(np.stack(frames), 16, 16, MEAN, STD, out=batch)
    np.testing.assert_array_equal(batch, outf)
    for bad in (np.empty((2, 16, 16, 3), np.uint8), np.empty((2, 16, 16, 3), np.float32)[:, ::2]):
        with pytest.raises(ValueError, match="out must be"):
            native.resize_list_u8(frames, 16, 16, pad_to=3, out=bad)


def test_list_functions_reject_bad_frames(backend):
    good = _u8(40, (50, 60, 3))
    with pytest.raises(ValueError, match="frame 1"):
        native.resize_list_u8([good, _u8(41, (40, 60, 3))], 32, 32)
    with pytest.raises(ValueError, match="frame 1"):
        native.preprocess_list([good, good.astype(np.float32)], 32, 32, MEAN, STD)
    with pytest.raises(ValueError, match="empty"):
        native.resize_list_u8([], 32, 32)


def test_num_threads_matches_jax(backend):
    if backend == "numpy":
        assert native.num_threads() == 1
    else:
        assert native.num_threads() == jax_native.num_threads() >= 1
