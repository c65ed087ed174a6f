"""The port's fused MixFFN against the JAX package's kernel.

On the CPU the port's plain version (``mixffn_reference``) is held against
JAX's Pallas kernel run in interpret mode, in float32, on the JAX test's
shape set; the port's ``Block(fuse_ffn=True)`` against JAX's, with the
weights carried across by ``state_dict_from_jax``. The CUDA kernel itself
runs only on a card: see tests/test_torch_cuda.py and
``python3 chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu.kernels.mixffn import mixffn_fused
from perspectivefields_tpu.models import mit as jmit
from perspectivefields_tpu_torch.checkpoint import state_dict_from_jax
from perspectivefields_tpu_torch.kernels import build as build_mod
from perspectivefields_tpu_torch.kernels import mixffn as mf
from perspectivefields_tpu_torch.models import mit

# MiT-b3 at 320^2: (H, W, C) of stages 1-4, and the ragged case
FLAGSHIP = [(80, 80, 64), (40, 40, 128), (20, 20, 320), (10, 10, 512)]
RAGGED = (13, 7, 64)


def _inputs(rng, b, h, w, c, hd, scale=0.3):
    """numpy inputs scaled as in tests/test_mixffn_kernel.py; JAX layouts."""
    def r(*shape, s=scale):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return dict(x=r(b, h, w, c, s=1.0), w1=r(c, hd), b1=r(hd), dwk=r(3, 3, 1, hd),
                dwb=r(hd), w2=r(hd, c), b2=r(c))


def _torch_args(kw, device="cpu", dtype=torch.float32):
    """The same inputs in the port's layouts: nn.Linear (out, in) and the
    depthwise conv's (4C, 1, 3, 3)."""
    t = {k: torch.tensor(v, device=device, dtype=dtype) for k, v in kw.items()}
    t["w1"], t["w2"] = t["w1"].t().contiguous(), t["w2"].t().contiguous()
    t["dwk"] = t["dwk"].permute(3, 2, 0, 1).contiguous()
    return [t[k] for k in ("x", "w1", "b1", "dwk", "dwb", "w2", "b2")]


@pytest.mark.parametrize(
    "h,w,c,hd,th,nb,pad",
    [
        (16, 16, 8, 32, 8, 1, False),  # the shapes of tests/test_mixffn_kernel.py
        (10, 10, 8, 32, 5, 2, False),
        (20, 12, 16, 64, 4, 1, False),
        (16, 16, 8, 32, None, None, True),
        (13, 7, 32, 128, None, None, False),  # ragged, H != W, odd sizes
    ],
)
def test_reference_matches_jax_kernel(h, w, c, hd, th, nb, pad):
    kw = _inputs(np.random.default_rng(h * 100 + w + c), 2, h, w, c, hd)
    want = mixffn_fused(
        *[jnp.asarray(kw[k]) for k in ("x", "w1", "b1", "dwk", "dwb", "w2", "b2")],
        th=th, nb=nb, interpret=True, pad_lanes=pad,
    )
    got = mf.mixffn_reference(*_torch_args(kw)).numpy()
    # f32; JAX's GELU uses the A&S erf polynomial (abs err 1.5e-7), the
    # port erf itself: the JAX test's own tolerance
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-6, rtol=1e-5)


def test_block_fuse_ffn_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 128)).astype(np.float32)
    jm = jmit.Block(128, 2, 4, fuse_ffn=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape) * 0.1, a.dtype), params)
    tm = mit.Block(128, 2, 4, fuse_ffn=True)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    assert tm.mlp.fused
    want = jm.apply(params, jnp.asarray(x))  # the kernel auto-interprets off-TPU
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    # LN + attention + FFN: the module tests' tolerance (test_torch_models.py)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_fused_and_plain_mixffn_share_the_state_dict():
    plain, fused = mit.MixFFN(64, 256), mit.MixFFN(64, 256, fused=True)
    fused.load_state_dict(plain.state_dict(), strict=True)
    x = torch.tensor(np.random.default_rng(2).normal(size=(2, 6, 5, 64)), dtype=torch.float32)
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), atol=1e-5, rtol=1e-5)


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    args = _torch_args(_inputs(np.random.default_rng(3), 2, 9, 6, 32, 128))
    before = mf.LAUNCHES
    assert torch.equal(mf.mixffn(*args), mf.mixffn_reference(*args))
    assert mf.LAUNCHES == before


def test_wrapper_raises_on_a_device_without_kernel():
    args = _torch_args(_inputs(np.random.default_rng(4), 1, 4, 4, 32, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        mf.mixffn(*args)


def _bad_case(name):
    args = _torch_args(_inputs(np.random.default_rng(5), 1, 5, 4, 64, 256))
    if name == "channels_not_32":
        args = _torch_args(_inputs(np.random.default_rng(5), 1, 5, 4, 48, 192))
    elif name == "hidden_not_4c":
        args = _torch_args(_inputs(np.random.default_rng(5), 1, 5, 4, 64, 128))
    elif name == "float16":
        args = [a.half() for a in args]
    elif name == "mixed_dtype":
        args[1] = args[1].to(torch.bfloat16)
    elif name == "non_contiguous":
        args[5] = args[5].t().contiguous().t()
    elif name == "dwk_shape":
        args[3] = args[3].reshape(256, 9)
    elif name == "x_rank":
        args[0] = args[0].reshape(1, 20, 64)
    elif name == "misaligned":  # a contiguous view 4 bytes into its storage
        args[0] = torch.zeros(5 * 4 * 64 + 1)[1:].view(1, 5, 4, 64)
    return args


@pytest.mark.parametrize(
    "name",
    ["channels_not_32", "hidden_not_4c", "float16", "mixed_dtype", "non_contiguous",
     "dwk_shape", "x_rank", "misaligned"],
)
def test_kernel_arg_check_refuses(name):
    with pytest.raises(ValueError):
        mf.check_kernel_args(*_bad_case(name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,w,c", FLAGSHIP + [RAGGED])
def test_tile_fits_the_kernel_limits(h, w, c, dtype):
    """The tile the wrapper picks is one csrc/mixffn.cu takes: halo <= 128
    tokens, the bf16 accumulators, shared memory; and it covers the image."""
    th, tw = mf.choose_tile(8, h, w, c, dtype)
    assert 1 <= th <= h and 1 <= tw <= w
    assert -(-(th + 2) * (tw + 2) // 16) * 16 <= mf.MAX_HALO
    assert mf.smem_bytes(dtype, c, th, tw) <= mf.SMEM_LIMIT
    if dtype == torch.bfloat16:
        assert -(-th * tw // 16) * (c // 16) <= mf.MAX_OUT_TILES
    args = _torch_args(_inputs(np.random.default_rng(6), 1, 1, 1, c, 4 * c))
    args[0] = torch.zeros(2, h, w, c)
    mf.check_kernel_args(*args)


@pytest.mark.parametrize(
    "blocks,chunks,sms,want",
    [(640, 4, 132, 1), (80, 20, 132, 1), (32, 32, 132, 4), (25, 96, 132, 5), (1, 32, 132, 8),
     (2, 3, 132, 3)],
)
def test_hidden_split_fills_idle_sms(blocks, chunks, sms, want):
    """Split only where the tiles leave SMs idle; at most MAX_SPLIT, and
    never more splits than hidden chunks."""
    assert mf.choose_split(blocks, chunks, sms) == want


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build_mod, "find_nvcc", lambda: None)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build_mod.build("mixffn")
