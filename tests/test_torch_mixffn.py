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
    """The tile the wrapper picks is one csrc/mixffn.cu takes: float32, a
    halo <= 128 tokens and shared memory (choose_tile); bfloat16, <= 64
    outputs (fc2's wgmma M) in a halo of <= 128 tokens (<= 64 past C = 384)
    and shared memory for the ring (plan); and it covers the image."""
    th, tw = mf.choose_tile(8, h, w, c, dtype)
    assert 1 <= th <= h and 1 <= tw <= w
    assert -(-(th + 2) * (tw + 2) // 16) * 16 <= mf.MAX_HALO
    if dtype == torch.bfloat16:
        p = mf.plan(8, h, w, c)
        assert p["tile"] == (th, tw) and th * tw <= mf.OUT_ROWS_BF16
        assert (th + 2) * (tw + 2) <= (128 if c <= 384 else 64)
        assert mf.smem_bytes(dtype, c, th, tw, p["stages"]) == p["smem"] <= mf.SMEM_LIMIT
    else:
        assert mf.smem_bytes(dtype, c, th, tw) <= mf.SMEM_LIMIT
    args = _torch_args(_inputs(np.random.default_rng(6), 1, 1, 1, c, 4 * c))
    args[0] = torch.zeros(2, h, w, c)
    mf.check_kernel_args(*args)


@pytest.mark.parametrize(
    "b,h,w,c,want",
    [(8, 80, 80, 64, 0), (8, 40, 40, 128, 0), (8, 20, 20, 320, 1), (8, 10, 10, 512, 1),
     (1, 7, 7, 512, 1), (32, 20, 20, 320, 0)],
)
def test_hidden_split_fills_idle_sms(b, h, w, c, want):
    """The bf16 plan splits each tile's hidden chunks over a cluster only
    where the tiles leave SMs idle (stages 3-4 at B=8), never over more
    blocks than chunks; otherwise its cluster multicasts the weights over
    neighbouring tiles."""
    p = mf.plan(b, h, w, c)
    th, tw = p["tile"]
    tiles = b * -(-h // th) * -(-w // tw)
    assert p["split"] == want
    if want:
        assert tiles < 132 and p["blocks"] == tiles * p["cluster"] <= 2 * 132
        assert 2 <= p["cluster"] <= 4 * c // mf.HIDDEN_CHUNK
        assert p["weight_bytes"] == tiles * 8 * c * c * 2
    else:
        assert p["blocks"] == -(-tiles // p["cluster"]) * p["cluster"]
        assert p["weight_bytes"] == p["blocks"] // p["cluster"] * 8 * c * c * 2


@pytest.mark.parametrize(
    "c", [64, 96, 128, 192, 256, 320, 384, 448, 512, 576, 640, 672, 768, 896, 1024, 1280])
@pytest.mark.parametrize("b,h,w", [(8, 80, 80), (8, 20, 20), (2, 9, 5), (1, 10, 10), (3, 13, 7)])
def test_plan_fits_at_every_width(b, h, w, c):
    """Every bf16 plan at widths 64-1280 on flagship and ragged maps is one
    the kernel takes: shared memory, <= 64 outputs in a halo of <= 128
    tokens (<= 64 where a pass has more than 3 W2 tiles), a cluster of 1-8
    that divides the padded grid, a split (one pass only) over no more
    blocks than hidden chunks (and rows a block finishes: 64 / S), 2-6 ring
    stages, the passes of ``w2_passes``."""
    p = mf.plan(b, h, w, c)
    th, tw = p["tile"]
    passes, ntp = mf.w2_passes(c)
    assert p["passes"] == passes
    assert 1 <= th <= h and 1 <= tw <= w and th * tw <= mf.OUT_ROWS_BF16
    assert (th + 2) * (tw + 2) <= (128 if ntp <= mf.MAX_TILES_TWO_GROUPS else 64)
    assert p["halo_groups"] == mf.halo_groups(th, tw)
    assert p["smem"] == mf.smem_bytes(torch.bfloat16, c, th, tw, p["stages"]) <= mf.SMEM_LIMIT
    assert 2 <= p["stages"] <= mf.MAX_STAGES
    assert p["cluster"] in mf.CLUSTERS and p["blocks"] % p["cluster"] == 0
    if p["split"]:
        assert 2 <= p["cluster"] <= 4 * c // mf.HIDDEN_CHUNK and 64 % p["cluster"] == 0
        assert mf.split_fits(c, th, tw, p["stages"]) and passes == 1
    assert p["weight_bytes"] > 0


@pytest.mark.parametrize(
    "c,passes,tiles",
    [(64, 1, 1), (320, 1, 3), (640, 1, 5), (672, 2, 3), (768, 2, 3), (896, 2, 4), (1152, 2, 5),
     (1280, 2, 5)],
)
def test_w2_passes_share_the_tiles_evenly(c, passes, tiles):
    """fc2's accumulators hold at most 5 W2 tiles (640 columns): a wider C
    takes the fewest passes, each over an even share of the tiles, which
    together cover C."""
    assert mf.w2_passes(c) == (passes, tiles)
    assert tiles <= mf.MAX_TILES_PASS and passes * tiles * 128 >= c > (passes * tiles - tiles) * 128


def test_fused_module_stays_fused_past_640():
    """A MixFFN wider than 640 channels takes the fused route in both
    dtypes (the bf16 kernel walks the W2 tiles in passes)."""
    mod = mit.MixFFN(672, 4 * 672, fused=True)
    x = torch.tensor(np.random.default_rng(8).normal(size=(1, 3, 3, 672)), dtype=torch.float32)
    before = mf.LAUNCHES
    with torch.no_grad():
        calls = []
        orig = mit.mixffn
        mit.mixffn = lambda *a: calls.append(a[0].dtype) or orig(*a)
        try:
            mod(x)
            mod.to(torch.bfloat16)(x.to(torch.bfloat16))
        finally:
            mit.mixffn = orig
    assert calls == [torch.float32, torch.bfloat16] and mf.LAUNCHES == before


def test_bf16_refuses_widths_past_the_kernel():
    """bf16 takes C <= 1280: past it x's 64 halo rows and a 2-stage ring no
    longer fit shared memory."""
    assert mf.smem_bytes(torch.bfloat16, 1280, 1, 1, 2) <= mf.SMEM_LIMIT
    assert mf.smem_bytes(torch.bfloat16, 1312, 1, 1, 2) > mf.SMEM_LIMIT
    args = _torch_args(_inputs(np.random.default_rng(7), 1, 2, 2, 1312, 4 * 1312))
    mf.check_kernel_args(*args)  # float32 takes any C % 32 == 0
    with pytest.raises(ValueError, match="C <= 1280"):
        mf.check_kernel_args(*[a.to(torch.bfloat16) for a in args])
    with pytest.raises(ValueError, match="C <= 1280"):
        mf.plan(1, 2, 2, 1312)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build_mod, "find_nvcc", lambda: None)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build_mod.build("mixffn")
