"""The port's fused ConvNeXt block against the JAX package's kernel.

On the CPU the port's plain version (``convnext_block_reference``) is held
against JAX's Pallas kernel run in interpret mode and against its XLA
oracle, in float32, on the JAX test's shape set; the port's
``ConvNeXt(fused_blocks=True)`` against JAX's, with the weights carried
across by ``state_dict_from_jax``. The CUDA kernel itself runs only on a
card: see tests/test_torch_cuda.py and ``python3 chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu.kernels.convnext_block import _xla_reference, convnext_block_fused
from perspectivefields_tpu.models import convnext as jconvnext
from perspectivefields_tpu_torch.checkpoint import state_dict_from_jax
from perspectivefields_tpu_torch.kernels import build as build_mod
from perspectivefields_tpu_torch.kernels import convnext_block as cb
from perspectivefields_tpu_torch.models import convnext

# ConvNeXt-T over the 320^2 field: (H, W, C) of stages 0-3, and the ragged case
FLAGSHIP = [(80, 80, 96), (40, 40, 192), (20, 20, 384), (10, 10, 768)]
RAGGED = (13, 7, 64)
NAMES = ("x", "dwk", "dwb", "lns", "lnb", "w1", "b1", "w2", "b2", "gamma")


def _inputs(rng, b, h, w, c, scale=0.3):
    """numpy inputs scaled as in tests/test_convnext_kernel.py; JAX layouts."""
    def r(*shape, s=scale):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return dict(x=r(b, h, w, c, s=1.0), dwk=r(7, 7, 1, c), dwb=r(c), lns=r(c), lnb=r(c),
                w1=r(c, 4 * c), b1=r(4 * c), w2=r(4 * c, c), b2=r(c), gamma=r(c))


def _torch_args(kw, device="cpu", dtype=torch.float32):
    """The same inputs in the port's layouts: nn.Linear (out, in) and the
    depthwise conv's (C, 1, 7, 7)."""
    t = {k: torch.tensor(v, device=device, dtype=dtype) for k, v in kw.items()}
    t["w1"], t["w2"] = t["w1"].t().contiguous(), t["w2"].t().contiguous()
    t["dwk"] = t["dwk"].permute(3, 2, 0, 1).contiguous()
    return [t[k] for k in NAMES]


@pytest.mark.parametrize(
    "h,w,c,th,nb,pad",
    [
        (16, 16, 8, 8, 1, False),  # the shapes of tests/test_convnext_kernel.py
        (10, 10, 8, 5, 2, False),
        (20, 12, 16, 4, 1, False),
        (16, 16, 8, None, None, False),
        (16, 16, 8, 8, 1, True),
        (13, 7, 32, None, None, False),  # ragged, H != W, odd sizes
    ],
)
def test_reference_matches_jax_kernel(h, w, c, th, nb, pad):
    kw = _inputs(np.random.default_rng(h * 100 + w + c), 2, h, w, c)
    jargs = [jnp.asarray(kw[k]) for k in NAMES]
    want = convnext_block_fused(*jargs, th=th, nb=nb, interpret=True, pad_lanes=pad)
    want_xla = _xla_reference(*jargs, 1e-6)
    got = cb.convnext_block_reference(*_torch_args(kw)).numpy()
    # f32 on the CPU: the JAX test's own tolerance
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(want_xla), atol=2e-5, rtol=2e-5)


def test_convnext_fused_blocks_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    kw = dict(num_classes=4, depths=(1, 1, 1, 1), dims=(8, 8, 16, 16))
    jm = jconvnext.ConvNeXt(**kw, fused_blocks=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape) * 0.3, a.dtype), params)
    tm = convnext.ConvNeXt(**kw, fused_blocks=True)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    assert all(blk.fused for stage in tm.stages for blk in stage)
    want = jm.apply(params, jnp.asarray(x))  # the kernel auto-interprets off-TPU
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_fused_and_plain_block_share_the_state_dict():
    plain, fused = convnext.ConvNeXtBlock(64), convnext.ConvNeXtBlock(64, fused=True)
    with torch.no_grad():
        plain.gamma.fill_(0.5)
    fused.load_state_dict(plain.state_dict(), strict=True)
    x = torch.tensor(np.random.default_rng(2).normal(size=(2, 9, 6, 64)), dtype=torch.float32)
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), atol=1e-5, rtol=1e-5)


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    args = _torch_args(_inputs(np.random.default_rng(3), 2, 9, 6, 32))
    before = cb.LAUNCHES
    assert torch.equal(cb.convnext_block(*args), cb.convnext_block_reference(*args))
    assert cb.LAUNCHES == before


def test_wrapper_raises_on_a_device_without_kernel():
    args = _torch_args(_inputs(np.random.default_rng(4), 1, 4, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        cb.convnext_block(*args)


def _bad_case(name):
    args = _torch_args(_inputs(np.random.default_rng(5), 1, 5, 4, 64))
    if name == "channels_not_32":
        args = _torch_args(_inputs(np.random.default_rng(5), 1, 5, 4, 48))
    elif name == "float16":
        args = [a.half() for a in args]
    elif name == "mixed_dtype":
        args[9] = args[9].to(torch.bfloat16)
    elif name == "non_contiguous":
        args[5] = args[5].t().contiguous().t()
    elif name == "dwk_shape":
        args[1] = args[1].reshape(64, 49)
    elif name == "w1_shape":
        args[5] = torch.zeros(128, 64)
    elif name == "x_rank":
        args[0] = args[0].reshape(1, 20, 64)
    elif name == "misaligned":  # a contiguous view 4 bytes into its storage
        args[0] = torch.zeros(5 * 4 * 64 + 1)[1:].view(1, 5, 4, 64)
    return args


@pytest.mark.parametrize(
    "name",
    ["channels_not_32", "float16", "mixed_dtype", "non_contiguous", "dwk_shape",
     "w1_shape", "x_rank", "misaligned"],
)
def test_kernel_arg_check_refuses(name):
    with pytest.raises(ValueError):
        cb.check_kernel_args(*_bad_case(name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h,w,c", FLAGSHIP + [RAGGED])
def test_tokens_fit_the_kernel_limits(h, w, c, dtype):
    """The launch the wrapper picks is one csrc/convnext_block.cu takes:
    float32, a multiple of 16 tokens up to 64 in shared memory; bfloat16,
    64-token tiles, a staging chunk of 8k <= 256 channels that divides C,
    2-6 ring stages in shared memory, a grid the cluster divides."""
    if dtype == torch.float32:
        no = cb.choose_tokens(c, dtype)
        assert no % 16 == 0 and 16 <= no <= cb.MAX_TOKENS
        assert cb.smem_f32(c, no) <= cb.SMEM_LIMIT
    else:
        p = cb.plan(2, h, w, c)
        assert p["tokens"] == cb.TOKENS and (c // p["cluster"]) % p["cc"] == 0 and p["cc"] % 8 == 0
        assert p["cc"] <= cb.CONSUMER_THREADS
        assert 2 <= p["stages"] <= cb.MAX_STAGES and p["smem"] <= cb.SMEM_LIMIT
        assert p["smem"] == cb.smem_bytes(c, h, w, p["cc"], p["pc"], p["stages"])
        assert p["cluster"] in cb.CLUSTERS and p["blocks"] % p["cluster"] == 0
        assert p["blocks"] == 2 * -(-h * w // 64) * p["cluster"]
    args = _torch_args(_inputs(np.random.default_rng(6), 1, 1, 1, c))
    args[0] = torch.zeros(2, h, w, c)
    cb.check_kernel_args(*args)


@pytest.mark.parametrize("b", [1, 3, 5, 8, 32])
@pytest.mark.parametrize("h,w,c", FLAGSHIP + [RAGGED, (13, 9, 768), (7, 11, 384)])
def test_hidden_split_fills_the_card_and_fits(b, h, w, c):
    """The hidden dimension is split over a cluster only while the tiles
    leave SMs idle, at most one 64-channel chunk a block, and every plan
    fits shared memory with its grid a multiple of the cluster."""
    tiles = b * -(-h * w // 64)
    p = cb.plan(b, h, w, c, 132)
    assert p["smem"] <= cb.SMEM_LIMIT and p["blocks"] == tiles * p["cluster"]
    assert p["cluster"] <= 4 * c // 64
    assert p["cluster"] == 1 or tiles * p["cluster"] <= 132
    if tiles * 2 <= 132 and 4 * c // 64 >= 2:
        assert p["cluster"] >= 2
    # the cluster sizes the card reports bound the choice
    assert cb.plan(b, h, w, c, 132, ((8, 0), (4, 0), (2, 0), (1, 132)))["cluster"] == 1


def test_flagship_plans():
    """B=8 at the flagship's stages: the split fills the card at C = 384 and
    768, and C = 768 takes two 384-column passes."""
    got = {c: cb.plan(8, h, w, c) for h, w, c in FLAGSHIP}
    assert [got[c]["cluster"] for c in (96, 192, 384, 768)] == [1, 1, 2, 8]
    assert [got[c]["passes"] for c in (96, 192, 384, 768)] == [1, 1, 1, 2]
    assert [got[c]["pc"] for c in (96, 192, 384, 768)] == [96, 192, 384, 384]


@pytest.mark.parametrize("b,h,w,c,pc,passes", [(1, 7, 7, 512, 256, 2), (8, 14, 14, 512, 256, 2),
                                               (1, 4, 4, 1024, 256, 4), (8, 7, 7, 1024, 256, 4),
                                               (2, 9, 5, 640, 384, 2)])
def test_wide_maps_take_passes_that_fit(b, h, w, c, pc, passes):
    """Past 384 channels the output columns take several passes: 256 at
    C = 512 (two passes, no column wasted), 256 at C = 1024 (the f32
    partial output of 384 columns does not fit beside y), 384 at C = 640
    (the last pass runs past C). Every plan fits with 2 or more stages."""
    p = cb.plan(b, h, w, c)
    assert (p["pc"], p["passes"]) == (pc, passes)
    assert 2 <= p["stages"] and p["smem"] == cb.smem_bytes(c, h, w, p["cc"], pc, p["stages"])
    assert p["smem"] <= cb.SMEM_LIMIT and p["blocks"] % p["cluster"] == 0


def test_too_wide_a_map_is_refused():
    with pytest.raises(ValueError, match="too wide"):
        cb.plan(1, 8, 4000, 96)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build_mod, "find_nvcc", lambda: None)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build_mod.build("convnext_block")
