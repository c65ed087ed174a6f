"""GPU tests of the port's CUDA kernels (marker ``cuda``; they skip without
an NVIDIA GPU). This file imports no JAX, so it runs on a machine without
it: ``python -m pytest tests/test_torch_cuda.py --noconftest -q`` (the
repository's conftest imports JAX)."""

import functools
import importlib

import numpy as np
import pytest
import torch

from perspectivefields_tpu_torch import PerspectiveFields, native
from perspectivefields_tpu_torch.config import (
    BackboneConfig,
    GravityHeadConfig,
    LatitudeHeadConfig,
    ModelConfig,
    ParamNetConfig,
)
from perspectivefields_tpu_torch.kernels import convnext_block as cb
from perspectivefields_tpu_torch.kernels import fused_block as fb
from perspectivefields_tpu_torch.kernels import mixffn as mf
from perspectivefields_tpu_torch.kernels import stage1_attention as s1
from perspectivefields_tpu_torch.models import PersNet, graphed
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.models.convnext import ConvNeXtBlock
from perspectivefields_tpu_torch.models.heads import SegFormerDecoder
from perspectivefields_tpu_torch.models.mit import Block, MixFFN, SRAttention
from perspectivefields_tpu_torch.ops import image
from perspectivefields_tpu_torch.serving import BatchPredictor

# the package exports the function decoder_tail under its module's name
dt = importlib.import_module("perspectivefields_tpu_torch.kernels.decoder_tail")
fa = importlib.import_module("perspectivefields_tpu_torch.kernels.fused_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _args(b, n, m, c, dtype, seed=0):
    """Inputs scaled as in tests/test_fused_attention.py, weights (out, in)."""
    rng = np.random.default_rng(seed)
    shapes = [((b, n, c), 1.0), ((b, m, c), 1.0), ((c, c), 0.05), ((c,), 0.01),
              ((2 * c, c), 0.05), ((2 * c,), 0.01), ((c, c), 0.05), ((c,), 0.01)]
    return [torch.tensor(rng.normal(size=s) * k, dtype=torch.float32, device="cuda").to(dtype)
            for s, k in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,n,m,c,heads",
    [(8, 1600, 100, 128, 2), (8, 400, 100, 320, 5), (8, 100, 100, 512, 8), (3, 37, 5, 128, 2)],
)
def test_kernel_matches_plain_version(cuda_device, b, n, m, c, heads, dtype):
    args = _args(b, n, m, c, dtype)
    res = _args(b, n, m, c, dtype, seed=1)[0]
    before = fa.LAUNCHES
    got = fa.fused_attention(*args, heads, 64**-0.5, residual=res)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.fused_attention_reference(
        *[a.float() for a in args], heads, 64**-0.5, residual=res.float()
    )
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:  # bf16 vs the f32 plain version on the same rounded inputs
        assert (got.float() - want).abs().max() / want.abs().max() <= 1e-2


@pytest.mark.cuda
def test_sr_attention_kernel_path_matches_plain_path(cuda_device):
    x = torch.tensor(np.random.default_rng(2).normal(size=(2, 20, 20, 320)),
                     dtype=torch.float32, device="cuda")
    paths = {}
    for use in (True, False):
        mod = init_random_(SRAttention(320, 5, sr_ratio=2, use_kernels=use), seed=3)
        paths[use] = mod.to("cuda").eval()
    before = fa.LAUNCHES
    with torch.inference_mode():
        got, want = paths[True](x), paths[False](x)
    assert fa.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_refuses_instead_of_falling_back(cuda_device):
    args = _args(1, 8, 4, 128, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.fused_attention(*args, 4, 0.125)  # head_dim 32


def _randn(rng, *shape, scale=1.0, dtype=torch.float32):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device="cuda").to(dtype)


def _ffn_args(b, h, w, c, dtype, seed=0):
    """x and MixFFN weights: Linear (out, in), depthwise (4C, 1, 3, 3)."""
    rng = np.random.default_rng(seed)
    shapes = [((b, h, w, c), 1.0), ((4 * c, c), c**-0.5), ((4 * c,), 0.1),
              ((4 * c, 1, 3, 3), 1 / 3), ((4 * c,), 0.1), ((c, 4 * c), (4 * c) ** -0.5),
              ((c,), 0.1)]
    return [_randn(rng, *s, scale=k, dtype=dtype) for s, k in shapes]


def _cnx_args(b, h, w, c, dtype, seed=0):
    """x and ConvNeXt-block weights: depthwise (C, 1, 7, 7), LN affine,
    Linear (out, in), layer scale of order 1."""
    rng = np.random.default_rng(seed)
    shapes = [((b, h, w, c), 1.0), ((c, 1, 7, 7), 1 / 7), ((c,), 0.1), ((c,), 0.1),
              ((c,), 0.1), ((4 * c, c), c**-0.5), ((4 * c,), 0.1), ((c, 4 * c), (4 * c) ** -0.5),
              ((c,), 0.1), ((c,), 0.5)]
    args = [_randn(rng, *s, scale=k, dtype=dtype) for s, k in shapes]
    args[3] = args[3] + 1.0  # LayerNorm scale near 1
    return args


def _assert_kernel_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:  # bf16 vs the f32 plain version on the same rounded inputs
        assert (got.float() - want).abs().max() / want.abs().max() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,c", [(8, 80, 80, 64), (8, 40, 40, 128), (8, 20, 20, 320), (8, 10, 10, 512), (3, 13, 7, 64)],
)
def test_mixffn_kernel_matches_plain_version(cuda_device, b, h, w, c, dtype):
    args = _ffn_args(b, h, w, c, dtype)
    before = mf.LAUNCHES
    got = mf.mixffn(*args)
    torch.cuda.synchronize()
    assert mf.LAUNCHES == before + 1
    _assert_kernel_close(got, mf.mixffn_reference(*[a.float() for a in args]), dtype)


# (cluster, split) of the bf16 MixFFN and attention kernels: multicast over
# 1, 2, 4, 8 tiles, or a split of a tile's hidden chunks / heads over 2, 4, 8
CLUSTER_SPLITS = [(1, 0), (2, 0), (4, 0), (8, 0), (2, 1), (4, 1), (8, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,split", CLUSTER_SPLITS)
@pytest.mark.parametrize("b,h,w,c,tile", [(3, 13, 7, 128, (5, 7)), (2, 9, 10, 128, (4, 10)),
                                          (2, 9, 5, 320, (3, 5))])
def test_mixffn_kernel_at_every_cluster_and_split(cuda_device, b, h, w, c, tile, cluster, split):
    """bf16, every multicast cluster and hidden split on ragged maps, with
    one (5x7, 3x5) and two (4x10) row groups of halo: grids padded to the
    cluster, tiles cut at the map's edge, partial outputs summed over 2-8
    blocks."""
    args = _ffn_args(b, h, w, c, torch.bfloat16, seed=cluster + split)
    stages = mf.ring_stages(c, *tile)
    assert not split or mf.split_fits(c, *tile, stages)
    got = mf.launch(*args, *tile, cluster, split, stages)
    torch.cuda.synchronize()
    _assert_kernel_close(got, mf.mixffn_reference(*[a.float() for a in args]), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [96, 192, 256, 384, 448, 576, 640, 672, 768, 896, 1024, 1280])
@pytest.mark.parametrize("b,h,w", [(2, 9, 5), (1, 12, 12), (8, 10, 10)])
def test_mixffn_kernel_at_every_width(cuda_device, b, h, w, c):
    """bf16 widths past MiT's four, up to 1280 (NT = 1 to 5 W2 tiles a
    pass; two passes past 640), on the wrapper's own plan."""
    args = _ffn_args(b, h, w, c, torch.bfloat16, seed=c)
    before = mf.LAUNCHES
    got = mf.mixffn(*args)
    torch.cuda.synchronize()
    assert mf.LAUNCHES == before + 1
    _assert_kernel_close(got, mf.mixffn_reference(*[a.float() for a in args]), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("b,h,w,c,tile", [(2, 9, 10, 704, (4, 8)), (3, 7, 11, 1024, (5, 7))])
def test_mixffn_kernel_in_passes_at_every_cluster(cuda_device, b, h, w, c, tile, cluster):
    """bf16 past 640 channels (two passes over the W2 tiles, the last one
    partly past C), every multicast cluster on ragged maps; a split, which
    takes one pass only, is refused."""
    args = _ffn_args(b, h, w, c, torch.bfloat16, seed=cluster)
    stages = mf.ring_stages(c, *tile)
    got = mf.launch(*args, *tile, cluster, 0, stages)
    torch.cuda.synchronize()
    _assert_kernel_close(got, mf.mixffn_reference(*[a.float() for a in args]), torch.bfloat16)
    if cluster > 1:
        with pytest.raises(RuntimeError, match="invalid argument"):
            mf.launch(*args, *tile, cluster, 1, stages)


@pytest.mark.cuda
def test_mixffn_smem_count_matches_kernel(cuda_device):
    for c in (64, 128, 320, 512, 640, 768, 1280):
        for th, tw in [(1, 1), (5, 7), (6, 6), (4, 10), (3, 20)]:
            for stages in (2, 3, 6):
                for dtype in (torch.float32, torch.bfloat16):
                    if dtype == torch.float32 and stages != 2:
                        continue
                    assert mf.smem_bytes(dtype, c, th, tw, stages) == mf.kernel_smem_bytes(
                        dtype, c, th, tw, stages)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,split", CLUSTER_SPLITS)
@pytest.mark.parametrize("b,n,m,heads", [(3, 100, 100, 8), (2, 129, 37, 9)])
def test_attention_kernel_at_every_cluster_and_split(cuda_device, b, n, m, heads, cluster, split):
    """bf16, every multicast cluster and head split: grids padded to the
    cluster, row tiles cut at N, shares of 1-5 heads and of the output
    columns, o gathered over the split's 2-8 blocks."""
    c = heads * 64
    args = _args(b, n, m, c, torch.bfloat16, seed=cluster + split)
    res = _args(b, n, m, c, torch.bfloat16, seed=9)[0]
    hs = -(-heads // cluster) if split else heads
    stages = max(s for s in range(2, 7) if fa.smem_bytes(c, hs, s) <= fa.SMEM_LIMIT)
    got = fa.launch(*args, heads, 64**-0.5, res, cluster, split, stages)
    torch.cuda.synchronize()
    want = fa.fused_attention_reference(*[a.float() for a in args], heads, 64**-0.5,
                                        residual=res.float())
    _assert_kernel_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("with_residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize(
    "b,n,m,heads",
    [(2, 65, 1, 1), (3, 37, 128, 2), (2, 129, 100, 3), (1, 1, 100, 4), (4, 200, 128, 5),
     (2, 63, 1, 7), (1, 100, 100, 8), (2, 64, 100, 10), (1, 31, 1, 11)],
)
def test_attention_kernel_on_ragged_rows_at_every_width(cuda_device, b, n, m, heads, with_residual):
    """bf16, N not a multiple of 64, M = 1, 100 and 128, C = 64 to 704 (the
    width B6's gate sends here), on the wrapper's own plan."""
    c = heads * 64
    args = _args(b, n, m, c, torch.bfloat16, seed=heads)
    res = _args(b, n, m, c, torch.bfloat16, seed=10)[0] if with_residual else None
    before = fa.LAUNCHES
    got = fa.fused_attention(*args, heads, 64**-0.5, residual=res)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    want = fa.fused_attention_reference(*[a.float() for a in args], heads, 64**-0.5,
                                        residual=None if res is None else res.float())
    _assert_kernel_close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_attention_smem_count_matches_kernel(cuda_device):
    for c in (64, 128, 320, 512, 640, 704):
        for hs in (1, 2, 5, 11):
            for stages in (2, 3, 6):
                assert fa.smem_bytes(c, hs, stages) == fa.kernel_smem_bytes(c, hs, stages)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,c", [(8, 80, 80, 96), (8, 40, 40, 192), (8, 20, 20, 384), (8, 10, 10, 768), (3, 13, 7, 64)],
)
def test_convnext_block_kernel_matches_plain_version(cuda_device, b, h, w, c, dtype):
    args = _cnx_args(b, h, w, c, dtype)
    before = cb.LAUNCHES
    got = cb.convnext_block(*args)
    torch.cuda.synchronize()
    assert cb.LAUNCHES == before + 1
    _assert_kernel_close(got, cb.convnext_block_reference(*[a.float() for a in args]), dtype)


@pytest.mark.cuda
def test_fused_modules_match_unfused_modules_in_f32(cuda_device):
    x = torch.tensor(np.random.default_rng(3).normal(size=(2, 20, 20, 320)),
                     dtype=torch.float32, device="cuda")
    ffn = {f: init_random_(MixFFN(320, 1280, fused=f), seed=4).cuda().eval() for f in (True, False)}
    blk = {f: init_random_(ConvNeXtBlock(320, fused=f), seed=4).cuda().eval() for f in (True, False)}
    with torch.no_grad():
        for m in blk.values():
            m.gamma.fill_(0.5)
        before = (mf.LAUNCHES, cb.LAUNCHES)
        torch.testing.assert_close(ffn[True](x), ffn[False](x), atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(blk[True](x), blk[False](x), atol=1e-4, rtol=1e-4)
    assert (mf.LAUNCHES, cb.LAUNCHES) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_fused_kernels_refuse_instead_of_falling_back(cuda_device):
    ffn = _ffn_args(1, 4, 4, 64, torch.float32)
    ffn[0] = ffn[0][..., :48].contiguous()  # C % 32 != 0
    with pytest.raises(ValueError, match="C % 32"):
        mf.mixffn(*ffn)
    cnx = _cnx_args(1, 4, 4, 64, torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        cb.convnext_block(*cnx)


@pytest.mark.cuda
@pytest.mark.parametrize("with_residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n,m", [(8, 6400, 100), (3, 999, 37)])
def test_stage1_kernel_matches_plain_version(cuda_device, b, n, m, dtype, with_residual):
    args = _args(b, n, m, 64, dtype)
    res = _args(b, n, m, 64, dtype, seed=1)[0] if with_residual else None
    before = s1.LAUNCHES
    got = s1.stage1_attention(*args, 0.125, residual=res)
    torch.cuda.synchronize()
    assert s1.LAUNCHES == before + 1
    want = s1.stage1_attention_reference(
        *[a.float() for a in args], 0.125, residual=None if res is None else res.float()
    )
    _assert_kernel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("with_residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("n", [1, 64, 6400, 6401])
@pytest.mark.parametrize("m", [1, 100, 128])
def test_stage1_kernel_at_every_key_and_token_count(cuda_device, m, n, with_residual):
    """bf16 on the wrapper's own plan: M = 1, 100 and 128 keys (the padded
    keys' logits at -inf), N = 1, 64, 6400 and 6401 tokens (a last tile of
    one row, whose other rows come from the next image or past the end)."""
    b = 3 if n < 6400 else 2
    args = _args(b, n, m, 64, torch.bfloat16, seed=m + n)
    res = _args(b, n, m, 64, torch.bfloat16, seed=1)[0] if with_residual else None
    before = s1.LAUNCHES
    got = s1.stage1_attention(*args, 0.125, residual=res)
    torch.cuda.synchronize()
    assert s1.LAUNCHES == before + 1
    want = s1.stage1_attention_reference(
        *[a.float() for a in args], 0.125, residual=None if res is None else res.float())
    _assert_kernel_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 7, 50])
def test_stage1_kernel_at_every_block_count(cuda_device, g):
    """bf16 with 1 to 50 blocks per image forced: runs of 50 tiles down to
    one, and warpgroups with no tile at all (g = 50 over 51 tiles)."""
    args = _args(2, 3201, 100, 64, torch.bfloat16, seed=g)
    res = _args(2, 3201, 100, 64, torch.bfloat16, seed=2)[0]
    got = s1.launch(*args, 0.125, res, g)
    torch.cuda.synchronize()
    want = s1.stage1_attention_reference(*[a.float() for a in args], 0.125, residual=res.float())
    _assert_kernel_close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_stage1_smem_count_matches_kernel(cuda_device):
    assert s1.smem_bytes() == s1.kernel_smem_bytes()


def _block_args(b, h, w, c, m, dtype, seed=0):
    """ln1x, kv_in, res and the block's weights, scaled as in
    tests/test_fused_block.py; torch layouts."""
    rng = np.random.default_rng(seed)
    n, hid = h * w, 4 * c
    shapes = [((b, n, c), 0.5), ((b, m, c), 0.5), ((b, n, c), 0.5),
              ((c, c), 0.05), ((c,), 0.05), ((2 * c, c), 0.05), ((2 * c,), 0.05),
              ((c, c), 0.05), ((c,), 0.05), ((c,), 0.1), ((c,), 0.05),
              ((hid, c), 0.05), ((hid,), 0.05), ((hid, 1, 3, 3), 0.05), ((hid,), 0.05),
              ((c, hid), 0.05), ((c,), 0.05)]
    args = [_randn(rng, *s, scale=k, dtype=dtype) for s, k in shapes]
    args[9] = args[9] + 1.0  # LayerNorm scale near 1
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,c,heads,m", [(8, 20, 20, 320, 5, 100), (8, 10, 10, 512, 8, 100), (3, 7, 5, 128, 2, 7)],
)
def test_fused_block_kernel_matches_plain_version(cuda_device, b, h, w, c, heads, m, dtype):
    args = _block_args(b, h, w, c, m, dtype)
    before = fb.LAUNCHES
    got = fb.fused_block(*args, heads, 64**-0.5, h, w)
    torch.cuda.synchronize()
    assert fb.LAUNCHES == before + 1
    want = fb.fused_block_reference(*[a.float() for a in args], heads, 64**-0.5, h, w)
    _assert_kernel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_block_smem_count_matches_kernel(cuda_device, dtype):
    for c in (128, 192, 320, 512, 640):
        for th, tw in [(1, 1), (2, 2), (3, 3), (5, 5), (4, 7)]:
            for stages in (2, 3, 6):
                assert fb.smem_bytes(dtype, c, th, tw, stages) == fb.kernel_smem_bytes(
                    dtype, c, th, tw, stages)


@pytest.mark.cuda
def test_convnext_block_smem_count_matches_kernel(cuda_device):
    for c, h, w in [(96, 80, 80), (192, 40, 40), (384, 20, 20), (768, 10, 10), (64, 13, 7),
                    (512, 7, 7), (1024, 4, 4)]:
        p = cb.plan(8, h, w, c)
        for stages in (1, p["stages"]):
            assert cb.smem_bytes(c, h, w, p["cc"], p["pc"], stages) == cb.kernel_smem_bytes(
                c, h, w, p["cc"], p["pc"], stages)


# (K, N) of the Hopper GEMM core at the kernels' shapes: K = C, N = 64 / 128
# hidden channels or C outputs (B4: C = 96 ... 768; B6: C = 320, 512)
GEMM_SHAPES = [(k, n) for k in (96, 192, 384, 768, 320, 512) for n in (64, 128, k)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1], ids=["smem_a", "register_a"])
@pytest.mark.parametrize("k,n", GEMM_SHAPES)
def test_gemm_core_matches_matmul(cuda_device, k, n, mode):
    """The wgmma core (descriptors, swizzle, the TMA ring, register A)
    against torch.matmul in f32 on the same bf16 inputs; 130 rows, so the
    last block's tile is ragged."""
    rng = np.random.default_rng(k + n + mode)
    a = _randn(rng, 130, k, dtype=torch.bfloat16)
    w = _randn(rng, n, k, scale=k**-0.5, dtype=torch.bfloat16)
    want = a.float() @ w.float().t()
    libs = [cb._library()] + ([fb._library()] if k in (320, 512) else [])
    for lib in libs:
        got = cb.gemm_core(a, w, mode, lib)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,c",
    [(1, 10, 10, 768), (3, 13, 9, 768), (5, 7, 11, 384), (1, 20, 20, 384), (3, 13, 9, 96),
     (5, 7, 11, 192)],
)
def test_convnext_block_kernel_on_grids_the_cluster_does_not_divide(cuda_device, b, h, w, c, dtype):
    """Batches of 1, 3 and 5 and ragged maps: token tiles cut at the image's
    end, clusters that split the hidden dimension over 2-8 blocks."""
    args = _cnx_args(b, h, w, c, dtype, seed=b + h)
    before = cb.LAUNCHES
    got = cb.convnext_block(*args)
    torch.cuda.synchronize()
    assert cb.LAUNCHES == before + 1
    _assert_kernel_close(got, cb.convnext_block_reference(*[a.float() for a in args]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,c,heads,m",
    [(1, 20, 20, 320, 5, 100), (3, 13, 9, 320, 5, 100), (5, 7, 11, 512, 8, 100),
     (1, 10, 10, 512, 8, 37), (5, 13, 9, 128, 2, 128), (3, 20, 20, 320, 5, 64)],
)
def test_fused_block_kernel_on_grids_the_cluster_does_not_divide(cuda_device, b, h, w, c, heads, m,
                                                                 dtype):
    """Batches of 1, 3 and 5 and ragged maps: tiles cut at the map's edge,
    grids padded to the cluster with blocks that load and write nothing."""
    args = _block_args(b, h, w, c, m, dtype, seed=b + h)
    before = fb.LAUNCHES
    got = fb.fused_block(*args, heads, 64**-0.5, h, w)
    torch.cuda.synchronize()
    assert fb.LAUNCHES == before + 1
    want = fb.fused_block_reference(*[a.float() for a in args], heads, 64**-0.5, h, w)
    _assert_kernel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,c", [(1, 7, 7, 512), (1, 4, 4, 1024), (2, 9, 5, 640), (8, 7, 7, 1024)])
def test_convnext_block_kernel_past_one_384_column_pass(cuda_device, b, h, w, c, dtype):
    """Widths that are not a multiple of the 384-column pass (ConvNeXt-B's
    512 and 1024 through ConvNeXt(dims=...)): passes of 256 columns, or a
    last pass that runs past C and must store nothing there."""
    args = _cnx_args(b, h, w, c, dtype, seed=c + b)
    before = cb.LAUNCHES
    got = cb.convnext_block(*args)
    torch.cuda.synchronize()
    assert cb.LAUNCHES == before + 1
    _assert_kernel_close(got, cb.convnext_block_reference(*[a.float() for a in args]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,c,m",
    [(2, 9, 7, 192, 63), (3, 10, 10, 256, 100), (2, 10, 10, 384, 25), (1, 7, 9, 448, 128),
     (2, 10, 10, 576, 100), (1, 8, 8, 640, 16)],
)
def test_fused_block_kernel_at_every_width_the_gate_admits(cuda_device, b, h, w, c, m, dtype):
    """C = heads * 64 past MiT's four widths, up to 640 (NT = 2 to 5 W2
    tiles), on maps where ``fused_block_viable`` admits them."""
    assert fb.fused_block_viable(b, h * w, c, 4 * c, m, c // 64)
    args = _block_args(b, h, w, c, m, dtype, seed=c)
    before = fb.LAUNCHES
    got = fb.fused_block(*args, c // 64, 64**-0.5, h, w)
    torch.cuda.synchronize()
    assert fb.LAUNCHES == before + 1
    want = fb.fused_block_reference(*[a.float() for a in args], c // 64, 64**-0.5, h, w)
    _assert_kernel_close(got, want, dtype)


@pytest.mark.cuda
def test_block_routes_match_plain_paths_in_f32(cuda_device):
    """The stage-1 attention route and the fused block against the plain
    modules, f32, from the same weights."""
    x = torch.tensor(np.random.default_rng(5).normal(size=(2, 48, 48, 64)),
                     dtype=torch.float32, device="cuda")
    attn = {f: init_random_(SRAttention(64, 1, 8, use_kernels=True, fuse_block=f), seed=6)
            .cuda().eval() for f in (True, False)}
    assert attn[True].route(48 * 48, 36, x.device) == "stage1_attention"
    before = s1.LAUNCHES
    with torch.inference_mode():
        torch.testing.assert_close(attn[True](x), attn[False](x), atol=1e-4, rtol=1e-4)
    assert s1.LAUNCHES == before + 1

    x = torch.tensor(np.random.default_rng(7).normal(size=(2, 20, 20, 320)),
                     dtype=torch.float32, device="cuda")
    blk = {f: init_random_(Block(320, 5, 2, use_kernels=True, fuse_block=f), seed=8)
           .cuda().eval() for f in (True, False)}
    assert blk[True].route(2, 20, 20, x.device) == "fused_block"
    before = fb.LAUNCHES
    with torch.inference_mode():
        torch.testing.assert_close(blk[True](x), blk[False](x), atol=1e-4, rtol=1e-4)
    assert fb.LAUNCHES == before + 1


@pytest.mark.cuda
def test_block_kernels_refuse_instead_of_falling_back(cuda_device):
    args = _args(1, 8, 4, 128, torch.float32)
    with pytest.raises(ValueError, match="stage1_attention"):
        s1.stage1_attention(*args, 0.125)  # C = 128
    blk = _block_args(1, 4, 4, 128, 200, torch.float32)
    with pytest.raises(ValueError, match="M <= 128"):
        fb.fused_block(*blk, 2, 0.125, 4, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hw,c", [(16, 96), (8, 192), (4, 384), (2, 768)])
def test_convnext_block_kernel_at_the_regress_paramnet_shapes(cuda_device, hw, c, dtype):
    """ParamNetConvNextRegress runs its ConvNeXt on the field nearest-resized
    to 64^2: stages of 16^2 ... 2^2, which fuse_convnext now reaches."""
    args = _cnx_args(4, hw, hw, c, dtype, seed=hw)
    before = cb.LAUNCHES
    got = cb.convnext_block(*args)
    torch.cuda.synchronize()
    assert cb.LAUNCHES == before + 1
    _assert_kernel_close(got, cb.convnext_block_reference(*[a.float() for a in args]), dtype)


def _tail_args(b, h, w, ca, cl, co, dtype, seed=0):
    """a, ll and the tail's weights in torch layouts, at the heads' init
    scales (1/sqrt(fan_in)) with biases of 0.1."""
    rng = np.random.default_rng(seed)
    shapes = [((b, h, w, ca), 1.0), ((b, h, w, cl), 1.0),
              ((64, ca + cl, 3, 3), (9 * (ca + cl)) ** -0.5), ((64,), 0.1),
              ((32, 64, 3, 3), (9 * 64) ** -0.5), ((32,), 0.1), ((co, 32, 1, 1), 32**-0.5),
              ((co,), 0.1)]
    return [_randn(rng, *s, scale=k, dtype=dtype) for s, k in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,ca,cl,co",
    [(2, 160, 160, 256, 64, 2), (2, 160, 160, 256, 64, 73), (1, 160, 160, 256, 64, 180),
     (2, 160, 160, 256, 64, 1), (3, 13, 9, 32, 8, 2), (3, 13, 9, 32, 8, 73)],
)
def test_decoder_tail_kernel_matches_plain_version(cuda_device, b, h, w, ca, cl, co, dtype):
    args = _tail_args(b, h, w, ca, cl, co, dtype, seed=co)
    before = dt.LAUNCHES
    got = dt.decoder_tail(*args)
    torch.cuda.synchronize()
    assert dt.LAUNCHES == before + 1
    assert got.shape == (b, 2 * h, 2 * w, co) and got.dtype == dtype
    _assert_kernel_close(got, dt.decoder_tail_reference(*[a.float() for a in args]), dtype)


# the bf16 decoder tail at every prediction width the kernel's 1x1 pads
# differently (one to three 64-column chunks, odd and even Co)
TAIL_COS = [1, 2, 8, 9, 73, 180, 192]


@pytest.mark.cuda
@pytest.mark.parametrize("co", TAIL_COS)
@pytest.mark.parametrize("b,h,w", [(3, 13, 9), (2, 1, 1), (1, 24, 30)])
def test_decoder_tail_kernel_on_ragged_maps_at_every_width(cuda_device, b, h, w, co):
    """bf16 on the wrapper's own plan: a 13x9 map whose every tile touches a
    border, a 1x1 map (the whole window is padding but one pixel), and a map
    the 8x10 tile does not divide."""
    args = _tail_args(b, h, w, 32, 8, co, torch.bfloat16, seed=co + h)
    before = dt.LAUNCHES
    got = dt.decoder_tail(*args)
    torch.cuda.synchronize()
    assert dt.LAUNCHES == before + 1
    _assert_kernel_close(got, dt.decoder_tail_reference(*[a.float() for a in args]), torch.bfloat16)


# (tile, cluster) of the bf16 decoder tail: the flagship's 8x10 tile and
# the planner's other shapes (the widest halo and fine-output counts, a
# single pixel), each at every multicast cluster
TAIL_TILES = [(8, 10), (6, 14), (14, 6), (9, 9), (1, 3), (1, 1), (2, 30)]


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("tile", TAIL_TILES)
def test_decoder_tail_kernel_at_every_tile_and_cluster(cuda_device, tile, cluster):
    """bf16 at forced tiles and clusters on a ragged 2x(19x23) map, grids
    smaller than the tiles (each block walks several, the last ones past
    the end redo the last tile and write nothing), Co = 73 and 2."""
    th, tw = tile
    for co in (73, 2):
        args = _tail_args(2, 19, 23, 64, 8, co, torch.bfloat16, seed=th * tw + cluster)
        tiles = dt.tiles_of(2, 19, 23, th, tw)
        blocks = max(cluster, min(tiles, 3 * cluster) // cluster * cluster)
        stages = 2 if th * tw > 1 else 3
        assert dt.smem_bytes(th, tw, co, stages) <= dt.SMEM_LIMIT
        got = dt.launch(*args, th, tw, cluster, blocks, stages)
        torch.cuda.synchronize()
        _assert_kernel_close(got, dt.decoder_tail_reference(*[a.float() for a in args]),
                             torch.bfloat16)


@pytest.mark.cuda
def test_decoder_tail_smem_count_matches_kernel(cuda_device):
    for th, tw in TAIL_TILES:
        for co in (1, 64, 65, 192):
            for stages in (2, 3):
                assert dt.smem_bytes(th, tw, co, stages) == dt.kernel_smem_bytes(th, tw, co, stages)


@pytest.mark.cuda
def test_decoder_tail_refuses_instead_of_falling_back(cuda_device):
    args = _tail_args(1, 8, 8, 256, 64, 2, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        dt.decoder_tail(*[a.half() for a in args])
    bad = list(args)
    bad[1] = args[1][..., :60].contiguous()  # Cl % 8 != 0
    bad[2] = torch.zeros(64, 316, 3, 3, device="cuda")
    with pytest.raises(ValueError, match="Cl % 8"):
        dt.decoder_tail(*bad)
    wide = _tail_args(1, 8, 8, 256, 64, 200, torch.float32)
    with pytest.raises(ValueError, match="Co"):
        dt.decoder_tail(*wide)


@pytest.mark.cuda
def test_fused_heads_match_plain_heads_on_the_card(cuda_device):
    """JAX's three head rewrites against the plain dataflow, f32, cuDNN
    with TF32 off; the tail kernel on the plain pyramid against both."""
    rng = np.random.default_rng(9)
    dims = (64, 128, 320, 512)
    hl = [_randn(rng, 2, 40 // 2**i, 40 // 2**i, d) for i, d in enumerate(dims)]
    ll = _randn(rng, 2, 80, 80, 64)
    dec = init_random_(SegFormerDecoder("gravity", 73, dims), seed=10).cuda().eval()
    with torch.inference_mode():
        fused = dec(hl, ll)
        dec.fuse_embed = dec.fuse_conv0 = dec.fuse_tail = False
        plain = dec(hl, ll)
        a = dec.pyramid(hl).contiguous()
        conv0, conv1, pred = dec.conv_fuse_conv0.conv, dec.conv_fuse_conv1.conv, dec.pred
        tail = dt.decoder_tail(a, ll, conv0.weight, conv0.bias, conv1.weight, conv1.bias,
                               pred.weight, pred.bias)
    assert fused.shape == plain.shape == tail.shape == (2, 160, 160, 73)
    torch.testing.assert_close(fused, plain, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(tail, plain, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- serving path

_SERVE_CFG = ModelConfig(
    version="custom",
    backbone=BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4)),
    gravity=GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    latitude=LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    param=ParamNetConfig(name="ParamNet"), recover_rpf=True, resize=(64, 64),
)


def _serve_model(**kw):
    sd = init_random_(PersNet(_SERVE_CFG), seed=0).state_dict()
    return PerspectiveFields("custom", config=_SERVE_CFG, params=sd, device="cuda", **kw)


def _serve_images(seed, n, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_wire", [None, "u8"])
def test_batch_predictor_on_a_side_stream_matches_the_default_stream(cuda_device, out_wire):
    model = _serve_model()
    imgs = _serve_images(0, 7)
    want = BatchPredictor(model, batch_size=3, out_wire=out_wire).predict(imgs)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = BatchPredictor(model, batch_size=3, depth=2, out_wire=out_wire).predict(imgs)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.cuda
def test_batch_predictor_outputs_were_on_the_card(cuda_device):
    model = _serve_model()
    bp = BatchPredictor(model, batch_size=2, wire="u8")
    devices = []
    fwd = bp._fwd

    def spy(x):
        out = fwd(x)
        devices.extend([x.device.type] + [v.device.type for v in out.values()])
        return out

    bp._fwd = spy
    outs = bp.predict(_serve_images(1, 3))
    assert len(outs) == 3 and devices and set(devices) == {"cuda"}
    assert bp._slots[0][0].is_pinned()
    assert all(v.dtype == np.float32 for v in outs[0].values())


@pytest.mark.cuda
def test_inference_batch_results_are_not_aliased_across_calls(cuda_device):
    model = _serve_model()
    for dp in (False, True):
        model.device_preprocess = dp
        first = model.inference_batch(_serve_images(2, 4, hw=(96, 80)))
        kept = [{k: np.array(v) for k, v in r.items()} for r in first]
        model.inference_batch(_serve_images(3, 4, hw=(96, 80)))
        for r, k in zip(first, kept):
            for key, val in k.items():
                np.testing.assert_array_equal(r[key], val, err_msg=key)


def _pinned_bytes():
    return torch.cuda.host_memory_stats()["allocated_bytes.current"]


@pytest.mark.cuda
def test_pinned_host_memory_is_held_only_by_what_callers_keep(cuda_device):
    """inference_batch hands out views of its pinned blocks, which go back to
    the caching host allocator when dropped; BatchPredictor copies its
    results out, so the pinned pool stays flat however many are kept."""
    model = _serve_model()
    imgs = _serve_images(5, 4, hw=(96, 80))
    model.inference_batch(imgs)
    held = _pinned_bytes()
    for _ in range(3):
        model.inference_batch(imgs)  # dropped: its blocks are reused
    assert _pinned_bytes() == held
    kept = model.inference_batch(imgs)
    fields = [v for r in kept for k, v in r.items() if k.startswith(("pred_gravity", "pred_latitude"))
              and isinstance(v, np.ndarray)]
    assert len(fields) == 16 and all(torch.from_numpy(v).is_pinned() for v in fields)
    streamed = []
    for out_wire in (None, "u8"):
        bp = BatchPredictor(model, batch_size=2, depth=2, out_wire=out_wire)
        # the first batches run eager and capture the forward's CUDA graph;
        # at replay speed the host runs up to ``depth`` batches ahead, and a
        # pinned block freed while later batches are in flight is reused only
        # once they finish, so the pool reaches its bound in a second stream
        bp.predict(_serve_images(6, 8))
        streamed += bp.predict(_serve_images(6, 8))
        held = _pinned_bytes()
        streamed += bp.predict(_serve_images(7, 8))
        assert _pinned_bytes() == held
    arrays = [v for r in streamed for v in r.values() if isinstance(v, np.ndarray)]
    assert len(arrays) == 64 and not any(torch.from_numpy(v).is_pinned() for v in arrays)


@pytest.mark.cuda
def test_device_resize_within_one_lsb_with_tf32_on(cuda_device):
    """The device 'pil_bilinear' resize is elementwise f32: the global TF32
    flags do not reach it."""
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
    model = _serve_model(device_preprocess=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        fn = image.make_resize((480, 640), (320, 320), "pil_bilinear", "cuda")
        got = fn(torch.from_numpy(imgs).cuda()).cpu().numpy()
        fused = image.make_fused_preprocess((480, 640), (320, 320), np.zeros(3), np.ones(3),
                                            torch.float32)(torch.from_numpy(imgs).cuda())
        model.inference_batch(list(imgs))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for i in range(2):
        exact = native.pil_resize_uint8(imgs[i], 320, 320).astype(np.float32)
        assert np.abs(np.round(got[i]) - exact).max() <= 1.0
        assert np.abs(np.round(fused[i].cpu().numpy()) - exact).max() <= 1.0
    cpu = image.make_resize((480, 640), (320, 320), "pil_bilinear", "cpu")(torch.from_numpy(imgs))
    np.testing.assert_allclose(got, cpu.numpy(), atol=1e-4)
    assert list(model._resize_cache._d) == [(480, 640)]


# ---------------------------------------------------------------------------
# the training and evaluation path on the card
# ---------------------------------------------------------------------------

GUARDED = {
    "fused_attention": lambda m, x: m.fused_attention(x, x, x, x, x, x, x, x, 1, 0.125),
    "stage1_attention": lambda m, x: m.stage1_attention(x, x, x, x, x, x, x, x, 0.125),
    "mixffn": lambda m, x: m.mixffn(x, x, x, x, x, x, x),
    "convnext_block": lambda m, x: m.convnext_block(x, x, x, x, x, x, x, x, x, x),
    "decoder_tail": lambda m, x: m.decoder_tail(x, x, x, x, x, x, x, x),
    "fused_block": lambda m, x: m.fused_block(x, x, x, x, x, x, x, x, x, x, x, x, x, x, x, x, x,
                                              1, 0.125, 1, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GUARDED))
def test_kernel_refuses_inputs_that_require_grad(cuda_device, name):
    """Under grad mode a CUDA input that requires grad raises before any
    launch: the kernels have no backward (F1)."""
    mod = importlib.import_module(f"perspectivefields_tpu_torch.kernels.{name}")
    x = torch.zeros(1, 4, 4, 64, device="cuda", requires_grad=True)
    before = mod.LAUNCHES
    with pytest.raises(RuntimeError, match="inference-only"):
        GUARDED[name](mod, x)
    assert mod.LAUNCHES == before


TINY = ModelConfig(
    version="custom",
    backbone=BackboneConfig(dims=(8, 16, 24, 32), depths=(1, 1, 1, 1), num_heads=(1, 2, 3, 4),
                            drop_path_rate=0.0),
    gravity=GravityHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    latitude=LatitudeHeadConfig(loss_type="regression", embed_dim=16, fusion_dim=16),
    param=ParamNetConfig(name="ParamNetConvNextRegress", predict_params=("roll", "pitch", "vfov"),
                         input_size=32),
    recover_rpf=True,
    resize=(64, 64),
)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """The --tiny trainer's f32 step on the card and on the CPU from the same
    weights and batch: the loss within 1e-5 relative, the clipped gradients
    within 1e-5 (their norm is 1), the parameters within 0.1 lr."""
    from perspectivefields_tpu_torch.data import make_step_batch_fn
    from perspectivefields_tpu_torch.train import create_train_state, make_train_step

    sd = init_random_(PersNet(TINY), seed=0).state_dict()
    for key in ("weight", "bias"):
        sd[f"persformer_heads.latitude_head.linear_pred_latitude.{key}"] *= 0.01
    batch = make_step_batch_fn(0, batch_size=2, im_hw=(64, 64), device="cpu")(0)
    batch = {k: v for k, v in batch.items() if k != "cams"}
    batch["image"] = batch["image"] - torch.tensor(TINY.pixel_mean)
    out = {}
    for dev in ("cpu", "cuda"):
        net = PersNet(TINY).to(dev)
        net.load_state_dict(sd)
        state = create_train_state(net, learning_rate=1e-4)
        state, m = make_train_step(TINY)(state, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(m["loss"]), {n: p.grad.cpu() for n, p in net.named_parameters()},
                    {n: p.detach().cpu() for n, p in net.named_parameters()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for n, g in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][n], g, rtol=0, atol=1e-5, msg=n)
        torch.testing.assert_close(out["cuda"][2][n], out["cpu"][2][n], rtol=0, atol=1e-5, msg=n)


@pytest.mark.cuda
def test_evaluate_pairs_on_the_card_matches_the_cpu(cuda_device):
    """evaluate_pairs of the --tiny model (f32, no kernels at these widths)
    on the card and on the CPU over the same batches: within 1e-3 degrees."""
    import warnings

    from perspectivefields_tpu_torch.data import make_step_batch_fn
    from perspectivefields_tpu_torch.evaluation import evaluate_pairs

    sd = init_random_(PersNet(TINY), seed=0).state_dict()
    fn = make_step_batch_fn(1, batch_size=3, im_hw=(64, 64), device="cpu")
    batches = [fn(i) for i in range(3)]
    res = {}
    for dev in ("cpu", "cuda"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = PerspectiveFields("custom", config=TINY, params=sd, device=dev)
        res[dev] = evaluate_pairs(model, batches)
    assert res["cuda"]["samples"] == res["cpu"]["samples"] == 9
    for k, v in res["cpu"].items():
        assert res["cuda"][k] == pytest.approx(v, abs=1e-3), k


# ------------------------------------------------- the forward's CUDA graphs

_FLAGSHIP = "Paramnet-360Cities-edina-centered"


@functools.lru_cache(maxsize=None)
def _flagship_state(seed: int) -> dict:
    from perspectivefields_tpu_torch.config import model_zoo

    return init_random_(PersNet(model_zoo[_FLAGSHIP]["config"]), seed=seed).state_dict()


def _flagship(dtype, seed=0, **flags):
    """The flagship PersNet on the card, eval, random weights from ``seed``;
    bf16 on the attention kernels' route, as ``PerspectiveFields`` builds it."""
    from perspectivefields_tpu_torch.config import model_zoo

    model = PersNet(model_zoo[_FLAGSHIP]["config"], use_kernels=dtype == torch.bfloat16, **flags)
    model.load_state_dict(_flagship_state(seed))
    return model.to("cuda", dtype).eval()


def _images(b, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(b, 320, 320, 3, device="cuda", generator=g).to(dtype)


def _graph_counts():
    return graphed.REPLAYS, graphed.CAPTURES, dict(graphed.EAGER)


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 32])
def test_graph_replay_is_bit_identical_to_eager(cuda_device, b, dtype):
    """The flagship's graph replays give the eager forward's outputs bit for
    bit, and a result kept from one call is not written by the next."""
    model = _flagship(dtype)
    x, y = _images(b, dtype, 0), _images(b, dtype, 1)
    with torch.inference_mode():
        want_x, want_y = model._eager_forward(x), model._eager_forward(y)
        replays, captures, _ = _graph_counts()
        outs = [model(x) for _ in range(3)]  # eager, captured and replayed, replayed
        kept = {k: v.clone() for k, v in outs[2].items()}
        got_y = model(y)
        torch.cuda.synchronize()
    assert (graphed.REPLAYS - replays, graphed.CAPTURES - captures) == (3, 1)
    for out in outs:
        _assert_equal(out, want_x)
    _assert_equal(got_y, want_y)
    _assert_equal(outs[2], kept)


@pytest.mark.cuda
def test_graph_replay_on_the_fused_block_route_is_bit_identical(cuda_device):
    model = _flagship(torch.bfloat16, fuse_block=True)
    x = _images(2, torch.bfloat16, 2)
    before = {name: mod.LAUNCHES for name, mod in (("s1", s1), ("fa", fa), ("fb", fb))}
    with torch.inference_mode():
        want = model._eager_forward(x)
        eager = {name: mod.LAUNCHES - before[name] for name, mod in (("s1", s1), ("fa", fa), ("fb", fb))}
        outs = [model(x) for _ in range(3)]
    assert eager == {"s1": 3, "fa": 4, "fb": 21}
    for out in outs:
        _assert_equal(out, want)


@pytest.mark.cuda
def test_an_in_place_weight_load_is_read_by_the_next_replay(cuda_device):
    model = _flagship(torch.bfloat16)
    x = _images(1, torch.bfloat16, 3)
    with torch.inference_mode():
        model(x)
        old = model(x)
        replays, captures, _ = _graph_counts()
        model.load_state_dict(_flagship_state(1))  # copied into the same storage
        got = model(x)
        want = model._eager_forward(x)
    assert (graphed.REPLAYS - replays, graphed.CAPTURES - captures) == (1, 0)
    _assert_equal(got, want)
    assert not torch.equal(got["pred_gravity"], old["pred_gravity"])


@pytest.mark.cuda
def test_kernel_launches_count_the_same_under_replay_as_eager(cuda_device):
    model = _flagship(torch.bfloat16)
    x = _images(1, torch.bfloat16, 4)
    kernels = {"fa": fa, "mf": mf, "cb": cb, "fb": fb, "s1": s1, "dt": dt}

    def launched(fn):
        before = {k: m.LAUNCHES for k, m in kernels.items()}
        fn()
        return {k: m.LAUNCHES - before[k] for k, m in kernels.items()}

    with torch.inference_mode():
        eager = launched(lambda: model._eager_forward(x))
        model(x)
        model(x)
        replays = graphed.REPLAYS
        replayed = launched(lambda: model(x))
    assert graphed.REPLAYS == replays + 1
    assert eager == replayed == {"fa": 25, "mf": 0, "cb": 0, "fb": 0, "s1": 0, "dt": 0}


@pytest.mark.cuda
def test_a_forward_hook_still_fires_because_the_call_runs_eager(cuda_device):
    model = _flagship(torch.bfloat16)
    x = _images(1, torch.bfloat16, 5)
    fired = []
    with torch.inference_mode():
        model(x)
        model(x)  # captured
        handle = model.backbone.register_forward_hook(lambda *a: fired.append(1))
        replays, captures, eager = _graph_counts()
        outs = [model(x) for _ in range(3)]
        handle.remove()
        want = model._eager_forward(x)
    assert len(fired) == 3
    assert (graphed.REPLAYS, graphed.CAPTURES) == (replays, captures)
    assert graphed.EAGER["hooks"] - eager.get("hooks", 0) == 3
    for out in outs:
        _assert_equal(out, want)


@pytest.mark.cuda
def test_a_failed_capture_stays_eager_and_the_card_keeps_working(cuda_device, monkeypatch):
    """A submodule that synchronizes cannot be captured: the call warns,
    answers eager, and the signature stays eager; another signature of the
    repaired model captures and replays."""
    model = _flagship(torch.bfloat16)
    x = _images(1, torch.bfloat16, 6)
    inner = model.ll_enc.forward

    def synchronizing(*args):
        torch.cuda.synchronize()
        return inner(*args)

    monkeypatch.setattr(graphed, "_warned", False)
    model.ll_enc.forward = synchronizing
    failures = graphed.CAPTURE_FAILURES
    with torch.inference_mode():
        want = model._eager_forward(x)
        with pytest.warns(RuntimeWarning, match="capture of the forward failed"):
            outs = [model(x) for _ in range(3)]
        assert torch.cuda.current_stream() == torch.cuda.default_stream()
        del model.ll_enc.forward
        replays = graphed.REPLAYS
        x2 = _images(2, torch.bfloat16, 7)
        got2 = [model(x2) for _ in range(3)]
        want2 = model._eager_forward(x2)
    assert graphed.CAPTURE_FAILURES == failures + 1
    assert graphed.REPLAYS == replays + 2
    for out in outs:
        _assert_equal(out, want)
    for out in got2:
        _assert_equal(out, want2)


@pytest.mark.cuda
def test_a_call_inside_a_callers_capture_runs_eager_into_it(cuda_device):
    model = _flagship(torch.bfloat16)
    x = _images(1, torch.bfloat16, 8)
    with torch.inference_mode():
        model(x)
        model(x)
        want = model._eager_forward(x)
        g = torch.cuda.CUDAGraph()
        capturing = graphed.EAGER["capturing"]
        with torch.cuda.graph(g):
            out = model(x)
        g.replay()
        torch.cuda.synchronize()
    assert graphed.EAGER["capturing"] == capturing + 1
    _assert_equal(out, want)


@pytest.mark.cuda
def test_flipping_the_heads_rewrites_captures_their_route_and_flipping_back_replays(cuda_device):
    """The heads' three rewrites are plain attributes the forward reads: off
    on a built model, the calls answer the plain dataflow's outputs (eager,
    then its own graph), not the rewrites' graph; on again, that graph
    replays without a capture."""
    model = _flagship(torch.bfloat16)
    heads = list(model.persformer_heads.values())
    flags = ("fuse_embed", "fuse_conv0", "fuse_tail")
    x = _images(1, torch.bfloat16, 9)

    def set_flags(on):
        for head in heads:
            for flag in flags:
                setattr(head, flag, on)

    with torch.inference_mode():
        want = model._eager_forward(x)
        model(x)
        model(x)  # captured with the rewrites on
        replays, captures, eager = _graph_counts()
        set_flags(False)
        want_plain = model._eager_forward(x)
        plain = [model(x) for _ in range(3)]  # eager, captured and replayed, replayed
        set_flags(True)
        back = [model(x) for _ in range(2)]
        torch.cuda.synchronize()
    assert (graphed.REPLAYS - replays, graphed.CAPTURES - captures) == (4, 1)
    assert graphed.EAGER["first_sight"] - eager.get("first_sight", 0) == 1
    assert not torch.equal(want_plain["pred_gravity"], want["pred_gravity"])  # two routes
    for out in plain:
        _assert_equal(out, want_plain)
    for out in back:
        _assert_equal(out, want)


@pytest.mark.cuda
def test_two_threads_calling_one_model_each_get_their_own_result(cuda_device):
    """Two host threads call one model at once, from the first sight of the
    signature on: each gets its own images' outputs, bit for bit."""
    import threading

    model = _flagship(torch.bfloat16)
    xs = [_images(1, torch.bfloat16, 10 + i) for i in range(2)]
    with torch.inference_mode():
        wants = [model._eager_forward(x) for x in xs]
    torch.cuda.synchronize()
    got, errors = [[], []], []
    start = threading.Barrier(2)

    def run(i):
        try:
            start.wait()
            with torch.inference_mode():
                got[i] = [model(xs[i]) for _ in range(12)]
            torch.cuda.synchronize()
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    replays, captures, _ = _graph_counts()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert graphed.CAPTURES - captures == 1 and graphed.REPLAYS - replays >= 20
    for i in range(2):
        assert len(got[i]) == 12
        for out in got[i]:
            _assert_equal(out, wants[i])
