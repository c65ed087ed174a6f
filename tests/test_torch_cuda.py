"""GPU tests of the port's CUDA kernels (marker ``cuda``; they skip without
an NVIDIA GPU). This file imports no JAX, so it runs on a machine without
it: ``python -m pytest tests/test_torch_cuda.py --noconftest -q`` (the
repository's conftest imports JAX)."""

import importlib

import numpy as np
import pytest
import torch

from perspectivefields_tpu_torch.kernels import convnext_block as cb
from perspectivefields_tpu_torch.kernels import fused_attention as fa
from perspectivefields_tpu_torch.kernels import fused_block as fb
from perspectivefields_tpu_torch.kernels import mixffn as mf
from perspectivefields_tpu_torch.kernels import stage1_attention as s1
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.models.convnext import ConvNeXtBlock
from perspectivefields_tpu_torch.models.heads import SegFormerDecoder
from perspectivefields_tpu_torch.models.mit import Block, MixFFN, SRAttention

# the package exports the function decoder_tail under its module's name
dt = importlib.import_module("perspectivefields_tpu_torch.kernels.decoder_tail")


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
