"""The port's decoder tail against the JAX package's kernel.

On the CPU the port's plain version (``decoder_tail_reference``) is held
against JAX's Pallas kernel run in interpret mode and against its XLA
oracle ``xla_decoder_tail``, in float32, on tests/test_decoder_tail.py's
shapes; JAX's HWIO kernels go through the HWIO -> OIHW transpose. The CUDA
kernel itself runs only on a card: see tests/test_torch_cuda.py and
``python3 chip_smoke.py``.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu.kernels.decoder_tail import decoder_tail as jax_decoder_tail
from perspectivefields_tpu.kernels.decoder_tail import xla_decoder_tail
from perspectivefields_tpu_torch import kernels
from perspectivefields_tpu_torch.kernels import build as build_mod
from perspectivefields_tpu_torch.kernels import hopper_plan as hp
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.models.heads import SegFormerDecoder

# the package exports the function decoder_tail under its module's name
dt = importlib.import_module("perspectivefields_tpu_torch.kernels.decoder_tail")


def _mk(b=2, h=32, w=24, ca=12, cl=6, c0=8, c1=4, co=2, seed=0):
    """tests/test_decoder_tail.py's inputs: numpy, JAX layouts (HWIO)."""
    r = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (r.normal(size=shape) * s).astype(np.float32)

    return dict(a=n(b, h, w, ca), ll=n(b, h, w, cl), w0=n(3, 3, ca + cl, c0, s=0.2), b0=n(c0),
                w1=n(3, 3, c0, c1, s=0.2), b1=n(c1), wp=n(1, 1, c1, co, s=0.5), bp=n(co))


def _torch_args(kw, device="cpu", dtype=torch.float32):
    """The same inputs in torch layouts: conv kernels OIHW."""
    t = {k: torch.tensor(v, device=device, dtype=dtype) for k, v in kw.items()}
    for k in ("w0", "w1", "wp"):
        t[k] = t[k].permute(3, 2, 0, 1).contiguous()
    return [t[k] for k in ("a", "ll", "w0", "b0", "w1", "b1", "wp", "bp")]


def _jax(kw, **opts):
    return np.asarray(jax_decoder_tail(**{k: jnp.asarray(v) for k, v in kw.items()}, **opts))


@pytest.mark.parametrize("tile_rows", [8, 16, 32])
def test_reference_matches_jax_kernel_interpret(tile_rows):
    kw = _mk()
    got = dt.decoder_tail_reference(*_torch_args(kw)).numpy()
    want = _jax(kw, tile_rows=tile_rows, interpret=True)
    assert got.shape == want.shape == (2, 64, 48, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_reference_matches_jax_kernel_single_tile():
    kw = _mk(h=16, w=16)
    np.testing.assert_allclose(dt.decoder_tail_reference(*_torch_args(kw)).numpy(),
                               _jax(kw, tile_rows=16, interpret=True), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "shape", [dict(), dict(h=16, w=16), dict(co=73, h=8, w=6), dict(co=1, h=5, w=7, b=1)],
    ids=["32x24", "16x16", "co73", "ragged_co1"],
)
def test_reference_matches_xla_oracle(shape):
    kw = _mk(seed=3, **shape)
    want = np.asarray(xla_decoder_tail(**{k: jnp.asarray(v) for k, v in kw.items()}))
    np.testing.assert_allclose(dt.decoder_tail_reference(*_torch_args(kw)).numpy(), want,
                               atol=1e-4, rtol=1e-4)


def test_reference_matches_jax_kernel_at_73_classes():
    kw = _mk(h=16, w=8, co=73, seed=4)
    np.testing.assert_allclose(dt.decoder_tail_reference(*_torch_args(kw)).numpy(),
                               _jax(kw, tile_rows=8, interpret=True), atol=1e-4, rtol=1e-4)


def test_reference_rounds_at_the_kernels_points_in_bf16():
    """In bf16 the plain version rounds conv0's and conv1's ReLU outputs,
    the upsample and the prediction once each, from f32 arithmetic."""
    kw = _mk(seed=5)
    args = _torch_args(kw, dtype=torch.bfloat16)
    got = dt.decoder_tail_reference(*args)
    assert got.dtype == torch.bfloat16
    want = dt.decoder_tail_reference(*[a.float() for a in args])
    assert (got.float() - want).abs().max() / want.abs().max() <= 1e-2


def test_package_exports_the_function():
    assert kernels.decoder_tail is dt.decoder_tail


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    args = _torch_args(_mk(seed=6))
    before = dt.LAUNCHES
    assert torch.equal(kernels.decoder_tail(*args), dt.decoder_tail_reference(*args))
    assert dt.LAUNCHES == before


def test_wrapper_raises_on_a_device_without_kernel():
    args = _torch_args(_mk(ca=16, cl=8, c0=64, c1=32, seed=7), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        dt.decoder_tail(*args)


def test_heads_own_weights_go_straight_in():
    """The head's conv0 / conv1 / prediction parameters, as they are, into
    the wrapper: the plain-dataflow head's output, from its pyramid."""
    rng = np.random.default_rng(8)
    dims = (16, 24, 32, 40)
    hl = [torch.tensor(rng.normal(size=(2, 8 // 2**i, 8 // 2**i, d)), dtype=torch.float32)
          for i, d in enumerate(dims)]
    ll = torch.tensor(rng.normal(size=(2, 16, 16, 64)), dtype=torch.float32)
    dec = init_random_(SegFormerDecoder("latitude", 3, dims, embed_dim=32, fusion_dim=32), seed=9)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1)
        dec.fuse_embed = dec.fuse_conv0 = dec.fuse_tail = False
        want = dec.eval()(hl, ll)
        a = dec.pyramid(hl)
        conv0, conv1, pred = dec.conv_fuse_conv0.conv, dec.conv_fuse_conv1.conv, dec.pred
        args = (a, ll, conv0.weight, conv0.bias, conv1.weight, conv1.bias, pred.weight, pred.bias)
        dt.check_kernel_args(*args)
        got = kernels.decoder_tail(*args)
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def _bad_case(name):
    args = _torch_args(_mk(b=1, h=5, w=4, ca=16, cl=8, c0=64, c1=32, co=2, seed=10))
    if name == "channels_not_8":
        args = _torch_args(_mk(b=1, h=5, w=4, ca=12, cl=8, c0=64, c1=32, seed=10))
    elif name == "conv0_width":
        args = _torch_args(_mk(b=1, h=5, w=4, ca=16, cl=8, c0=32, c1=32, seed=10))
    elif name == "too_many_classes":
        args = _torch_args(_mk(b=1, h=5, w=4, ca=16, cl=8, c0=64, c1=32, co=193, seed=10))
    elif name == "float16":
        args = [a.half() for a in args]
    elif name == "mixed_dtype":
        args[1] = args[1].to(torch.bfloat16)
    elif name == "non_contiguous":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif name == "ll_size":
        args[1] = args[1][:, :4].contiguous()
    elif name == "bias_shape":
        args[3] = args[3][:32].contiguous()
    elif name == "misaligned":  # a contiguous view 4 bytes into its storage
        args[0] = torch.zeros(5 * 4 * 16 + 1)[1:].view(1, 5, 4, 16)
    elif name == "bf16_ca_not_32":  # ll's channels must start a k-block of the TMA window
        args = [a.to(torch.bfloat16) for a in args]
    return args


@pytest.mark.parametrize(
    "name",
    ["channels_not_8", "conv0_width", "too_many_classes", "float16", "mixed_dtype",
     "non_contiguous", "ll_size", "bias_shape", "misaligned", "bf16_ca_not_32"],
)
def test_kernel_arg_check_refuses(name):
    with pytest.raises(ValueError):
        dt.check_kernel_args(*_bad_case(name))


def test_kernel_arg_check_takes_the_heads_shapes():
    for co in (2, 1, 73, 180):
        args = _torch_args(_mk(b=1, h=4, w=4, ca=256, cl=64, c0=64, c1=32, co=co))
        dt.check_kernel_args(*args)
        args[6] = args[6].reshape(co, 32)  # the 1x1 weight as a matrix
        dt.check_kernel_args(*args)


# the planner: (b, h, w) coarse maps, the heads' widths and ragged ones
PLAN_MAPS = [(8, 160, 160, 256, 64), (32, 160, 160, 256, 64), (3, 13, 9, 32, 8),
             (2, 1, 1, 32, 8), (1, 24, 30, 64, 8), (5, 7, 200, 256, 64)]


@pytest.mark.parametrize("b,h,w,ca,cl", PLAN_MAPS)
def test_plan_tiles_cover_the_map(b, h, w, ca, cl):
    """The tile fits the kernel (a halo of at most 128 pixels, at most 384
    fine outputs), the tiles cover the map, the persistent grid is a
    multiple of the cluster and walks every tile in as few steps as it can,
    and multicast adds no step over single blocks."""
    for co in (1, 2, 73, 180, 192):
        p = dt.plan(b, h, w, ca, cl, co)
        th, tw = p["tile"]
        assert (th + 2) * (tw + 2) <= dt.MAX_HALO and 4 * th * tw <= dt.MAX_FINE
        tiles = dt.tiles_of(b, h, w, th, tw)
        assert -(-h // th) * th >= h and -(-w // tw) * tw >= w and tiles == b * -(-h // th) * -(-w // tw)
        assert p["blocks"] % p["cluster"] == 0 and p["blocks"] <= 132
        assert p["blocks"] * p["iters"] >= tiles > p["blocks"] * (p["iters"] - 1)
        assert p["iters"] == -(-tiles // min(132, tiles))
        assert 2 <= p["stages"] <= hp.MAX_STAGES


@pytest.mark.parametrize("b,h,w,ca,cl", PLAN_MAPS)
def test_plan_fits_shared_memory_at_every_width(b, h, w, ca, cl):
    for co in range(1, dt.MAX_CO + 1):
        p = dt.plan(b, h, w, ca, cl, co)
        assert p["smem"] == dt.smem_bytes(*p["tile"], co, p["stages"]) <= hp.SMEM_LIMIT
        assert dt.smem_bytes(*p["tile"], co, p["stages"] + 1) > hp.SMEM_LIMIT or p["stages"] == hp.MAX_STAGES


@pytest.mark.parametrize("co", [2, 1, 73, 180])
def test_plan_at_the_flagship(co):
    """PERF.md's plan at the heads' 160x160 grid, B=8: 8x10 tiles (2,560)
    over 128 persistent blocks in clusters of 8 (the card may run fewer),
    20 tiles each, a ring of 2 stages; w0 read once per cluster and step."""
    p = dt.plan(8, 160, 160, 256, 64, co)
    assert (p["tile"], p["cluster"], p["blocks"], p["iters"], p["stages"]) == ((8, 10), 8, 128, 20, 2)
    w0 = 9 * 64 * 320 * 2
    assert p["weight_bytes"] == 16 * 20 * w0 + 128 * (dt.W1_BYTES + -(-co // 64) * 64 * 32 * 2)
    # cluster counts a card may report: at most 12 clusters of 8 would add a step
    fits = ((8, 12), (4, 33), (2, 66), (1, 132))
    assert dt.plan(8, 160, 160, 256, 64, co, 132, fits)["cluster"] == 4
    # the H100's own counts at this tile (PERF.md): clusters of 2, 132 blocks x 20 tiles
    p = dt.plan(8, 160, 160, 256, 64, co, 132, ((8, 15), (4, 30), (2, 66), (1, 132)))
    assert (p["tile"], p["cluster"], p["blocks"], p["iters"]) == ((8, 10), 2, 132, 20)


def test_plan_counts_weight_bytes_per_cluster():
    """Single blocks read w0 once per tile walked; a cluster of k once per k."""
    one = dt.plan(8, 160, 160, 256, 64, 2, 132, ((8, 0), (4, 0), (2, 0), (1, 132)))
    assert one["cluster"] == 1 and one["blocks"] == 132 and one["iters"] == 20
    assert one["weight_bytes"] == 132 * 20 * 9 * 64 * 320 * 2 + 132 * (dt.W1_BYTES + 64 * 32 * 2)


def test_plan_refuses_too_many_classes():
    with pytest.raises(ValueError, match="Co"):
        dt.plan(1, 8, 8, 32, 8, dt.MAX_CO + 1)


def test_smem_counts_the_layout():
    """TailLayout at the flagship's tile: 2 stages of w0's 9 tap tiles (36
    KB) and the 12x14 window (11 KB), w1 (36 KB), wp, u (18x22 pixels x 64
    channels, two 25 KB k-blocks), c0 (128 rows of 144 bytes), biases,
    the upsample's tables, barriers and the base's alignment."""
    assert dt.smem_bytes(8, 10, 2) == 2 * (36864 + 11264) + 36864 + 4096 + 2 * 25600 + 18432 + (
        64 + 32 + 64) * 4 + 2 * 96 * 16 + 5 * 8 + 1024


def test_phase_stamps_are_named():
    """Every PF_STAMP id in the kernel's source has a name in chip_smoke.py
    --phases' table, and every named id is stamped."""
    import chip_smoke

    src = (build_mod.CSRC / "decoder_tail.cu").read_text()
    ids = {int(i) for i in re.findall(r"PF_STAMP\((\d+)\)", src)}
    ids |= {int(i) + 10 * j for i in re.findall(r"PF_STAMP_STEP\((\d+),", src) for j in range(8)}
    assert ids == set(chip_smoke.PHASE_NAMES["decoder_tail"])
