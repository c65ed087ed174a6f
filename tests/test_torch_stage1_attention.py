"""The port's stage-1 attention module against the JAX package's kernel.

On the CPU the port's plain version (``stage1_attention_reference``) is held
against JAX's lane-packed Pallas kernel run in interpret mode and against
its XLA oracle, in float32, on the JAX test's shapes; the gate and the
wrapper are checked here. The CUDA kernel itself runs only on a card: see
tests/test_torch_cuda.py and ``python3 chip_smoke.py``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu.kernels.fused_attention import _xla_reference
from perspectivefields_tpu.kernels.stage1_attention import stage1_attention as jax_stage1
from perspectivefields_tpu_torch.kernels import build as build_mod
from perspectivefields_tpu_torch.kernels import hopper_plan as hp
from perspectivefields_tpu_torch.kernels import stage1_attention as s1
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.models.mit import SRAttention

CUDA = torch.device("cuda")


def _inputs(rng, b, n, m, c=64):
    """numpy inputs scaled as in tests/test_stage1_attention.py; weights in
    the JAX layout (in, out)."""
    return dict(
        x=rng.normal(size=(b, n, c)).astype(np.float32),
        kv_in=rng.normal(size=(b, m, c)).astype(np.float32),
        wq=(rng.normal(size=(c, c)) * 0.05).astype(np.float32),
        bq=(rng.normal(size=(c,)) * 0.01).astype(np.float32),
        wkv=(rng.normal(size=(c, 2 * c)) * 0.05).astype(np.float32),
        bkv=(rng.normal(size=(2 * c,)) * 0.01).astype(np.float32),
        wproj=(rng.normal(size=(c, c)) * 0.05).astype(np.float32),
        bproj=(rng.normal(size=(c,)) * 0.01).astype(np.float32),
    )


def _torch_args(kw, device="cpu", dtype=torch.float32):
    """The same inputs for the port: weights transposed to nn.Linear's
    (out, in) layout."""
    t = {k: torch.tensor(v, device=device, dtype=dtype) for k, v in kw.items()}
    for w in ("wq", "wkv", "wproj"):
        t[w] = t[w].t().contiguous()
    return [t[k] for k in ("x", "kv_in", "wq", "bq", "wkv", "bkv", "wproj", "bproj")]


@pytest.mark.parametrize("with_residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize(
    "b,n,m",
    [(1, 32, 16), (2, 64, 5), (4, 128, 100), (1, 6400, 100)],  # tests/test_stage1_attention.py:39-46
)
def test_reference_matches_jax_kernel(b, n, m, with_residual):
    rng = np.random.default_rng(b * 1000 + n + m)
    kw = _inputs(rng, b, n, m)
    res = rng.normal(size=(b, n, 64)).astype(np.float32) if with_residual else None
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jres = None if res is None else jnp.asarray(res)
    want_kernel = jax_stage1(scale=64**-0.5, interpret=True, residual=jres, **jkw)
    want_xla = _xla_reference(num_heads=1, scale=64**-0.5, **jkw)
    if jres is not None:
        want_xla = jres + want_xla
    got = s1.stage1_attention_reference(
        *_torch_args(kw), 64**-0.5, residual=None if res is None else torch.from_numpy(res)
    ).numpy()
    # f32 on the CPU: the two frameworks differ only in summation order
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want_xla), atol=2e-5, rtol=1e-5)


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    args = _torch_args(_inputs(np.random.default_rng(3), 2, 37, 9))
    before = s1.LAUNCHES
    assert torch.equal(s1.stage1_attention(*args, 0.125), s1.stage1_attention_reference(*args, 0.125))
    assert s1.LAUNCHES == before


def test_wrapper_raises_on_a_device_without_kernel():
    args = _torch_args(_inputs(np.random.default_rng(4), 1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        s1.stage1_attention(*args, 0.125)


def _bad_case(name):
    rng = np.random.default_rng(5)
    args, residual = _torch_args(_inputs(rng, 1, 8, 4)), None
    if name == "channels_128":
        args = _torch_args(_inputs(rng, 1, 8, 4, c=128))
    elif name == "too_many_keys":
        args[1] = torch.zeros(1, 129, 64)
    elif name == "float16":
        args = [a.half() for a in args]
    elif name == "mixed_dtype":
        args[2] = args[2].to(torch.bfloat16)
    elif name == "non_contiguous":
        args[2] = args[2].t()
    elif name == "wkv_shape":
        args[4] = torch.zeros(64, 128)
    elif name == "residual_shape":
        residual = torch.zeros(1, 7, 64)
    elif name == "misaligned":  # a contiguous view 4 bytes into its storage
        args[0] = torch.zeros(8 * 64 + 1)[1:].view(1, 8, 64)
    return args, residual


@pytest.mark.parametrize(
    "name",
    ["channels_128", "too_many_keys", "float16", "mixed_dtype", "non_contiguous", "wkv_shape",
     "residual_shape", "misaligned"],
)
def test_kernel_arg_check_refuses(name):
    args, residual = _bad_case(name)
    with pytest.raises(ValueError):
        s1.check_kernel_args(*args, residual)


def test_kernel_arg_check_accepts_stage1_and_ragged_shapes():
    for b, n, m in [(8, 6400, 100), (3, 999, 37), (1, 1, 1)]:
        args = _torch_args(_inputs(np.random.default_rng(6), b, 1, m))
        args[0] = torch.zeros(b, n, 64)
        s1.check_kernel_args(*args, torch.zeros(b, n, 64))


@pytest.mark.parametrize(
    "use_kernels,fuse_block,n,c,heads,m,device,want",
    [
        (True, True, 6400, 64, 1, 100, CUDA, True),     # MiT-b3 stage 1 at 320^2
        (True, False, 6400, 64, 1, 100, CUDA, False),   # only with fuse_block
        (False, True, 6400, 64, 1, 100, CUDA, False),   # only with use_kernels
        (True, True, 6400, 64, 1, 100, torch.device("cpu"), False),
        (True, True, 2048, 64, 1, 100, CUDA, False),    # fused_attention's tokens
        (True, True, 6400, 128, 2, 100, CUDA, False),   # two heads
        (True, True, 6400, 128, 1, 100, CUDA, False),   # C != 64
        (True, True, 6400, 64, 1, 129, CUDA, False),    # keys
    ],
)
def test_gate(use_kernels, fuse_block, n, c, heads, m, device, want):
    assert s1.use_kernel(use_kernels, fuse_block, True, n, c, heads, m, device) is want
    assert not s1.use_kernel(use_kernels, fuse_block, False, n, c, heads, m, device)  # no bias


def test_sr_attention_routes_stage1_to_the_kernel_only_on_cuda():
    x = torch.tensor(np.random.default_rng(7).normal(size=(1, 48, 48, 64)), dtype=torch.float32)
    mods = {f: init_random_(SRAttention(64, 1, 8, use_kernels=True, fuse_block=f), seed=1)
            for f in (True, False)}
    assert mods[True].route(48 * 48, 36, CUDA) == "stage1_attention"
    assert mods[False].route(48 * 48, 36, CUDA) == "plain"
    assert mods[True].route(48 * 48, 36, x.device) == "plain"
    with torch.no_grad():  # on the CPU both run the plain path, same numbers
        assert torch.equal(mods[True](x), mods[False](x))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build_mod, "find_nvcc", lambda: None)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build_mod.build("stage1_attention")


@pytest.mark.parametrize("b", [1, 2, 3, 8, 32, 200])
@pytest.mark.parametrize("n", [1, 63, 64, 999, 6400, 6401])
def test_plan_covers_every_tile(b, n):
    """Each image's 64-row tiles are shared out in runs, one run per
    consumer warpgroup (two a block): the runs cover the image, no block
    is without a tile, the grid stays within the SMs where the batch
    allows, and no smaller run would fit them."""
    p = s1.plan(b, n)
    g, t = p["blocks_per_image"], p["tiles_per_group"]
    per_image = -(-n // 64)
    assert p["blocks"] == b * g and 2 * g * t >= per_image > (2 * g - 2) * t
    assert p["blocks"] <= max(132, b)
    most = max(1, min(per_image, 132 // b))
    assert t == min(s1.unit_tiles(n, k) for k in range(1, most + 1))


@pytest.mark.parametrize("m", range(1, 129))
def test_shared_memory_fits_at_every_key_count(m):
    """The block pads the keys to 128, so its shared memory is one size for
    every M the kernel takes, within the card's limit."""
    args = _torch_args(_inputs(np.random.default_rng(m), 1, 1, m))
    s1.check_kernel_args(*args)
    assert s1.plan(8, 6400)["smem"] == s1.smem_bytes() <= hp.SMEM_LIMIT


def test_plan_at_the_flagship():
    """PERF.md's plan: B=8 (N = 6400, 100 tiles an image) takes 13 blocks an
    image, 4 tiles a warpgroup; B=32 4 blocks an image, 13 tiles; each block
    reads the weights (32 KB) and its image's kv_in (16 KB) once."""
    p8, p32 = s1.plan(8, 6400), s1.plan(32, 6400)
    assert (p8["blocks_per_image"], p8["tiles_per_group"], p8["blocks"]) == (13, 4, 104)
    assert (p32["blocks_per_image"], p32["tiles_per_group"], p32["blocks"]) == (4, 13, 128)
    assert p8["weight_bytes"] == 104 * (32768 + 16384)


def test_phase_stamps_are_named():
    """Every PF_STAMP id in the kernel's source has a name in chip_smoke.py
    --phases' table, and every named id is stamped."""
    import chip_smoke

    src = (build_mod.CSRC / "stage1_attention.cu").read_text()
    ids = {int(i) for i in re.findall(r"PF_STAMP\((\d+)\)", src)}
    ids |= {int(i) + 10 * j for i in re.findall(r"PF_STAMP_STEP\((\d+),", src) for j in range(8)}
    assert ids == set(chip_smoke.PHASE_NAMES["stage1_attention"])
