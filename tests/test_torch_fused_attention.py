"""The port's fused SR-attention module against the JAX package's kernel.

On the CPU the port's plain version (``fused_attention_reference``) is held
against JAX's Pallas kernel body run in interpret mode and against its XLA
oracle, in float32. The CUDA kernel itself runs only on a card: see
tests/test_torch_cuda.py and ``python3 chip_smoke.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu.kernels.fused_attention import (
    _xla_reference,
    fused_attention as jax_fused_attention,
)
from perspectivefields_tpu_torch.kernels import build as build_mod
from perspectivefields_tpu_torch.kernels import fused_attention as fa
from perspectivefields_tpu_torch.kernels import roofline

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = [
    (1, 16, 8, 64, 1),       # the shapes of tests/test_fused_attention.py
    (2, 16, 5, 128, 2),
    (4, 64, 7, 64, 1),
    (2, 100, 4, 128, 2),
    (2, 400, 100, 320, 5),   # MiT-b3 stage 3 at 320^2
    (1, 100, 100, 512, 8),   # MiT-b3 stage 4 at 320^2
]


def _inputs(rng, b, n, m, c):
    """numpy inputs scaled as in tests/test_fused_attention.py; weights in
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
@pytest.mark.parametrize("b,n,m,c,heads", SHAPES)
def test_reference_matches_jax_kernel(b, n, m, c, heads, with_residual):
    rng = np.random.default_rng(b * 1000 + n + m + c + heads)
    kw = _inputs(rng, b, n, m, c)
    res = rng.normal(size=(b, n, c)).astype(np.float32) if with_residual else None
    scale = (c // heads) ** -0.5
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jres = None if res is None else jnp.asarray(res)
    want_kernel = jax_fused_attention(
        num_heads=heads, scale=scale, interpret=True, residual=jres, **jkw
    )
    want_xla = _xla_reference(num_heads=heads, scale=scale, **jkw)
    if jres is not None:
        want_xla = jres + want_xla
    got = fa.fused_attention_reference(
        *_torch_args(kw), heads, scale,
        residual=None if res is None else torch.from_numpy(res),
    ).numpy()
    # f32 on the CPU: the two frameworks differ only in summation order
    np.testing.assert_allclose(got, np.asarray(want_kernel), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want_xla), atol=2e-5, rtol=1e-5)


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(3)
    args = _torch_args(_inputs(rng, 2, 16, 5, 128))
    before = fa.LAUNCHES
    got = fa.fused_attention(*args, 2, 64**-0.5)
    want = fa.fused_attention_reference(*args, 2, 64**-0.5)
    assert torch.equal(got, want)
    assert fa.LAUNCHES == before


def test_wrapper_raises_on_a_device_without_kernel():
    args = _torch_args(_inputs(np.random.default_rng(4), 1, 8, 4, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.fused_attention(*args, 1, 0.125)


def _bad_case(name):
    rng = np.random.default_rng(5)
    args = _torch_args(_inputs(rng, 1, 8, 4, 128))
    heads, residual = 2, None
    if name == "head_dim_32":
        heads = 4
    elif name == "too_many_keys":
        args[1] = torch.zeros(1, 129, 128)
    elif name == "float16":
        args = [a.half() for a in args]
    elif name == "mixed_dtype":
        args[2] = args[2].to(torch.bfloat16)
    elif name == "non_contiguous":
        args[2] = args[2].t()
    elif name == "wkv_shape":
        args[4] = torch.zeros(128, 256)
    elif name == "residual_shape":
        residual = torch.zeros(1, 7, 128)
    elif name == "misaligned":  # a contiguous view 4 bytes into its storage
        args[0] = torch.zeros(8 * 128 + 1)[1:].view(1, 8, 128)
    return args, heads, residual


@pytest.mark.parametrize(
    "name",
    ["head_dim_32", "too_many_keys", "float16", "mixed_dtype", "non_contiguous",
     "wkv_shape", "residual_shape", "misaligned"],
)
def test_kernel_arg_check_refuses(name):
    args, heads, residual = _bad_case(name)
    with pytest.raises(ValueError):
        fa.check_kernel_args(*args, heads, residual)


def test_kernel_arg_check_accepts_main_path_shapes():
    for b, n, m, c, heads in [(2, 1600, 100, 128, 2), (2, 400, 100, 320, 5), (2, 100, 100, 512, 8)]:
        args = _torch_args(_inputs(np.random.default_rng(6), b, 1, m, c))
        args[0] = torch.zeros(b, n, c)
        fa.check_kernel_args(*args, heads, torch.zeros(b, n, c))


@pytest.mark.parametrize(
    "stage,n_tokens,heads,dim,want",
    [(1, 6400, 1, 64, False), (2, 1600, 2, 128, True), (3, 400, 5, 320, True),
     (4, 100, 8, 512, True)],
)
def test_gate_picks_stages_2_to_4_of_mitb3_at_320(stage, n_tokens, heads, dim, want):
    assert fa.use_kernel(True, True, n_tokens, dim // heads, 100, torch.device("cuda")) is want
    # never on the CPU, never when kernels are off or the heads lack a bias
    assert not fa.use_kernel(True, True, n_tokens, dim // heads, 100, torch.device("cpu"))
    assert not fa.use_kernel(False, True, n_tokens, dim // heads, 100, torch.device("cuda"))
    assert not fa.use_kernel(True, False, n_tokens, dim // heads, 100, torch.device("cuda"))


def test_gate_refuses_kernel_limits():
    cuda = torch.device("cuda")
    assert not fa.use_kernel(True, True, 400, 32, 100, cuda)   # head_dim
    assert not fa.use_kernel(True, True, 400, 64, 129, cuda)   # keys
    assert not fa.use_kernel(True, True, 2049, 64, 100, cuda)  # token gate


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build_mod, "find_nvcc", lambda: None)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build_mod.build("fused_attention")


def test_roofline_covers_every_tpu_kernel():
    """Each function that reaches pl.pallas_call has a row, with the
    pallas_call's file:line, and a positive bound per forward."""
    rows = roofline.flagship(8)
    assert set(rows) == {"fused_attention", "stage1_attention", "mixffn", "convnext_block",
                         "decoder_tail", "fused_block"}
    for where, calls in rows.values():
        path, line = where.rsplit(":", 1)
        with open(os.path.join(_REPO, path)) as f:
            assert "pallas_call(" in f.read().splitlines()[int(line) - 1]
        ms, by = roofline.per_forward(calls)
        assert ms > 0 and by in ("bytes", "operations")
    # the attention sub-block at stage 3, B=8: 2*8*400*320*320*2 + ... FLOPs
    tc, nbytes, _ = roofline.attention_cost(8, 400, 100, 320, 5)
    assert tc == 2 * 8 * 400 * 320**2 * 2 + 2 * 8 * 100 * 320 * 640 + 4 * 8 * 400 * 100 * 320
    assert nbytes == 2 * (2 * 8 * 400 * 320 + 8 * 100 * 320 + 4 * 320**2 + 4 * 320)
