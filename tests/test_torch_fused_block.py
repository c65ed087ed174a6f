"""The port's whole-MiT-block module against the JAX package's kernel.

On the CPU the port's plain version (``fused_block_reference``) is held
against JAX's Pallas kernel run in interpret mode on the JAX test's shapes;
the gate, the routes at the flagship shapes and the wrapper are checked
here; and the port's ``MixViT(fuse_block=True)`` against JAX's, with the
weights carried across by ``state_dict_from_jax``. The CUDA kernel itself
runs only on a card: see tests/test_torch_cuda.py and
``python3 chip_smoke.py``.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu.config import BackboneConfig as JaxBackboneConfig
from perspectivefields_tpu.kernels.fused_block import fused_block as jax_fused_block
from perspectivefields_tpu.kernels.fused_block import fused_block_viable as jax_viable
from perspectivefields_tpu.models import mit as jmit
from perspectivefields_tpu_torch.checkpoint import state_dict_from_jax
from perspectivefields_tpu_torch.config import BackboneConfig
from perspectivefields_tpu_torch.kernels import build as build_mod
from perspectivefields_tpu_torch.kernels import fused_block as fb
from perspectivefields_tpu_torch.models import mit
from perspectivefields_tpu_torch.models.common import init_random_

CUDA = torch.device("cuda")
ORDER = ("ln1x", "kv_in", "res", "wq", "bq", "wkv", "bkv", "wproj", "bproj", "ln2s", "ln2b",
         "w1", "b1", "dwk", "dwb", "w2", "b2")


def _inputs(rng, b, h, w, c, m):
    """numpy inputs scaled as in tests/test_fused_block.py; JAX layouts."""
    def r(*shape, s=0.05):
        return (rng.normal(size=shape) * s).astype(np.float32)

    n, hd = h * w, 4 * c
    return dict(
        ln1x=r(b, n, c, s=0.5), kv_in=r(b, m, c, s=0.5), res=r(b, n, c, s=0.5),
        wq=r(c, c), bq=r(c), wkv=r(c, 2 * c), bkv=r(2 * c), wproj=r(c, c), bproj=r(c),
        ln2s=(1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32), ln2b=r(c),
        w1=r(c, hd), b1=r(hd), dwk=r(3, 3, 1, hd), dwb=r(hd), w2=r(hd, c), b2=r(c),
    )


def _torch_args(kw, device="cpu", dtype=torch.float32):
    """The same inputs in the port's layouts: nn.Linear (out, in) and the
    depthwise conv's (4C, 1, 3, 3)."""
    t = {k: torch.tensor(v, device=device, dtype=dtype) for k, v in kw.items()}
    for k in ("wq", "wkv", "wproj", "w1", "w2"):
        t[k] = t[k].t().contiguous()
    t["dwk"] = t["dwk"].permute(3, 2, 0, 1).contiguous()
    return [t[k] for k in ORDER]


@pytest.mark.parametrize(
    "b,h,w,c,heads,m,dt",
    [
        (4, 5, 5, 128, 2, 7, "float32"),   # the shapes of tests/test_fused_block.py:37-44
        (2, 4, 8, 128, 2, 8, "bfloat16"),
        (1, 10, 10, 320, 5, 25, "bfloat16"),
    ],
)
def test_reference_matches_jax_kernel(b, h, w, c, heads, m, dt):
    kw = _inputs(np.random.default_rng(0), b, h, w, c, m)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    scale = (c / heads) ** -0.5
    want = jax_fused_block(
        *[jnp.asarray(kw[k], jdt) for k in ORDER], heads, scale, h, w, interpret=True
    )
    got = fb.fused_block_reference(*_torch_args(kw, dtype=tdt), heads, scale, h, w)
    # JAX's own tolerances: f32 summation order; bf16 rounding order
    tol = 1e-5 if dt == "float32" else 0.05
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol
    )


def test_reference_matches_the_plain_block():
    """The composition is the module chain: at sr_ratio 1 (kv_in = ln1(x))
    it reproduces the port's plain Block, f32."""
    torch.manual_seed(0)
    blk = init_random_(mit.Block(128, 2, 1), seed=3).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn(p.shape))
        x = torch.tensor(np.random.default_rng(1).normal(size=(2, 4, 4, 128)) * 0.5,
                         dtype=torch.float32)
        want = blk(x)
        ln1 = blk.norm1(x).reshape(2, 16, 128)
        a, f = blk.attn, blk.mlp
        got = fb.fused_block_reference(
            ln1, ln1, x.reshape(2, 16, 128), *a.weights(), blk.norm2.weight, blk.norm2.bias,
            f.fc1.weight, f.fc1.bias, f.dwconv.dwconv.weight, f.dwconv.dwconv.bias,
            f.fc2.weight, f.fc2.bias, 2, 64**-0.5, 4, 4, blk.norm2.eps,
        )
    torch.testing.assert_close(got.reshape(2, 4, 4, 128), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "args",
    [
        (128, 400, 320, 1280, 100, 5),   # tests/test_fused_block.py:109-120
        (128, 100, 512, 2048, 100, 8),
        (128, 6400, 64, 256, 100, 1),
        (128, 1600, 128, 512, 100, 2),
        (8, 400, 320, 1280, 100, 5),     # the flagship at B=8
        (8, 100, 512, 2048, 100, 8),
        (8, 1600, 128, 512, 100, 2),
        (2, 25, 128, 512, 7, 2),
        (2, 64, 64, 256, 4, 1),
    ],
)
def test_viability_gate_is_jax_at_itemsize_2(args):
    assert fb.fused_block_viable(*args) == jax_viable(*args, itemsize=2)
    # JAX's f32 gate refuses stage 3; the port runs it in f32 too
    assert fb.fused_block_viable(128, 400, 320, 1280, 100, 5)
    assert not jax_viable(128, 400, 320, 1280, 100, 5, itemsize=4)


def _routes(model, b, side, device):
    """Each block's route in a MixViT at a (side x side) input."""
    routes = collections.Counter()
    for s in range(1, 5):
        hw = side // 2 ** (s + 1)
        for blk in getattr(model, f"block{s}"):
            routes[blk.route(b, hw, hw, device)] += 1
    return routes


def test_routes_of_mitb3_at_320():
    """B2 in stage 1's 3 blocks, B1 in stage 2's 4, B6 in the 21 of stages
    3-4; nothing new without fuse_block; nothing but B6's plain version on
    the CPU."""
    spec = mit.mit_spec("mitb3")
    block = mit.MixViT(spec, use_kernels=True, fuse_block=True).eval()
    assert _routes(block, 8, 320, CUDA) == {"stage1_attention": 3, "fused_attention": 4,
                                             "fused_block": 21}
    assert _routes(block, 32, 320, CUDA) == {"stage1_attention": 3, "fused_attention": 4,
                                              "fused_block": 21}
    default = mit.MixViT(spec, use_kernels=True).eval()
    assert _routes(default, 8, 320, CUDA) == {"fused_attention": 25, "plain": 3}
    no_kernels = mit.MixViT(spec, fuse_block=True).eval()
    assert _routes(no_kernels, 8, 320, CUDA) == {"fused_block": 21, "plain": 7}
    assert _routes(block, 8, 320, torch.device("cpu")) == {"fused_block": 21, "plain": 7}
    assert _routes(block.train(), 8, 320, CUDA) == {"stage1_attention": 3, "fused_attention": 25}


def test_mixvit_fuse_block_matches_jax(monkeypatch):
    """A small MixViT (tests/test_fused_block.py:136-141) with fuse_block
    against JAX's, on the same weights; the port's fused block runs in the
    four blocks of stages 2-4, as JAX's does."""
    monkeypatch.setattr(jmit, "_fused_backend_ok", lambda: True)
    dims, depths, heads, srs = (32, 64, 128, 256), (1, 1, 2, 1), (1, 1, 2, 4), (8, 4, 2, 1)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jmit.MixViT(JaxBackboneConfig(dims=dims, depths=depths, num_heads=heads, sr_ratios=srs),
                     fuse_block=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    params = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape) * 0.1 + (a == 1), a.dtype),
                          params)
    want = jm.apply(params, jnp.asarray(x), True)

    tm = mit.MixViT(BackboneConfig(dims=dims, depths=depths, num_heads=heads, sr_ratios=srs),
                    fuse_block=True)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    calls = []
    real = mit.fused_block
    monkeypatch.setattr(mit, "fused_block", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert len(calls) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5)


def test_fused_and_plain_blocks_share_the_state_dict():
    plain, fused = mit.Block(128, 2, 1), mit.Block(128, 2, 1, fuse_block=True)
    init_random_(plain, seed=2)
    fused.load_state_dict(plain.state_dict(), strict=True)
    x = torch.tensor(np.random.default_rng(2).normal(size=(2, 6, 5, 128)), dtype=torch.float32)
    assert fused.eval().route(2, 6, 5, x.device) == "fused_block"
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain.eval()(x), atol=2e-5, rtol=1e-5)


def test_wrapper_uses_plain_version_on_cpu_and_counts_no_launch():
    args = _torch_args(_inputs(np.random.default_rng(3), 2, 3, 5, 128, 7))
    before = fb.LAUNCHES
    got = fb.fused_block(*args, 2, 0.125, 3, 5)
    assert torch.equal(got, fb.fused_block_reference(*args, 2, 0.125, 3, 5))
    assert fb.LAUNCHES == before


def test_wrapper_raises_on_a_device_without_kernel():
    args = _torch_args(_inputs(np.random.default_rng(4), 1, 2, 2, 64, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fb.fused_block(*args, 1, 0.125, 2, 2)


def _bad_case(name):
    args, heads, hw = _torch_args(_inputs(np.random.default_rng(5), 1, 3, 4, 128, 5)), 2, (3, 4)
    if name == "head_dim_32":
        heads = 4
    elif name == "too_many_keys":
        args[1] = torch.zeros(1, 129, 128)
    elif name == "grid":
        hw = (4, 4)
    elif name == "float16":
        args = [a.half() for a in args]
    elif name == "mixed_dtype":
        args[11] = args[11].to(torch.bfloat16)
    elif name == "non_contiguous":
        args[3] = args[3].t()
    elif name == "dwk_shape":
        args[13] = args[13].reshape(512, 9)
    elif name == "res_shape":
        args[2] = torch.zeros(1, 11, 128)
    elif name == "misaligned":  # a contiguous view 4 bytes into its storage
        args[0] = torch.zeros(12 * 128 + 1)[1:].view(1, 12, 128)
    return args, heads, hw


@pytest.mark.parametrize(
    "name",
    ["head_dim_32", "too_many_keys", "grid", "float16", "mixed_dtype", "non_contiguous",
     "dwk_shape", "res_shape", "misaligned"],
)
def test_kernel_arg_check_refuses(name):
    args, heads, (h, w) = _bad_case(name)
    with pytest.raises(ValueError):
        fb.check_kernel_args(*args, heads, h, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,h,w,c,heads", [(8, 20, 20, 320, 5), (8, 10, 10, 512, 8), (3, 7, 5, 128, 2), (32, 20, 20, 320, 5)]
)
def test_tile_fits_the_kernel_limits(b, h, w, c, heads, dtype):
    """The tile the wrapper picks is one csrc/fused_block.cu takes: float32,
    halo <= 128 tokens in shared memory; bfloat16, halo <= 64 tokens (one
    wgmma M), a ring of 2-6 stages in shared memory, a grid padded to a
    multiple of the cluster by fewer than a cluster of blocks."""
    th, tw = fb.choose_tile(b, h, w, c, heads, dtype)
    assert 1 <= th <= h and 1 <= tw <= w
    if dtype == torch.float32:
        assert -(-(th + 2) * (tw + 2) // 16) * 16 <= fb.MAX_HALO
        assert fb.smem_bytes(dtype, c, th, tw) <= fb.SMEM_LIMIT
    else:
        p = fb.plan(b, h, w, c, heads)
        assert p["tile"] == (th, tw) and (th + 2) * (tw + 2) <= fb.ROWS_BF16
        assert 2 <= p["stages"] <= fb.MAX_STAGES and p["smem"] <= fb.SMEM_LIMIT
        tiles = b * -(-h // th) * -(-w // tw)
        assert p["blocks"] % p["cluster"] == 0 and 0 <= p["blocks"] - tiles < p["cluster"]


@pytest.mark.parametrize("b", [1, 3, 5, 8, 32])
@pytest.mark.parametrize("h,w,c,heads", [(20, 20, 320, 5), (10, 10, 512, 8), (13, 9, 320, 5),
                                         (7, 11, 512, 8), (7, 5, 128, 2)])
def test_cluster_shares_weights_without_adding_waves(b, h, w, c, heads):
    """The cluster is the largest that has two blocks' worth of tiles and
    takes no more waves than single blocks; the weight bytes a call fall by
    the cluster size, and a cluster the card cannot run is never chosen."""
    p = fb.plan(b, h, w, c, heads, 132)
    tiles = b * -(-h // p["tile"][0]) * -(-w // p["tile"][1])
    k = p["cluster"]
    assert k in fb.CLUSTERS and (k == 1 or tiles >= 2 * k)
    assert -(-(-(-tiles // k)) // (132 // k)) <= -(-tiles // 132)
    assert p["weight_bytes"] == p["blocks"] // k * 10 * c * c * 2
    assert fb.plan(b, h, w, c, heads, 132, ((8, 0), (4, 0), (2, 0), (1, 132)))["cluster"] == 1


def test_flagship_plans_cut_l2_weight_reads_fourfold():
    """At B=8 the flagship's stages 3-4 take clusters of 8 and read the
    weights from L2 at least 4x less than one read per 64-row block would."""
    for h, c, heads in [(20, 320, 5), (10, 512, 8)]:
        p = fb.plan(8, h, h, c, heads)
        assert p["cluster"] == 8
        assert p["weight_bytes"] * 4 <= p["blocks"] * 10 * c * c * 2


@pytest.mark.parametrize("c", [704, 768])
def test_bf16_refuses_a_width_it_has_no_kernel_for(c):
    with pytest.raises(ValueError, match="C = heads"):
        fb.plan(1, 4, 4, c, c // 64)


@pytest.mark.parametrize("c", range(64, 641, 64))
def test_bf16_plans_every_width_the_gate_admits_up_to_640(c):
    """Every C = heads * 64 up to 640 has a bf16 kernel (NT = ceil(C / 128)
    W2 tiles) whose layout fits shared memory with at least two ring stages,
    on the smallest map and at B=8 on a 10 x 10 map."""
    for b, h, w in [(1, 1, 1), (8, 10, 10)]:
        p = fb.plan(b, h, w, c, c // 64)
        assert p["stages"] >= 2 and p["smem"] <= fb.SMEM_LIMIT
        assert p["smem"] == fb.smem_bytes(torch.bfloat16, c, *p["tile"], p["stages"])


def test_route_sends_wider_bf16_blocks_to_the_unfused_path():
    """C = 704 on a map of at most 31 tokens passes JAX's gate but has no
    bf16 kernel: the block takes the attention's route in bf16 and the
    fused block in f32."""
    assert fb.fused_block_viable(1, 25, 704, 4 * 704, 25, 11)
    blk = mit.Block(704, 11, 1, fuse_block=True).eval()
    assert blk.route(1, 5, 5, torch.device("cpu")) == "fused_block"
    blk = blk.to(torch.bfloat16)
    assert blk.route(1, 5, 5, torch.device("cpu")) != "fused_block"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build_mod, "find_nvcc", lambda: None)
    monkeypatch.setattr(build_mod, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build_mod.build("fused_block")
