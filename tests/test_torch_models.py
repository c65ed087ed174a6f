"""Module parity: each module of the port against its JAX counterpart, in f32.

Inputs are made with numpy from a seed; every JAX parameter is perturbed
away from its init value (biases and norm offsets are 0 there) and carried
across with ``flax_to_torch_names`` and ``load_state_dict(strict=True)``.
Small widths and depths keep the file fast.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perspectivefields_tpu.config import (
    BackboneConfig,
    ParamNetConfig,
)
from perspectivefields_tpu.models import convnext as jconvnext
from perspectivefields_tpu.models import heads as jheads
from perspectivefields_tpu.models import mit as jmit
from perspectivefields_tpu.models import paramnet as jparamnet
from perspectivefields_tpu.ops import activations as jact
from perspectivefields_tpu.ops import image as jimage
from perspectivefields_tpu.ops import postprocess as jpost
from perspectivefields_tpu_torch.checkpoint import load_released, state_dict_from_jax
from perspectivefields_tpu_torch.models import convnext, heads, mit, paramnet
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.ops import activations, image, postprocess

# f32 on the CPU, XLA vs PyTorch kernels: summation order only
ATOL, RTOL = 2e-5, 1e-5


def _perturb(params, seed=0):
    """Give every leaf a value its init would not (zero biases, unit
    scales), so a wrong name or layout cannot hide."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in flat:
        name = str(path[-1].key)
        a = np.asarray(leaf, np.float32)
        noise = rng.normal(size=a.shape).astype(np.float32)
        if name == "kernel":
            a = a + 0.1 * a.std() * noise
        elif name in ("scale", "var"):
            a = 1.0 + 0.1 * np.abs(noise)
        elif name == "gamma":
            a = 0.1 + 0.05 * noise
        else:  # bias, mean
            a = 0.1 * noise
        out.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, out)


def _load(module, params, wrap=()):
    """Load a JAX module's params into the port module (strict); ``wrap``
    nests the tree under names that give the reference's prefixes."""
    tree = params["params"]
    for key in reversed(wrap):
        tree = {key: tree}
    sd = state_dict_from_jax({"params": tree})
    prefix = {(): "", ("gravity_head",): "persformer_heads.gravity_head."}[tuple(wrap)]
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def _jax_pair(jmod, tmod, *inputs, wrap=()):
    params = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(0), *[jnp.asarray(i) for i in inputs]))
    return params, _load(tmod, params, wrap)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), atol=atol, rtol=rtol,
    )


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------------- ops


def test_gelu_dtype_rule():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    _close(activations.gelu(torch.from_numpy(x)), jact.gelu(jnp.asarray(x)), atol=1e-6)
    got = activations.gelu(torch.from_numpy(x).to(torch.bfloat16)).float()
    want = np.asarray(jact.gelu(jnp.asarray(x, jnp.bfloat16)), np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)  # bf16 rounding
    exact = torch.nn.functional.gelu(torch.from_numpy(x).to(torch.bfloat16).float())
    tanh = torch.nn.functional.gelu(torch.from_numpy(x).to(torch.bfloat16).float(), approximate="tanh")
    assert torch.allclose(got, tanh.to(torch.bfloat16).float()) and not torch.equal(exact, tanh)


@pytest.mark.parametrize("in_size,out_size", [(64, 32), (320, 640), (13, 7), (80, 80)])
@pytest.mark.parametrize("method", ["torch_bilinear", "pil_bilinear", "nearest"])
def test_resize_matrices_match_jax(in_size, out_size, method):
    np.testing.assert_array_equal(
        image.make_resize_matrix(in_size, out_size, method),
        jimage.make_resize_matrix(in_size, out_size, method),
    )


@pytest.mark.parametrize("shape,out_hw", [((48, 80, 3), (64, 64)), ((640, 640, 3), (320, 320)), ((30, 45), (17, 11))])
def test_pil_resize_uint8_bit_exact_vs_jax(shape, out_hw):
    img = np.random.default_rng(1).integers(0, 256, size=shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        image.pil_resize_uint8(img, *out_hw), jimage.pil_resize_uint8(img, *out_hw)
    )


@pytest.mark.parametrize("hw,out_hw", [((10, 12), (20, 24)), ((64, 64), (48, 80)), ((16, 16), (5, 9))])
def test_resize_bilinear_matches_jax_matrices(hw, out_hw):
    x = _randn(np.random.default_rng(2), 2, *hw, 8)
    got = image.resize_bilinear(torch.from_numpy(x), *out_hw)
    _close(got, jimage.resize_bilinear(jnp.asarray(x), *out_hw, "torch_bilinear"), atol=1e-5)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(3)
    g = _randn(rng, 2, 64, 64, 2)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    lat = np.tanh(_randn(rng, 2, 64, 64, 1))
    for oh, ow in ((48, 80), (64, 64), (96, 40)):
        want_g = jax.vmap(lambda p: jpost.postprocess_gravity(p, (64, 64), oh, ow))(jnp.asarray(g))
        want_l = jax.vmap(lambda p: jpost.postprocess_latitude(p, (64, 64), oh, ow))(jnp.asarray(lat))
        # the slice's tolerances: 5e-4 on fields (the renormalize amplifies
        # resize rounding where interpolated random vectors nearly cancel),
        # 1e-3 on degrees
        _close(postprocess.postprocess_gravity(torch.from_numpy(g), (64, 64), oh, ow), want_g, atol=5e-4)
        _close(postprocess.postprocess_latitude(torch.from_numpy(lat), (64, 64), oh, ow), want_l, atol=1e-3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        postprocess.postprocess_gravity(torch.from_numpy(g), (64, 64), 8, 8, "classification")


# ------------------------------------------------------------------- MiT


@pytest.mark.parametrize(
    "dim,heads,sr,hw",
    [(64, 1, 8, 16), (128, 2, 4, 8), (320, 5, 2, 6), (512, 8, 1, 4)],
)
@pytest.mark.parametrize("with_residual", [False, True], ids=["plain", "residual"])
def test_sr_attention_matches_jax(dim, heads, sr, hw, with_residual):
    rng = np.random.default_rng(dim + sr)
    x = _randn(rng, 2, hw, hw, dim)
    res = _randn(rng, 2, hw, hw, dim) if with_residual else None
    jm = jmit.SRAttention(dim, heads, sr_ratio=sr)
    params, tm = _jax_pair(jm, mit.SRAttention(dim, heads, sr), x)
    want = jax.jit(jm.apply)(params, jnp.asarray(x), None if res is None else jnp.asarray(res))
    got = tm(torch.from_numpy(x), None if res is None else torch.from_numpy(res))
    _close(got, want)


def test_block_matches_jax():
    x = _randn(np.random.default_rng(4), 2, 8, 8, 128)
    jm = jmit.Block(128, 2, 4)
    params, tm = _jax_pair(jm, mit.Block(128, 2, 4), x)
    _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(params, jnp.asarray(x)), atol=1e-4)


def test_mixvit_b3_widths_matches_jax():
    spec = BackboneConfig(depths=(1, 1, 1, 1))
    x = _randn(np.random.default_rng(5), 2, 64, 64, 3)
    jm = jmit.MixViT(spec)
    params, tm = _jax_pair(jm, mit.MixViT(spec), x)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, atol=1e-4, rtol=1e-4)  # LN outputs, 4 stages deep


def test_mit_spec_table():
    # the port's BackboneConfig is its own copy: compare field by field
    assert dataclasses.asdict(mit.mit_spec("mitb3")) == dataclasses.asdict(jmit.mit_spec("mitb3"))
    with pytest.raises(ValueError):
        mit.mit_spec("mitb9")


# ------------------------------------------------------------------- heads


def test_low_level_encoder_matches_jax():
    x = _randn(np.random.default_rng(6), 2, 32, 32, 3)
    jm = jheads.LowLevelEncoder()
    params, tm = _jax_pair(jm, heads.LowLevelEncoder(), x)
    assert {"bn1.running_mean", "bn1.running_var"} <= set(tm.state_dict())
    _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(params, jnp.asarray(x)), atol=1e-4)


def test_segformer_decoder_matches_jax_default_fused_heads():
    rng = np.random.default_rng(7)
    dims = (64, 128, 320, 512)
    hl = [_randn(rng, 2, 16 // 2**i, 16 // 2**i, d) for i, d in enumerate(dims)]
    ll = _randn(rng, 2, 32, 32, 64)
    jm = jheads.SegFormerDecoder(2, embed_dim=32, fusion_dim=32)
    assert jm.fuse_embed and jm.fuse_conv0 and jm.fuse_tail  # JAX's defaults
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), [jnp.asarray(h) for h in hl], jnp.asarray(ll)))
    tm = _load(heads.SegFormerDecoder("gravity", 2, dims, embed_dim=32, fusion_dim=32), params, ("gravity_head",))
    want = jax.jit(jm.apply)(params, [jnp.asarray(h) for h in hl], jnp.asarray(ll))
    got = tm([torch.from_numpy(h) for h in hl], torch.from_numpy(ll))
    assert got.shape == (2, 64, 64, 2)
    _close(got, want, atol=1e-4, rtol=1e-4)  # ~20 convs deep


# ------------------------------------------------------------------- ParamNet


def test_convnext_matches_jax():
    x = _randn(np.random.default_rng(8), 2, 32, 32, 3)
    jm = jconvnext.ConvNeXt(num_classes=5, depths=(1, 1, 2, 1))
    params, tm = _jax_pair(jm, convnext.ConvNeXt(num_classes=5, depths=(1, 1, 2, 1)), x)
    _close(tm(torch.from_numpy(x)), jax.jit(jm.apply)(params, jnp.asarray(x)), atol=1e-4)


@pytest.mark.parametrize("recover_pp", [False, True])
def test_paramnet_head_matches_jax(recover_pp):
    rng = np.random.default_rng(9)
    g = _randn(rng, 2, 32, 32, 2)
    lat = np.tanh(_randn(rng, 2, 32, 32, 1))
    cfg = ParamNetConfig(name="ParamNet")
    jm = jparamnet.ParamNetHead(cfg, recover_pp)
    params, tm = _jax_pair(jm, paramnet.ParamNetHead(cfg, recover_pp), g, lat)
    want = jax.jit(jm.apply)(params, jnp.asarray(g), jnp.asarray(lat))
    got = tm(torch.from_numpy(g), torch.from_numpy(lat))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], atol=1e-3, rtol=1e-4)  # degrees and params


def test_paramnet_regress_variant_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        paramnet.ParamNetHead(ParamNetConfig(name="ParamNetConvNextRegress"))


# ------------------------------------------------------------------- weights


def test_load_released_pth_envelope(tmp_path):
    """The {"model": ...} envelope, weights_only, and the strict=False rule:
    unmapped keys warn and are skipped; BN counters and pixel stats drop."""
    m = heads.LowLevelEncoder()
    init_random_(m, seed=1)
    sd = {f"ll_enc.{k}": v for k, v in m.state_dict().items()}
    blob = {"model": {
        **sd,
        "ll_enc.bn1.num_batches_tracked": torch.tensor(3),
        "pixel_mean": torch.zeros(3),
        "not_a_module.weight": torch.zeros(1),
    }}
    path = tmp_path / "release.pth"
    torch.save(blob, path)
    with pytest.warns(UserWarning, match="skipped 1 unmapped"):
        got = load_released(path)
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k])
