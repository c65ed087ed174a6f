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
from perspectivefields_tpu.ops import codec as jcodec
from perspectivefields_tpu.ops import geometry as jgeom
from perspectivefields_tpu.ops import image as jimage
from perspectivefields_tpu.ops import postprocess as jpost
from perspectivefields_tpu_torch.checkpoint import load_released, state_dict_from_jax
from perspectivefields_tpu_torch.models import convnext, heads, mit, paramnet
from perspectivefields_tpu_torch.models.common import init_random_
from perspectivefields_tpu_torch.ops import activations, codec, geometry, image, postprocess

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
    # the classification decode on the same logits (73 / 180 classes)
    glog, llog = _randn(rng, 2, 16, 16, 73), _randn(rng, 2, 16, 16, 180)
    want_g = jax.vmap(lambda p: jpost.postprocess_gravity(p, (16, 16), 24, 40, "classification", 73))(
        jnp.asarray(glog))
    want_l = jax.vmap(lambda p: jpost.postprocess_latitude(p, (16, 16), 24, 40, "classification", 180))(
        jnp.asarray(llog))
    _close(postprocess.postprocess_gravity(torch.from_numpy(glog), (16, 16), 24, 40, "classification", 73),
           want_g, atol=5e-4)
    _close(postprocess.postprocess_latitude(torch.from_numpy(llog), (16, 16), 24, 40, "classification", 180),
           want_l, atol=1e-3)


@pytest.mark.parametrize("hw,out_hw", [((320, 320), (64, 64)), ((32, 32), (16, 16)), ((13, 7), (5, 9))])
def test_resize_nearest_matches_jax(hw, out_hw):
    x = _randn(np.random.default_rng(10), 2, *hw, 3)
    got = image.resize_nearest(torch.from_numpy(x), *out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jimage.resize_nearest(jnp.asarray(x), *out_hw)))


@pytest.mark.parametrize("num_bin", [73, 37])
def test_codec_matches_jax(num_bin):
    rng = np.random.default_rng(num_bin)
    v = _randn(rng, 3, 9, 11, 2)
    v[0, :2] = 0.0  # invalid pixels
    bins = codec.encode_bin(torch.from_numpy(v), num_bin)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(jcodec.encode_bin(jnp.asarray(v), num_bin)))
    assert (bins[0, :2] == num_bin - 1).all()
    b = rng.integers(0, num_bin, size=(4, 5))
    _close(codec.decode_bin(torch.from_numpy(b), num_bin), jcodec.decode_bin(jnp.asarray(b), num_bin),
           atol=1e-6)
    assert (codec.decode_bin(torch.tensor([num_bin - 1]), num_bin) == 0).all()


@pytest.mark.parametrize("num_classes", [180, 73, 7])
def test_latitude_codec_matches_jax(num_classes):
    rng = np.random.default_rng(num_classes)
    lat = rng.uniform(-90, 90, size=(4, 6, 5)).astype(np.float32)
    lat[0, 0, :3] = (-90.0, 90.0, 0.0)
    np.testing.assert_array_equal(
        codec.encode_bin_latitude(torch.from_numpy(lat), num_classes).numpy(),
        np.asarray(jcodec.encode_bin_latitude(jnp.asarray(lat), num_classes)),
    )
    b = np.arange(num_classes)
    got = codec.decode_bin_latitude(torch.from_numpy(b), num_classes)
    assert got.shape == (num_classes,)  # exactly one centre per class
    _close(got, jcodec.decode_bin_latitude(jnp.asarray(b), num_classes), atol=1e-4)


@pytest.mark.parametrize("degree", [True, False], ids=["degrees", "radians"])
def test_general_vfov_to_focal_matches_jax(degree):
    rng = np.random.default_rng(11)
    cx, cy = rng.uniform(-0.3, 0.3, (2, 64)).astype(np.float32)
    f = rng.uniform(0.3, 3.0, 64).astype(np.float32)
    g = geometry.general_vfov(torch.from_numpy(cx), torch.from_numpy(cy), 1.0, torch.from_numpy(f), degree)
    _close(g, jgeom.general_vfov(cx, cy, 1.0, f, degree), atol=1e-4, rtol=1e-5)
    got = geometry.general_vfov_to_focal(torch.from_numpy(cx), torch.from_numpy(cy), 1.0, g, degree)
    _close(got, jgeom.general_vfov_to_focal(cx, cy, 1.0, np.asarray(g), degree), atol=1e-5, rtol=1e-4)
    _close(got, f, atol=1e-3, rtol=1e-3)  # the round trip


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


_HEAD_MODES = {
    "none": dict(fuse_embed=False, fuse_conv0=False, fuse_tail=False),
    "embed": dict(fuse_embed=True, fuse_conv0=False, fuse_tail=False),
    "conv0": dict(fuse_embed=False, fuse_conv0=True, fuse_tail=False),
    "tail": dict(fuse_embed=False, fuse_conv0=False, fuse_tail=True),
    "all": dict(fuse_embed=True, fuse_conv0=True, fuse_tail=True),
}


def _head_inputs(seed, dims, hw=16):
    rng = np.random.default_rng(seed)
    hl = [_randn(rng, 2, hw // 2**i, hw // 2**i, d) for i, d in enumerate(dims)]
    return hl, _randn(rng, 2, 2 * hw, 2 * hw, 64)


@pytest.mark.parametrize("mode", list(_HEAD_MODES))
def test_segformer_decoder_mode_matches_jax_same_mode(mode):
    dims = (64, 128, 320, 512)
    hl, ll = _head_inputs(12, dims)
    flags = _HEAD_MODES[mode]
    jm = jheads.SegFormerDecoder(3, embed_dim=32, fusion_dim=32, **flags)
    params = _perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), [jnp.asarray(h) for h in hl], jnp.asarray(ll)))
    tm = _load(heads.SegFormerDecoder("gravity", 3, dims, embed_dim=32, fusion_dim=32, **flags),
               params, ("gravity_head",))
    assert (tm.fuse_embed, tm.fuse_conv0, tm.fuse_tail) == tuple(flags.values())
    want = jax.jit(jm.apply)(params, [jnp.asarray(h) for h in hl], jnp.asarray(ll))
    with torch.no_grad():
        got = tm([torch.from_numpy(h) for h in hl], torch.from_numpy(ll))
    _close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("flag", ["fuse_embed", "fuse_conv0", "fuse_tail", "all"])
def test_port_fused_heads_match_port_plain(flag):
    """tests/test_head_fusion.py's shapes: each rewrite (and all three)
    against the plain dataflow of the same module, with the state dict
    unchanged."""
    rng = np.random.default_rng(13)
    hl = [_randn(rng, 2, 16 // 2**i, 16 // 2**i, d) for i, d in enumerate((8, 16, 24, 32))]
    ll = _randn(rng, 2, 32, 32, 64)
    dec = init_random_(heads.SegFormerDecoder("latitude", 3, (8, 16, 24, 32), embed_dim=48,
                                              fusion_dim=16), seed=3).eval()
    with torch.no_grad():
        for name, p in dec.named_parameters():  # nonzero biases, so the border terms show
            if name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    keys = list(dec.state_dict())
    args = ([torch.from_numpy(h) for h in hl], torch.from_numpy(ll))
    with torch.no_grad():
        for name in _HEAD_MODES["all"]:
            setattr(dec, name, False)
        plain = dec(*args)
        for name in _HEAD_MODES["all"]:
            setattr(dec, name, flag in (name, "all"))
        fused = dec(*args)
    assert list(dec.state_dict()) == keys
    assert fused.shape == plain.shape == (2, 64, 64, 3)
    _close(fused, plain, atol=5e-5, rtol=0)


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


@pytest.mark.parametrize(
    "predict_params", [("roll", "pitch", "general_vfov", "rel_cx", "rel_cy"), ("roll", "pitch", "vfov")],
    ids=["uncentered", "centered"],
)
def test_paramnet_regress_variant_matches_jax(predict_params):
    rng = np.random.default_rng(14)
    g = _randn(rng, 2, 48, 48, 2)
    lat = np.tanh(_randn(rng, 2, 48, 48, 1))
    # 32 is the least input ConvNeXt's four downsamplings take (32 / 4 / 2^3 = 1)
    cfg = ParamNetConfig(name="ParamNetConvNextRegress", predict_params=predict_params, input_size=32)
    jm = jparamnet.ParamNetHead(cfg, recover_pp=True)
    params, tm = _jax_pair(jm, paramnet.ParamNetHead(cfg, recover_pp=True), g, lat)
    # keep the general vFoV inside (0, 180) degrees, where the focal is defined
    params["params"]["backbone"]["head"]["kernel"] = params["params"]["backbone"]["head"]["kernel"] * 0.1
    params["params"]["backbone"]["head"]["bias"] = params["params"]["backbone"]["head"]["bias"] * 0 + 0.5
    tm = _load(tm, params)
    want = jax.jit(jm.apply)(params, jnp.asarray(g), jnp.asarray(lat))
    got = tm(torch.from_numpy(g), torch.from_numpy(lat))
    assert set(got) == set(want)
    assert "pred_rel_focal" in got and "pred_rel_pp" not in got
    for k in want:
        _close(got[k], want[k], atol=1e-3, rtol=1e-4)  # degrees and params


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
