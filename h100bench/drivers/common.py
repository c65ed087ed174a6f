"""What the drivers share: the program built from a configuration file, the
weights made from the seed, the reference pipeline over the same inputs,
and the comparison of answers."""

from __future__ import annotations

import contextlib
import gc
import math

import numpy as np
import torch

from ..reference import model as ref_model
from ..reference import preprocess as ref_pre
from ..yardstick import traffic

# ------------------------------------------------------------------ weights


def state_dict(cfg: dict, seed: int, device, dtype=None) -> dict:
    """The configuration's weights, drawn on ``device`` from the seed by the
    rule of its ``init`` section: every matrix and conv kernel from one
    standard-normal draw, each scaled by 1/sqrt(fan_in); other weights 1,
    biases 0, ConvNeXt's layer scale 1e-6, the frozen BN statistics 0 and 1;
    then ``init.scale``'s factors. Names and shapes are the reference
    network's, which are the released state dict's."""
    init = cfg["init"]
    dtype = dtype or getattr(torch, init["dtype"])
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in ref_model.PersNet(cfg["model"]).named_parameters()}
    mats = [n for n, s in shapes.items() if len(s) >= 2]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in mats), dtype=torch.float32, device=device,
                       generator=traffic.torch_generator(seed, traffic.WEIGHTS, device))
    out, off = {}, 0
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) >= 2:
            k = math.prod(shape)
            t = flat[off:off + k].view(shape) * (1.0 / math.sqrt(ref_model.fan_in(shape)))
            off += k
        else:
            value = {"weight": 1.0, "bias": 0.0, "gamma": 1e-6, "running_mean": 0.0,
                     "running_var": 1.0}[leaf]
            t = torch.full(shape, value, dtype=torch.float32, device=device)
        out[name] = t.to(dtype)
    for name, factor in init["scale"].items():
        out[name] = out[name] * factor
    return out


# ------------------------------------------------------------ the program


def port_config(cfg: dict):
    """The port's ModelConfig of a configuration file."""
    from perspectivefields_tpu_torch.config import (BackboneConfig, GravityHeadConfig,
                                                    LatitudeHeadConfig, ModelConfig,
                                                    ParamNetConfig)

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    m = cfg["model"]
    return ModelConfig(
        version=cfg["name"], backbone=BackboneConfig(**tup(m["backbone"])),
        gravity=GravityHeadConfig(**m["gravity"]), latitude=LatitudeHeadConfig(**m["latitude"]),
        param=ParamNetConfig(**tup(m["param"])) if m.get("param") else None,
        recover_pp=m["recover_pp"], recover_rpf=m["recover_rpf"], input_format=m["input_format"],
        resize=tuple(m["resize"]), pixel_mean=tuple(m["pixel_mean"]), pixel_std=tuple(m["pixel_std"]),
    )


def perspective_fields(cfg: dict, sd: dict, device):
    """The program as a user serves it: ``PerspectiveFields`` with the
    configuration's dtype and route flags, on one named device."""
    from perspectivefields_tpu_torch.api import PerspectiveFields

    run = cfg["run"]
    return PerspectiveFields(
        cfg["name"], params=sd, config=port_config(cfg), compute_dtype=run["compute_dtype"],
        device=device, use_kernels=run["use_kernels"], fuse_ffn=run["fuse_ffn"],
        fuse_convnext=run["fuse_convnext"], fuse_block=run["fuse_block"],
        device_preprocess=run["device_preprocess"],
    )


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


@contextlib.contextmanager
def block_ranges(backbone):
    """A ``record_function`` range around each MiT block's forward, named
    ``h100bench.block:<stage>.<index>``: the kernels launched inside belong
    to the block, whatever implements it."""
    hooks = []
    for s in range(1, 5):
        for i, blk in enumerate(getattr(backbone, f"block{s}")):
            name = f"h100bench.block:{s}.{i}"
            open_ranges = []

            def pre(mod, args, name=name, open_ranges=open_ranges):
                rf = torch.profiler.record_function(name)
                rf.__enter__()
                open_ranges.append(rf)

            def post(mod, args, out, open_ranges=open_ranges):
                open_ranges.pop().__exit__(None, None, None)

            hooks += [blk.register_forward_pre_hook(pre), blk.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def kernel_launches() -> dict:
    """The port's kernel launch counters (``LAUNCHES`` of each kernel
    module), to show which route ran."""
    import importlib
    import pkgutil

    import perspectivefields_tpu_torch.kernels as pkg

    out = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        if isinstance(getattr(mod, "LAUNCHES", None), int):
            out[info.name] = mod.LAUNCHES
    return out


# ------------------------------------------------------------ the reference


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN while the reference runs, the
    caller's settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def reference_answers(cfg: dict, seed: int, frames: list, device, rounding=None,
                      block: int = 32) -> list[dict]:
    """What ``inference_batch`` should answer for each uint8 BGR frame:
    Pillow's resize, normalize, the float32 network (or the control's
    ``rounding``), postprocess to each frame's size; in blocks of ``block``
    frames of one size. numpy arrays per frame, keyed as the program's."""
    m = cfg["model"]
    h, w = m["resize"]
    with exact_float32():
        net = ref_model.build(m, state_dict(cfg, seed, device), device, rounding).eval()
        answers = [None] * len(frames)
        by_size: dict = {}
        for i, f in enumerate(frames):
            by_size.setdefault(f.shape[:2], []).append(i)
        for (oh, ow), idxs in by_size.items():
            for k in range(0, len(idxs), block):
                part = idxs[k:k + block]
                x = torch.from_numpy(np.stack([frames[i] for i in part])).to(device)
                if m["input_format"] == "RGB":
                    x = x.flip(-1)
                x = ref_pre.normalize(ref_pre.pil_resize(x, h, w), m["pixel_mean"], m["pixel_std"])
                out = net(x)
                g, lat = ref_pre.postprocess(out["pred_gravity"], out["pred_latitude"], oh, ow)
                out["pred_gravity_original"], out["pred_latitude_original"] = g, lat
                host = {key: v.cpu().numpy() for key, v in out.items()}
                for j, i in enumerate(part):
                    answers[i] = {key: v[j] for key, v in host.items()}
        del net
    return answers


# ------------------------------------------------------------- comparison

PARAM_DEG_KEYS = ("pred_roll", "pred_pitch", "pred_vfov", "pred_general_vfov")
ZERO_KEYS = ("pred_rel_cx", "pred_rel_cy")
# per-answer gap -> the number compared
NUMBERS = {"up": "up_vs_bf16", "lat": "lat_vs_bf16", "field": "field_vs_bf16",
           "param": "param_vs_bf16"}


def _angle_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angle between 2-vectors, degrees (atan2 of cross and dot)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    dot = (a * b).sum(-1)
    return np.degrees(np.abs(np.arctan2(cross, dot)))


def gaps(answers: list[dict], reference: list[dict]) -> tuple[dict, list[str]]:
    """Each answer's gaps from the reference's answer, by kind:

    * ``up``: the mean angle (degrees) between ``pred_gravity_original``'s
      up-vectors and the reference's;
    * ``lat``: the mean absolute gap of ``pred_latitude_original``, degrees;
    * ``field``: the relative L2 gap of the network-size fields
      (``pred_gravity`` and ``pred_latitude`` together);
    * ``param``: the widest gap of roll, pitch, vfov and general vfov,
      degrees, and of the angle atan(1 / (2 rel_focal)), degrees modulo 180.

    Only the keys an answer holds are compared; ``pred_rel_cx`` and
    ``pred_rel_cy`` must equal the reference's exactly. Returns the gaps (a
    list per kind, one entry per answer) and the problems (a missing key, a
    shape or a non-finite value)."""
    out: dict = {}
    problems: list[str] = []
    for n, (ans, ref) in enumerate(zip(answers, reference)):
        g: dict = {}
        for key, val in ans.items():
            if key == "pred_latitude_original_mode":
                if val != "deg":
                    problems.append(f"answer {n}: {key} is {val!r}")
                continue
            if key not in ref:
                problems.append(f"answer {n}: unexpected key {key}")
                continue
            a, r = np.asarray(val, np.float64), np.asarray(ref[key], np.float64)
            if a.shape != r.shape or not np.isfinite(a).all():
                problems.append(f"answer {n}: {key} shape {a.shape} (reference {r.shape}) or not finite")
                continue
            if key == "pred_gravity_original":
                g["up"] = _angle_deg(a, r).mean()
            elif key == "pred_latitude_original":
                g["lat"] = np.abs(a - r).mean()
            elif key in PARAM_DEG_KEYS:
                g["param"] = max(g.get("param", 0.0), float(abs(a - r)))
            elif key == "pred_rel_focal":
                with np.errstate(divide="ignore"):
                    d = np.degrees(np.arctan(0.5 / a) - np.arctan(0.5 / r))
                g["param"] = max(g.get("param", 0.0), float(abs((d + 90.0) % 180.0 - 90.0)))
            elif key in ZERO_KEYS and not np.array_equal(a, r):
                problems.append(f"answer {n}: {key} {a} where the reference gives {r}")
        if "pred_gravity" in ans and "pred_latitude" in ans:
            a = np.concatenate([np.ravel(ans["pred_gravity"]), np.ravel(ans["pred_latitude"])])
            r = np.concatenate([np.ravel(ref["pred_gravity"]), np.ravel(ref["pred_latitude"])])
            if a.shape == r.shape:
                g["field"] = np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30)
        for kind, v in g.items():
            out.setdefault(kind, []).append(float(v))
    return out, problems


def numbers(answer_gaps: dict, bf16_gaps: dict) -> dict:
    """The numbers compared: each kind's widest gap over the answers, over
    the mean gap that the reference itself shows on the same answers when
    its products' operands are rounded to bfloat16, the precision the
    configuration states. The random weights of one seed make the network
    more or less sensitive to rounding, and that moves both alike."""
    out = {}
    for kind, vals in answer_gaps.items():
        scale = float(np.mean(bf16_gaps[kind]))
        out[NUMBERS[kind]] = max(vals) / scale if scale > 0 else (0.0 if max(vals) == 0 else float("inf"))
    return out


CONTROL = "fp8"  # the reference in float8 (``reference.model.Rounding``)


def check_answers(run, frames: list, answers: list[dict], keys, control=None) -> None:
    """Compare the program's answers for ``frames`` (or, with ``control``,
    the control's in their place) with the reference; every answer must
    hold exactly ``keys`` (None: the reference's and the latitude's mode).
    Fills ``run``."""
    if control not in (None, CONTROL):
        raise ValueError(f"unknown control {control!r}")
    cfg, seed, dev = run.config, run.seed, run.device
    ref = reference_answers(cfg, seed, frames, dev)
    want = set(keys) if keys is not None else set(ref[0]) | {"pred_latitude_original_mode"}
    missing = [n for n, a in enumerate(answers) if set(a) != want]
    problems = [f"answers {missing[:5]} do not hold the keys {sorted(want)}"] if missing else []
    bf16 = in_keys_of(answers, reference_answers(cfg, seed, frames, dev, "bf16"))
    if control is not None:
        answers = in_keys_of(answers, reference_answers(cfg, seed, frames, dev, control))
    got, found = gaps(answers, ref)
    problems += found
    yard, _ = gaps(bf16, ref)
    run.compared(numbers(got, yard))
    run.problems += problems
    run.ctx["compared"] = len(answers)
    run.ctx["gaps"] = {k: max(v) for k, v in got.items()}
    run.ctx["bf16_gaps"] = {k: float(np.mean(v)) for k, v in yard.items()}


def in_keys_of(answers: list[dict], other: list[dict]) -> list[dict]:
    """``other``'s answers, each with the keys of the program's answer."""
    return [{k: "deg" if k == "pred_latitude_original_mode" else c[k] for k in a}
            for a, c in zip(answers, other)]
