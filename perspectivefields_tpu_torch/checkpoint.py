"""Weights for the port: converted JAX params and released ``.pth`` files.

The port's module names are the reference's torch state-dict names, which
is what ``flax_to_torch_names`` emits and what the released checkpoints
carry, so both load without a name map of their own. The two name maps
below are the port's copies of the ones in
perspectivefields_tpu/checkpoint/torch_convert.py (``map_torch_name`` and
its ``_map_*`` helpers; ``flax_to_torch_names`` and its helpers), since the
port imports nothing of the JAX package; tests/test_torch_api.py holds them
equal. ``_unflatten`` is the port's copy of
perspectivefields_tpu/checkpoint/io.py's, so a JAX ``.npz`` (the flat file
its ``save_params`` writes) loads with numpy alone (``load_npz``), and
``state_dict_to_jax`` (a copy of ``convert_torch_state_dict``'s strict form)
writes one (``save_params``).

Training state (JAX checkpoint/io.py's ``save_train_state`` /
``restore_train_state``, orbax there) is saved with ``torch.save`` under
``path/step_<n>/``: the model's and the optimizer's state dicts and the
step, the newest ``keep`` kept. A tensor-parallel state
(``parallel.tensor_parallel``) is saved whole, in the one-process format:
the shards of each parameter and of its optimizer moments are gathered
under the reference's names, and restoring takes this rank's slice, so a
checkpoint moves between one process and a split state either way.
"""

from __future__ import annotations

import copy
import os
import re
import shutil
import tempfile
import warnings
import zipfile

import numpy as np
import torch
from torch import nn


# ---------------------------------------------------------------------------
# torch state-dict name -> JAX param path (released checkpoints)
# ---------------------------------------------------------------------------


def _map_backbone(parts, leaf):
    """backbone.<...> (MiT) -> flax path + tensor kind."""
    head = parts[0]
    if head.startswith("patch_embed"):
        sub = parts[1]  # proj | norm
        kind = "conv" if sub == "proj" else "ln"
        return ("backbone", head, sub), kind
    if head.startswith("block"):
        stage = head[len("block") :]
        idx = parts[1]
        rest = parts[2:]
        base = ("backbone", f"block{stage}_{idx}")
        if rest[0] in ("norm1", "norm2"):
            return base + (rest[0],), "ln"
        if rest[0] == "attn":
            sub = rest[1]
            if sub in ("q", "kv", "proj"):
                return base + ("attn", sub), "linear"
            if sub == "sr":
                return base + ("attn", "sr"), "conv"
            if sub == "norm":
                return base + ("attn", "norm"), "ln"
        if rest[0] == "mlp":
            sub = rest[1]
            if sub in ("fc1", "fc2"):
                return base + ("mlp", sub), "linear"
            if sub == "dwconv":  # mlp.dwconv.dwconv.weight
                return base + ("mlp", "dwconv"), "conv"
        raise KeyError(f"unmapped backbone block param: {parts}")
    if re.fullmatch(r"norm[1-4]", head):
        return ("backbone", head), "ln"
    raise KeyError(f"unmapped backbone param: {parts}")


def _map_convnext(parts):
    """ConvNeXt trunk names (inside param_net.backbone)."""
    head = parts[0]
    if head == "downsample_layers":
        stage, sub = int(parts[1]), int(parts[2])
        if stage == 0:
            name = "stem_conv" if sub == 0 else "stem_norm"
            kind = "conv" if sub == 0 else "ln"
        else:
            name = f"downsample{stage}_norm" if sub == 0 else f"downsample{stage}_conv"
            kind = "ln" if sub == 0 else "conv"
        return (name,), kind
    if head == "stages":
        i, j, sub = int(parts[1]), int(parts[2]), parts[3]
        base = (f"stage{i}_{j}",)
        if sub == "dwconv":
            return base + ("dwconv",), "conv"
        if sub == "norm":
            return base + ("norm",), "ln"
        if sub in ("pwconv1", "pwconv2"):
            return base + (sub,), "linear"
        if sub == "gamma":
            return base, "raw"  # leaf name is 'gamma' itself
        raise KeyError(f"unmapped convnext stage param: {parts}")
    if head == "norm":
        return ("norm",), "ln"
    if head == "head":
        return ("head",), "linear"
    raise KeyError(f"unmapped convnext param: {parts}")


def _map_head(parts, head_name):
    """persformer_heads.{gravity,latitude}_head.<...>"""
    sub = parts[0]
    base = (head_name,)
    if re.fullmatch(r"linear_c[1-4]", sub):
        # torch MLP wrapper: linear_cX.proj.weight -> Dense linear_cX
        return base + (sub,), "linear"
    if re.fullmatch(r"linear_c[1-4]_proc", sub):
        return base + (sub,), "conv"
    if re.fullmatch(r"fusion[1-4]", sub):
        # fusionX.resConfUnitY.convZ
        return base + (sub, parts[1], parts[2]), "conv"
    if sub in ("conv_fuse_conv0", "conv_fuse_conv1"):
        # torch ConvModule wrapper: conv_fuse_convX.conv.weight
        return base + (sub,), "conv"
    if sub.startswith("linear_pred"):
        return base + ("linear_pred",), "conv"
    raise KeyError(f"unmapped head param: {parts}")


_LN_MAP = {"weight": "scale", "bias": "bias"}
_BN_MAP = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def _convert_tensor(kind: str, leaf: str, value: np.ndarray):
    """One torch tensor -> (flax leaf, value); kind: conv | linear | ln | bn
    (JAX torch_convert.py:_convert_tensor)."""
    if kind == "conv" and leaf == "weight":
        return "kernel", np.transpose(value, (2, 3, 1, 0))
    if kind == "linear" and leaf == "weight":
        return "kernel", np.transpose(value, (1, 0))
    if kind in ("conv", "linear") and leaf == "bias":
        return "bias", value
    if kind == "ln":
        return _LN_MAP[leaf], value
    if kind == "bn":
        return _BN_MAP[leaf], value
    return leaf, value


def map_torch_name(name: str):
    """Map one torch state-dict key -> (flax path tuple, tensor kind, leaf).

    Returns None for keys to skip (num_batches_tracked etc.).
    """
    if name.endswith("num_batches_tracked"):
        return None
    parts = name.split(".")
    root = parts[0]
    leaf = parts[-1]
    if root == "backbone":
        path, kind = _map_backbone(parts[1:-1], leaf)
        return path, kind, leaf
    if root == "ll_enc":
        sub = parts[1]
        if sub == "conv1":
            return ("ll_enc", "conv1"), "conv", leaf
        if sub == "bn1":
            return ("ll_enc", "bn1"), "bn", leaf
        raise KeyError(f"unmapped ll_enc param: {name}")
    if root == "persformer_heads":
        head_name = parts[1]  # gravity_head | latitude_head
        path, kind = _map_head(parts[2:-1], head_name)
        return path, kind, leaf
    if root == "param_net":
        assert parts[1] == "backbone"
        if leaf == "gamma":
            path, kind = _map_convnext(parts[2:])
            return ("param_net", "backbone") + path + ("gamma",), "raw", "gamma"
        path, kind = _map_convnext(parts[2:-1])
        return ("param_net", "backbone") + path, kind, leaf
    if root in ("pixel_mean", "pixel_std"):
        return None  # preprocessing constants live in ModelConfig
    raise KeyError(f"unmapped torch param: {name}")


# ---------------------------------------------------------------------------
# JAX param tree -> torch state-dict names
# ---------------------------------------------------------------------------


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch_names(params: dict) -> dict[str, np.ndarray]:
    """Export flax params as a reference-named torch-layout state dict
    (conv HWIO -> OIHW, linear (in, out) -> (out, in), norm scale ->
    weight, BN mean/var -> running_mean/var)."""
    tree = params.get("params", params)
    out = {}
    for path, value in _flatten(tree):
        out.update(_export_one(path, np.asarray(value)))
    return out


def _export_one(path: tuple[str, ...], value: np.ndarray) -> dict[str, np.ndarray]:
    leaf = path[-1]
    # the tensor kind follows from the leaf name and rank
    if leaf == "kernel" and value.ndim == 4:
        torch_leaf, v = "weight", np.transpose(value, (3, 2, 0, 1))
    elif leaf == "kernel" and value.ndim == 2:
        torch_leaf, v = "weight", np.transpose(value, (1, 0))
    else:  # scale / mean / var / bias / gamma
        torch_leaf, v = _LEAF_NAMES.get(leaf, leaf), value
    return {_torch_name_for(path[:-1], torch_leaf): v}


_LEAF_NAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _torch_name_for(module_path: tuple[str, ...], leaf: str) -> str:
    parts = list(module_path)
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        m = re.fullmatch(r"block([1-4])_(\d+)", p)
        if p == "backbone" and not out:
            out.append("backbone")
        elif m:
            out.append(f"block{m.group(1)}.{m.group(2)}")
        elif p in ("gravity_head", "latitude_head"):
            out.append("persformer_heads")
            out.append(p)
        elif p == "linear_pred":
            head = "gravity" if "gravity_head" in out else "latitude"
            out.append(f"linear_pred_{head}")
        elif re.fullmatch(r"linear_c[1-4]", p):
            out.append(p)
            out.append("proj")  # torch MLP wrapper
        elif p in ("conv_fuse_conv0", "conv_fuse_conv1"):
            out.append(p)
            out.append("conv")  # torch ConvModule wrapper
        elif p == "dwconv" and i > 0 and parts[i - 1] == "mlp":
            out.append("dwconv.dwconv")
        elif p == "stem_conv":
            out.append("downsample_layers.0.0")
        elif p == "stem_norm":
            out.append("downsample_layers.0.1")
        elif (m := re.fullmatch(r"downsample([1-3])_norm", p)):
            out.append(f"downsample_layers.{m.group(1)}.0")
        elif (m := re.fullmatch(r"downsample([1-3])_conv", p)):
            out.append(f"downsample_layers.{m.group(1)}.1")
        elif (m := re.fullmatch(r"stage([0-3])_(\d+)", p)):
            out.append(f"stages.{m.group(1)}.{m.group(2)}")
        else:
            out.append(p)
        i += 1
    return ".".join(out) + "." + leaf


def state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """JAX param tree ({"params": ...}, arrays or numpy) -> float32 torch
    state dict that ``PersNet.load_state_dict(strict=True)`` takes."""
    return {
        name: torch.from_numpy(np.array(value, dtype=np.float32))
        for name, value in flax_to_torch_names(params).items()
    }


def state_dict_to_jax(state_dict) -> dict:
    """A port (reference-named) state dict -> the JAX param tree
    ({"params": ...}, float32 numpy) that JAX's PersNet applies: the strict
    form of JAX's ``convert_torch_state_dict`` (an unmapped key raises)."""
    tree: dict = {}
    for name, value in state_dict.items():
        mapped = map_torch_name(name)
        if mapped is None:
            continue
        path, kind, leaf = mapped
        value = np.asarray(value.detach().float().cpu() if isinstance(value, torch.Tensor) else value)
        if kind == "raw":
            full, out = path, value
        else:
            new_leaf, out = _convert_tensor(kind, leaf, value)
            full = path + (new_leaf,)
        node = tree
        for k in full[:-1]:
            node = node.setdefault(k, {})
        node[full[-1]] = np.asarray(out, np.float32)
    return {"params": tree}


def _unflatten(flat: dict) -> dict:
    """A flat {"a/b/c": array} dict -> the nested tree (JAX:
    checkpoint/io.py:_unflatten)."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_npz(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Read a JAX param tree saved as a flat ``.npz`` (JAX:
    checkpoint/io.py:save_params) into a float32 torch state dict, with
    numpy alone."""
    with np.load(path) as z:
        return state_dict_from_jax(_unflatten({k: z[k] for k in z.files}))


def load_released(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Read a released reference checkpoint: the ``{"model": ...}``
    envelope, ``weights_only=True``. As the reference's strict=False load
    (and checkpoint/torch_convert.py:214-225), keys the model does not have
    are skipped with a warning; BN counters and pixel_mean/std are dropped.
    A zip archive's directory is read first, so a truncated file raises
    zipfile.BadZipFile (torch.load raises OSError for it)."""
    with open(path, "rb") as f:
        if f.read(2) == b"PK":
            zipfile.ZipFile(f).close()
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model", blob)
    kept, skipped = {}, []
    for name, value in sd.items():
        try:
            mapped = map_torch_name(name)
        except KeyError:
            skipped.append(name)
            continue
        if mapped is not None:
            kept[name] = value.to(torch.float32)
    if skipped:
        warnings.warn(
            f"skipped {len(skipped)} unmapped checkpoint keys: {skipped[:5]}...",
            stacklevel=2,
        )
    return kept


def load_into(model: nn.Module, state_dict: dict[str, torch.Tensor]) -> None:
    """Load with the reference's strict=False rule, warning about any key the
    checkpoint lacks (those weights keep their current values)."""
    result = model.load_state_dict(state_dict, strict=False)
    if result.missing_keys or result.unexpected_keys:
        warnings.warn(
            f"checkpoint load: {len(result.missing_keys)} missing keys "
            f"{result.missing_keys[:5]}, {len(result.unexpected_keys)} unexpected "
            f"{result.unexpected_keys[:5]}",
            stacklevel=2,
        )


# ---------------------------------------------------------------------------
# parameter and train-state persistence (JAX checkpoint/io.py)
# ---------------------------------------------------------------------------


def save_params(params, path: str) -> None:
    """Save a model's weights as a flat ``.npz`` in JAX's layout (its
    ``save_params``: the param tree's paths joined with "/"), so JAX's
    ``load_params`` reads it. ``params``: an ``nn.Module`` or its state dict.
    Only ``.npz`` is written (JAX's orbax directory form is not ported)."""
    if not str(path).endswith(".npz"):
        raise ValueError(f"save_params writes a flat .npz; got {path!r}")
    if isinstance(params, nn.Module):
        params = params.state_dict()
    flat = {"/".join(p): v for p, v in _flatten(state_dict_to_jax(params))}
    np.savez_compressed(path, **flat)


def load_params(path: str) -> dict[str, torch.Tensor]:
    """Read a flat ``.npz`` written by this ``save_params`` or by JAX's into a
    float32 state dict for ``load_state_dict(strict=True)``."""
    return load_npz(path)


_STATE_FILE = "state.pt"


def _step_dirs(base: str) -> list[str]:
    return sorted(d for d in os.listdir(base) if d.startswith("step_")) if os.path.isdir(base) else []


def _optimizer_params(optimizer) -> list:
    """The optimizer's parameters in its state dict's index order."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def _whole_optimizer_state(optimizer) -> dict:
    """``optimizer.state_dict()`` with each split parameter's moments
    gathered whole (a collective over the model group when any is split)."""
    from .parallel.tensor_parallel import gather_like

    sd = optimizer.state_dict()
    for i, p in enumerate(_optimizer_params(optimizer)):
        if i in sd["state"]:
            sd["state"][i] = {k: gather_like(v, p) if torch.is_tensor(v) and v.shape == p.shape else v
                              for k, v in sd["state"][i].items()}
    return sd


def _local_optimizer_state(optimizer, sd: dict) -> dict:
    """A whole optimizer state dict with each split parameter's moments cut
    to this rank's slice."""
    from .parallel.tensor_parallel import model_shard

    state = dict(sd["state"])
    for i, p in enumerate(_optimizer_params(optimizer)):
        shard = model_shard(p)
        if shard is None or i not in state:
            continue
        whole = shard.full_shape(p.shape)
        if any(torch.is_tensor(v) and v.dim() and v.shape != whole for v in state[i].values()):
            raise ValueError(f"optimizer state {i} is not of its parameter's whole shape {tuple(whole)}")
        state[i] = {k: shard.local(v) if torch.is_tensor(v) and v.dim() else v
                    for k, v in state[i].items()}
    return dict(sd, state=state)


def save_train_state(state, path: str, keep: int = 2, write: bool = True) -> str:
    """Persist a ``train.TrainState`` (model and optimizer state dicts, step)
    as ``path/step_<n>/state.pt`` and keep the newest ``keep`` step
    directories. The directory is written under a temporary name and
    renamed, so a crash mid-save leaves the older checkpoints whole.
    Returns the step directory.

    A tensor-parallel state is gathered whole first, a collective: every
    rank of its model group calls this, and only a rank with ``write``
    writes."""
    blob = {
        "model": state.model.state_dict(),
        "optimizer": _whole_optimizer_state(state.optimizer),
        "step": int(state.step),
    }
    base = os.path.abspath(path)
    final = os.path.join(base, f"step_{int(state.step):08d}")
    if not write:
        return final
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".saving_", dir=base)
    torch.save(blob, os.path.join(tmp, _STATE_FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if keep:
        for stale in _step_dirs(base)[:-keep]:
            shutil.rmtree(os.path.join(base, stale), ignore_errors=True)
    return final


def _load_state(cand: str, template) -> None:
    """Load one step directory into ``template`` (a TrainState), all or
    nothing: on any failure the template is put back as it was."""
    blob = torch.load(os.path.join(cand, _STATE_FILE), map_location="cpu", weights_only=True)
    want = template.model.state_dict()
    got = blob["model"]
    if set(got) != set(want) or any(got[k].shape != want[k].shape for k in want):
        raise ValueError(f"model state in {cand} does not match the template's")
    saved_model = {k: v.clone() for k, v in want.items()}
    saved_opt = copy.deepcopy(template.optimizer.state_dict())
    try:
        template.model.load_state_dict(got, strict=True)
        template.optimizer.load_state_dict(_local_optimizer_state(template.optimizer, blob["optimizer"]))
        template.step = int(blob["step"])
    except Exception:
        template.model.load_state_dict(saved_model)
        template.optimizer.load_state_dict(saved_opt)
        raise


def restore_train_state(path: str, template):
    """Restore the newest usable checkpoint under ``path`` into ``template``
    (a freshly made ``TrainState`` of the same model and optimizer, whole or
    tensor-parallel: every rank of a model group calls it) and return it. Step directories are tried newest first; an unusable one
    (partial, corrupt, or of another model) is skipped with a warning.
    Raises FileNotFoundError, chained to the last failure, when none
    restores."""
    base = os.path.abspath(path)
    last_exc = None
    for d in reversed(_step_dirs(base)):
        cand = os.path.join(base, d)
        try:
            _load_state(cand, template)
        except Exception as exc:  # noqa: BLE001 - any unusable save is skipped
            last_exc = exc
            warnings.warn(f"checkpoint {cand} unusable ({exc!r}); trying older", stacklevel=2)
            continue
        return template
    raise FileNotFoundError(f"no restorable checkpoint under {base}") from last_exc
