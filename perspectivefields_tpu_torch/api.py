"""Public API of the port: ``PerspectiveFields`` on PyTorch and CUDA.

The same user surface and output contract as perspectivefields_tpu/api.py
(reference perspectivefields.py:121-272):

  host: uint8 BGR images -> PIL-exact bilinear resize + normalize (native/),
        written into a pinned buffer (or, with ``device_preprocess``, the
        raw uint8 batch, resized on the device)
  device: PersNet forward -> per-size postprocess back to the input size
  host: one asynchronous copy per output into pinned memory, one wait

With more than one local CUDA device the batch is split over a replica of
the model on each (``forward_split``), as the JAX package shards it over
its local devices; with one the path is unchanged.

Outputs are numpy, channels-last unless ``channels_first=True``. On a CUDA
device they are views of page-locked blocks of PyTorch's caching host
allocator, each call's own: what a caller keeps stays page-locked until it
is dropped (``inference_batch`` says how much).
"""

from __future__ import annotations

import collections
import copy
import os
import pickle
import warnings
import zipfile
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from .config import ModelConfig, model_zoo

from . import native
from .checkpoint import load_into, load_npz, load_released, state_dict_from_jax
from .models import PersNet
from .models.common import init_random_
from .ops.image import make_resize, resize_bilinear
from .ops.postprocess import postprocess_gravity, postprocess_latitude
from .utils.profiling import trace

_WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "perspectivefields_tpu", "weights",
)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Errors that mean "this weights file is malformed" (truncated, wrong
# format): the only ones for which a cached file is renamed ``.corrupt``.
# Environmental failures (MemoryError, OSError) propagate, so a valid file
# is never quarantined over a transient problem. A copy of
# perspectivefields_tpu/api.py:_PARSE_ERRORS.
_PARSE_ERRORS = (
    KeyError,
    ValueError,
    RuntimeError,
    EOFError,
    zipfile.BadZipFile,
    pickle.UnpicklingError,
)


def _resolve_device(device) -> torch.device:
    """``device`` (None: "cuda"); a CUDA device without an index resolves to
    the current one, and CUDA raises where there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "PerspectiveFields: no CUDA device found; pass device='cpu' "
                "to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def local_replica_devices(requested, device: torch.device) -> list[torch.device] | None:
    """The local CUDA devices a model on ``device`` splits its batches over
    (JAX's ``_data_mesh`` over ``jax.local_devices()``): every one, the
    model's own first, when the caller asked for CUDA without naming a
    device (``requested`` None or "cuda") and there are several; else None.
    A caller that names a device, as "cuda:1", keeps every batch on it."""
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if n <= 1 or torch.device(requested if requested is not None else "cuda").index is not None:
        return None
    return [device] + [torch.device("cuda", i) for i in range(n) if i != device.index]


class _LRUCache:
    """Bounded LRU of per-input-size device operands (a copy of
    perspectivefields_tpu/api.py:_LRUCache): a long-lived service that sees
    many image sizes keeps at most ``maxsize``; evicted ones are rebuilt on
    next use."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self._d: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, make):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        val = make()
        self._d[key] = val
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
        return val

    def __len__(self) -> int:
        return len(self._d)


def host_buffer(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An uninitialised host tensor to stage a transfer to or from
    ``device``: pinned (PyTorch's caching host allocator) for a CUDA device,
    so the copy is asynchronous, plain memory for the CPU."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def copy_to_host(tensors: Mapping) -> tuple[dict, torch.cuda.Event | None]:
    """Issue one non_blocking device-to-host copy per tensor, each into a new
    pinned tensor, and record an event after them on the current stream.
    Returns the host tensors and the event (None for CPU tensors, which are
    returned as they are). Read the host tensors only after
    ``event.synchronize()``. Each copy is fresh storage that lives as long as
    a view of it does, so results handed out never share a buffer with a
    later call's. The span ``pf.copy_out``."""
    with trace("pf.copy_out"):
        if all(t.device.type == "cpu" for t in tensors.values()):
            return dict(tensors), None
        host = {}
        for key, t in tensors.items():
            host[key] = host_buffer(t.shape, t.dtype, t.device)
            host[key].copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event


def _load_file(model: PersNet, path: str) -> None:
    """A JAX ``.npz`` (strict: every name) or a released ``.pth`` (the
    reference's strict=False rule) into ``model``."""
    if path.endswith(".npz"):
        model.load_state_dict(load_npz(path), strict=True)
    else:
        load_into(model, load_released(path))


class ResizeTransform:
    """The reference's resize (perspectivefields.py:16-67), numpy in and
    numpy out: PIL-exact bilinear for uint8 (``native.pil_resize_uint8``),
    torch bilinear for float (``ops.image.resize_bilinear`` in float32 on
    the CPU). 2-D and 1-channel images come back in their own shape. Port
    of perspectivefields_tpu/api.py:ResizeTransform."""

    def __init__(self, new_h: int, new_w: int):
        self.new_h = new_h
        self.new_w = new_w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        if img.dtype == np.uint8:
            squeeze = img.ndim == 3 and img.shape[2] == 1
            arr = img[:, :, 0] if squeeze else img
            out = native.pil_resize_uint8(np.ascontiguousarray(arr), self.new_h, self.new_w)
            return out[:, :, None] if squeeze else out
        arr = np.asarray(img, np.float32)
        squeeze = arr.ndim == 2
        if squeeze:
            arr = arr[:, :, None]
        out = resize_bilinear(torch.from_numpy(np.ascontiguousarray(arr)), self.new_h, self.new_w,
                              "torch_bilinear").numpy()
        return out[:, :, 0] if squeeze else out


class PerspectiveFields:
    """Single-image camera calibration model.

    Args:
        version: a ``model_zoo`` key, or "custom" with ``config``.
        params: None (in perspectivefields_tpu/weights/, a JAX
            ``<version>.npz`` if present, then a released ``<version>.pth``;
            a cached file that fails to parse is renamed ``.corrupt`` with
            a warning and the next one is tried; else seeded random weights
            with a warning), a path to a JAX ``.npz`` or a released
            ``.pth`` (not guarded), a JAX param tree ({"params": ...}), or
            a torch state dict.
        compute_dtype: "float32" or "bfloat16"; bfloat16 stores the weights
            in bfloat16, as the JAX package's serving form does.
        device: torch device; None means "cuda" and raises without one.
            "cuda" resolves to the current CUDA device, as "cuda:0".
        use_kernels: route eligible attention blocks to the CUDA kernel.
            None means "on a CUDA device, in bfloat16".
        fuse_ffn / fuse_convnext / fuse_block: run every MixFFN / every
            ParamNet ConvNeXt block / every MiT block that JAX's
            ``fuse_block`` fuses (at 320^2 the 21 blocks of stages 3-4) as
            one fused kernel (the CUDA kernels on a CUDA device, their plain
            versions on the CPU); the same state dict. With ``use_kernels``,
            ``fuse_block`` also sends stage 1's one-head attention to its
            CUDA kernel. Inference only; off by default, as in the JAX
            package.
        device_preprocess: resize a uniform uint8 batch on the device (the
            uint8 images cross to the device, are cast to float32 and
            resized with the float "pil_bilinear" taps, within 1 LSB of the
            host's bit-exact PIL resize) instead of on the host. Mixed sizes
            and float images take the host path.

    ``replica_devices`` (an attribute, set after construction) lists the
    devices the forward splits each batch over (``forward_split``): by
    default, when ``device`` names no index, every local CUDA device where
    there are several, the model's own first; else None (one device, no
    split).

    On a CUDA device the network's forward replays a CUDA graph, one per
    input signature (the batch's shape and dtype), from the signature's
    second call on (``models.graphed``): one launch where eager issues
    ~1,120. The copy in and the device normalize stay eager. Each graph
    holds the forward's peak of intermediates and its outputs on the
    device, in one pool a model, at most four signatures; the results are
    fresh tensors, bit for bit the eager forward's. Calls with a forward
    hook on a submodule, in training or with grad on run eager. Threads may
    share one instance: one model's replays take turns under its lock.
    """

    def __init__(
        self,
        version: str = "Paramnet-360Cities-edina-centered",
        params=None,
        config: ModelConfig | None = None,
        compute_dtype: str = "float32",
        device=None,
        use_kernels: bool | None = None,
        fuse_ffn: bool = False,
        fuse_convnext: bool = False,
        fuse_block: bool = False,
        device_preprocess: bool = False,
    ):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")
        self.dtype = _DTYPES[compute_dtype]
        self.device = _resolve_device(device)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda" and self.dtype == torch.bfloat16
        if config is None:
            if version not in model_zoo:
                raise ValueError(f"unknown version {version!r}; known: {list(model_zoo)}")
            config = model_zoo[version]["config"]
        self.version = version
        self.cfg = config
        self.param_on = config.param_on
        self.input_format = config.input_format
        self.use_kernels = use_kernels
        self.fuse_ffn, self.fuse_convnext, self.fuse_block = fuse_ffn, fuse_convnext, fuse_block
        self.device_preprocess = device_preprocess
        self._resize_cache = _LRUCache(16)

        model = PersNet(
            config, use_kernels=use_kernels, fuse_ffn=fuse_ffn, fuse_convnext=fuse_convnext,
            fuse_block=fuse_block,
        )
        self._load_params(model, params)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self._pixel_mean = np.asarray(config.pixel_mean, np.float32)
        self._pixel_std = np.asarray(config.pixel_std, np.float32)
        self._mean = torch.tensor(self._pixel_mean, device=self.device)
        self._std = torch.tensor(self._pixel_std, device=self.device)
        self.replica_devices = local_replica_devices(device, self.device)
        self._replicas: dict[int, tuple] = {}

    # ------------------------------------------------------------------ setup

    def _load_params(self, model: PersNet, params) -> None:
        if params is None:
            # JAX's order (perspectivefields_tpu/api.py:_init_params): the
            # converted .npz, then a side-loaded .pth. A corrupt cached file
            # must not brick the constructor: warn, quarantine, fall through.
            for cand in (
                os.path.join(_WEIGHTS_DIR, f"{self.version}.npz"),
                os.path.join(_WEIGHTS_DIR, f"{self.version}.pth"),
            ):
                if not os.path.exists(cand):
                    continue
                saved = {k: v.clone() for k, v in model.state_dict().items()}
                try:
                    _load_file(model, cand)
                    return
                except _PARSE_ERRORS as exc:
                    model.load_state_dict(saved)  # undo a partial load
                    quarantined = cand + ".corrupt"
                    try:
                        os.replace(cand, quarantined)
                    except OSError:
                        quarantined = cand
                    warnings.warn(
                        f"cached weights {cand} failed to load ({exc!r}); "
                        f"moved to {quarantined} and continuing",
                        stacklevel=3,
                    )
            warnings.warn(
                f"No weights found for {self.version!r} (looked in {_WEIGHTS_DIR} for "
                f"{self.version}.npz and .pth); using seeded random initialization — "
                "fields will be meaningless.",
                stacklevel=3,
            )
            init_random_(model, seed=0)
        elif isinstance(params, (str, os.PathLike)):
            _load_file(model, str(params))
        elif isinstance(params, Mapping) and "params" in params:
            model.load_state_dict(state_dict_from_jax(params), strict=True)
        else:
            model.load_state_dict(params, strict=True)

    @staticmethod
    def versions():
        """Print the model zoo (reference perspectivefields.py:169-173)."""
        for key, entry in model_zoo.items():
            print(key)
            print(f"   - {entry['description']}")

    # ---------------------------------------------------------------- forward

    def _network(self, model: PersNet, images: torch.Tensor, device: torch.device,
                 prenormalized: bool) -> dict[str, torch.Tensor]:
        """``model`` on ``images`` moved to ``device`` (asynchronously from
        pinned memory), normalized there unless ``prenormalized``. The span
        ``pf.forward``."""
        with trace("pf.forward"):
            x = images.to(device, non_blocking=True)
            if not prenormalized:
                mean, std = (self._mean, self._std) if device == self.device else (
                    self._mean.to(device), self._std.to(device))
                x = (x.to(torch.float32) - mean) / std
            return model(x.to(self.dtype))

    @torch.inference_mode()
    def _forward_fn(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """Raw predictions of unnormalized uint8 or float BGR images at the
        network size, (B, H, W, 3) on any device: moved to the model's
        device (asynchronously from pinned memory) and normalized there;
        split over ``replica_devices`` where set."""
        if self.replica_devices:
            return self.forward_split(images, self.replica_devices)
        return self._network(self.model, images, self.device, False)

    @torch.inference_mode()
    def _forward_prenormalized_fn(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """Raw predictions of already-normalized float images."""
        if self.replica_devices:
            return self.forward_split(images, self.replica_devices, prenormalized=True)
        return self._network(self.model, images, self.device, True)

    def _replica(self, i: int, device: torch.device) -> PersNet:
        """The model on the i-th device of a split: the model itself for a
        first device that is its own, else a copy, made again when the
        model's parameters have changed since (an in-place write bumps a
        tensor's version; a new model or parameter changes its identity)."""
        if i == 0 and device == self.device:
            return self.model
        key = (device, id(self.model)) + tuple((id(p), p._version) for p in self.model.parameters())
        cached = self._replicas.get(i)
        if cached is None or cached[0] != key:
            cached = (key, copy.deepcopy(self.model).to(device))
            self._replicas[i] = cached
        return cached[1]

    @torch.inference_mode()
    def forward_split(self, images: torch.Tensor, devices, prenormalized: bool = False
                      ) -> dict[str, torch.Tensor]:
        """Raw predictions of a (B, H, W, 3) batch split over a replica of
        the model on each of ``devices`` (a device may repeat: each entry
        holds its own replica), gathered on the model's device. The tail is
        zero-padded to a multiple of the device count and sliced back off,
        as JAX's ``_forward_batched`` does. Every replica's forward is
        issued before any result is read."""
        devices = [_resolve_device(d) for d in devices]
        b = images.shape[0]
        pad = (-b) % len(devices)
        if pad:
            images = torch.cat([images, images.new_zeros((pad, *images.shape[1:]))])
        outs = [
            self._network(self._replica(i, dev), rows, dev, prenormalized)
            for i, (dev, rows) in enumerate(zip(devices, images.chunk(len(devices))))
        ]
        return {k: torch.cat([o[k].to(self.device, non_blocking=True) for o in outs])[:b]
                for k in outs[0]}

    def forward(self, images_nhwc) -> dict[str, torch.Tensor]:
        """Raw forward on an already-resized (B, H, W, 3) BGR batch
        (unnormalized, numpy or tensor); returns device tensors."""
        return self._forward_fn(torch.as_tensor(images_nhwc))

    def _device_resize(self, in_h: int, in_w: int):
        """The device resize of (B, in_h, in_w, 3) uint8 images to the
        network size, its operands cached per input size."""
        return self._resize_cache.get(
            (in_h, in_w),
            lambda: make_resize((in_h, in_w), self.cfg.resize, "pil_bilinear", self.device),
        )

    # -------------------------------------------------------------- inference

    def _preprocess_host(self, img_bgr: np.ndarray) -> np.ndarray:
        if self.input_format == "RGB":
            img_bgr = img_bgr[:, :, ::-1]
        h, w = self.cfg.resize
        if img_bgr.dtype == np.uint8:
            return native.pil_resize_uint8(img_bgr, h, w).astype(np.float32)
        # float input: torch-bilinear semantics (perspectivefields.py:47-66)
        x = torch.from_numpy(np.ascontiguousarray(img_bgr, np.float32))
        return resize_bilinear(x, h, w).numpy()

    def inference(self, img_bgr: np.ndarray, channels_first: bool = False) -> dict:
        """Fields (+ camera parameters) for one BGR image (HWC uint8).

        Every output array is float32 numpy in every compute dtype: in
        bfloat16 the network-size fields (``pred_gravity``,
        ``pred_latitude``) and the camera parameters are upcast, where the
        JAX package returns them as bfloat16; the ``_original`` fields are
        float32 in both."""
        return self.inference_batch([img_bgr], channels_first)[0]

    def inference_batch(
        self, img_bgr_list: Sequence[np.ndarray], channels_first: bool = False
    ) -> list[dict]:
        """Batched inference; images may have mixed sizes (postprocess is
        grouped by original size). Outputs are float32 numpy in every
        compute dtype, as ``inference`` says; each call's arrays are its
        own (no later call writes into them).

        On a CUDA device the arrays are views of the pinned blocks the
        outputs were copied into, and each block goes back to PyTorch's
        caching host allocator when the last view of it is dropped. Results
        that a caller keeps therefore hold page-locked memory: a B=32 call
        on 640x640 images holds 240 MiB (its 196 MB of outputs in blocks
        rounded up to powers of two). Copy what is kept for long
        (``np.array(a)``), or stream through ``serving.BatchPredictor``,
        which hands out pageable arrays. Handing out the pinned blocks
        spares each call the page faults of fresh pageable memory."""
        with trace("pf.call"):
            first = img_bgr_list[0]
            n = len(img_bgr_list)
            h, w = self.cfg.resize
            uniform_u8 = all(
                img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
                and img.shape == first.shape
                for img in img_bgr_list
            )
            flip = self.input_format == "RGB"
            if self.device_preprocess and uniform_u8:
                with trace("pf.preprocess"):
                    buf = host_buffer((n, *first.shape), torch.uint8, self.device)
                    np.stack([img[:, :, ::-1] if flip else img for img in img_bgr_list],
                             out=buf.numpy())
                x = buf.to(self.device, non_blocking=True)
                raw = self._forward_fn(self._device_resize(*first.shape[:2])(x))
            elif uniform_u8:
                # native fused resize + normalize, gathered from the frames
                # straight into the pinned buffer
                with trace("pf.preprocess"):
                    buf = host_buffer((n, h, w, 3), torch.float32, self.device)
                    native.preprocess_list(
                        img_bgr_list, h, w, self._pixel_mean, self._pixel_std, bgr_flip=flip,
                        out=buf.numpy(),
                    )
                raw = self._forward_prenormalized_fn(buf)
            else:
                with trace("pf.preprocess"):
                    buf = host_buffer((n, h, w, 3), torch.float32, self.device)
                    np.stack([self._preprocess_host(img) for img in img_bgr_list], out=buf.numpy())
                raw = self._forward_fn(buf)
            return self._package_results(raw, [img.shape[:2] for img in img_bgr_list],
                                         channels_first)

    @torch.inference_mode()
    def _package_results(self, raw, sizes, channels_first: bool) -> list[dict]:
        """Issue all device work first (each size group's postprocess, the
        float32 casts), then one asynchronous copy per output into pinned
        memory, wait once, and only then split the batch into per-image
        numpy views (the spans ``pf.postprocess``, ``pf.copy_out``,
        ``pf.wait`` and ``pf.unpack``)."""
        cfg = self.cfg
        with trace("pf.postprocess"):
            by_size: dict[tuple, list[int]] = {}
            for i, s in enumerate(sizes):
                by_size.setdefault(tuple(s), []).append(i)
            dev = {k: v.float() for k, v in raw.items()}
            post: dict[tuple, dict[str, torch.Tensor]] = {}
            for (oh, ow), idxs in by_size.items():
                if len(by_size) == 1:
                    group = dev
                else:
                    sel = torch.tensor(idxs, device=self.device)
                    group = {k: v[sel] for k, v in dev.items()
                             if k in ("pred_gravity", "pred_latitude")}
                out = {}
                if "pred_gravity" in group:
                    out["pred_gravity_original"] = postprocess_gravity(
                        group["pred_gravity"], cfg.resize, oh, ow,
                        cfg.gravity.loss_type, cfg.gravity.num_classes,
                    )
                if "pred_latitude" in group:
                    out["pred_latitude_original"] = postprocess_latitude(
                        group["pred_latitude"], cfg.resize, oh, ow,
                        cfg.latitude.loss_type, cfg.latitude.num_classes,
                    )
                post[(oh, ow)] = out
            flat = dict(dev)
            flat.update({(s, k): v for s, out in post.items() for k, v in out.items()})
        pinned, event = copy_to_host(flat)
        with trace("pf.wait"):
            if event is not None:
                event.synchronize()
        with trace("pf.unpack"):
            host = {k: v.numpy() for k, v in pinned.items()}

            results: list[dict] = []
            for i, s in enumerate(sizes):
                res: dict = {}
                for key in ("pred_gravity", "pred_latitude"):
                    if key in host:
                        res[key] = self._export(host[key][i], channels_first)
                if self.param_on:
                    for key in dev:
                        val = host[key]
                        if key.startswith("pred_") and val.ndim == 1 or key == "pred_rel_pp":
                            res[key] = np.asarray(val[i])
                j = by_size[tuple(s)].index(i)
                if (tuple(s), "pred_gravity_original") in host:
                    res["pred_gravity_original"] = self._export(
                        host[(tuple(s), "pred_gravity_original")][j], channels_first
                    )
                if (tuple(s), "pred_latitude_original") in host:
                    res["pred_latitude_original"] = host[(tuple(s), "pred_latitude_original")][j]
                    res["pred_latitude_original_mode"] = "deg"
                results.append(res)
            return results

    @staticmethod
    def _export(a: np.ndarray, channels_first: bool) -> np.ndarray:
        return np.moveaxis(a, -1, 0) if channels_first and a.ndim == 3 else a
