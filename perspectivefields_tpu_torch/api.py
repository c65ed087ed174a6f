"""Public API of the port: ``PerspectiveFields`` on PyTorch and CUDA.

The same user surface and output contract as perspectivefields_tpu/api.py
(reference perspectivefields.py:121-272):

  host: uint8 BGR images -> PIL-exact bilinear resize + normalize (native/)
  device: PersNet forward -> per-size postprocess back to the input size

Outputs are numpy, channels-last unless ``channels_first=True``.
"""

from __future__ import annotations

import os
import warnings
from collections.abc import Mapping, Sequence

import numpy as np
import torch

from .config import ModelConfig, model_zoo

from . import native
from .checkpoint import load_into, load_released, state_dict_from_jax
from .models import PersNet
from .models.common import init_random_
from .ops.image import resize_bilinear
from .ops.postprocess import postprocess_gravity, postprocess_latitude

_WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "perspectivefields_tpu", "weights",
)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "PerspectiveFields: no CUDA device found; pass device='cpu' "
                "to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


class PerspectiveFields:
    """Single-image camera calibration model.

    Args:
        version: a ``model_zoo`` key, or "custom" with ``config``.
        params: None (a released ``<version>.pth`` in
            perspectivefields_tpu/weights/ if present, else seeded random
            weights with a warning), a path to a released ``.pth``, a JAX
            param tree ({"params": ...}), or a torch state dict.
        compute_dtype: "float32" or "bfloat16"; bfloat16 stores the weights
            in bfloat16, as the JAX package's serving form does.
        device: torch device; None means "cuda" and raises without one.
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

    # ------------------------------------------------------------------ setup

    def _load_params(self, model: PersNet, params) -> None:
        if params is None:
            released = os.path.join(_WEIGHTS_DIR, f"{self.version}.pth")
            if os.path.exists(released):
                load_into(model, load_released(released))
                return
            warnings.warn(
                f"No weights found for {self.version!r} (looked for {released}); "
                "using seeded random initialization — fields will be meaningless.",
                stacklevel=3,
            )
            init_random_(model, seed=0)
        elif isinstance(params, (str, os.PathLike)):
            load_into(model, load_released(params))
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

    @torch.inference_mode()
    def _run(self, net_in: torch.Tensor, prenormalized: bool) -> dict[str, torch.Tensor]:
        x = net_in.to(self.device, non_blocking=True).to(torch.float32)
        if not prenormalized:
            x = (x - self._mean) / self._std
        return self.model(x.to(self.dtype))

    def forward(self, images_nhwc) -> dict[str, torch.Tensor]:
        """Raw forward on an already-resized (B, H, W, 3) BGR batch
        (unnormalized, numpy or tensor); returns device tensors."""
        return self._run(torch.as_tensor(images_nhwc), prenormalized=False)

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
        """Fields (+ camera parameters) for one BGR image (HWC uint8)."""
        return self.inference_batch([img_bgr], channels_first)[0]

    def inference_batch(
        self, img_bgr_list: Sequence[np.ndarray], channels_first: bool = False
    ) -> list[dict]:
        """Batched inference; images may have mixed sizes (postprocess is
        grouped by original size)."""
        first = img_bgr_list[0]
        uniform_u8 = all(
            img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
            and img.shape == first.shape
            for img in img_bgr_list
        )
        if uniform_u8:
            h, w = self.cfg.resize
            net_in = native.preprocess_batch(
                np.stack(img_bgr_list), h, w, self._pixel_mean, self._pixel_std,
                bgr_flip=self.input_format == "RGB",
            )
            raw = self._run(torch.from_numpy(net_in), prenormalized=True)
        else:
            net_in = np.stack([self._preprocess_host(img) for img in img_bgr_list])
            raw = self._run(torch.from_numpy(net_in), prenormalized=False)
        return self._package_results(raw, [img.shape[:2] for img in img_bgr_list], channels_first)

    @torch.inference_mode()
    def _package_results(self, raw, sizes, channels_first: bool) -> list[dict]:
        cfg = self.cfg
        by_size: dict[tuple, list[int]] = {}
        for i, s in enumerate(sizes):
            by_size.setdefault(tuple(s), []).append(i)
        post: dict[tuple, dict[str, np.ndarray]] = {}
        for (oh, ow), idxs in by_size.items():
            sel = torch.tensor(idxs, device=self.device)
            group = {}
            if "pred_gravity" in raw:
                group["pred_gravity_original"] = postprocess_gravity(
                    raw["pred_gravity"][sel].float(), cfg.resize, oh, ow,
                    cfg.gravity.loss_type, cfg.gravity.num_classes,
                ).cpu().numpy()
            if "pred_latitude" in raw:
                group["pred_latitude_original"] = postprocess_latitude(
                    raw["pred_latitude"][sel].float(), cfg.resize, oh, ow,
                    cfg.latitude.loss_type, cfg.latitude.num_classes,
                ).cpu().numpy()
            post[(oh, ow)] = group
        host = {k: v.float().cpu().numpy() for k, v in raw.items()}

        results: list[dict] = []
        for i, s in enumerate(sizes):
            res: dict = {}
            for key in ("pred_gravity", "pred_latitude"):
                if key in host:
                    res[key] = self._export(host[key][i], channels_first)
            if self.param_on:
                for key, val in host.items():
                    if key.startswith("pred_") and val.ndim == 1 or key == "pred_rel_pp":
                        res[key] = np.asarray(val[i])
            group = post[tuple(s)]
            j = by_size[tuple(s)].index(i)
            if "pred_gravity_original" in group:
                res["pred_gravity_original"] = self._export(
                    group["pred_gravity_original"][j], channels_first
                )
            if "pred_latitude_original" in group:
                res["pred_latitude_original"] = group["pred_latitude_original"][j]
                res["pred_latitude_original_mode"] = "deg"
            results.append(res)
        return results

    @staticmethod
    def _export(a: np.ndarray, channels_first: bool) -> np.ndarray:
        return np.moveaxis(a, -1, 0) if channels_first and a.ndim == 3 else a
