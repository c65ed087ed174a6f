"""Streaming batched serving: host preprocess pipelined with device compute.

Port of perspectivefields_tpu/serving.py on PyTorch and CUDA. A batch goes

  host:    native PIL-exact resize (OpenMP), gathered from the callers'
           frames straight into a pinned input slot;
  to card: a non_blocking copy from the slot on the current stream (the
           slot is written again only after that copy's event completes);
  device:  the forward and the output pack on the same stream, then one
           non_blocking copy per output into new pinned host tensors and an
           event recorded after them;
  drain:   a wait on that batch's event alone, then the decode to float32
           numpy in pageable memory (the pinned blocks go back to PyTorch's
           caching host allocator, so page-locked memory stays bounded by
           the batches in flight, however many results the caller keeps).

The host returns as soon as a batch is issued, so with up to ``depth``
batches in flight the host's preprocess of the next batches overlaps the
device's forward and copies of the earlier ones. One stream carries all of
a batch's work, so the caching allocator's stream order keeps every device
buffer alive until the copies that read it are done. On a CPU model every
step runs on the CPU in order.

Wire format: ``wire="u8"`` (default) resizes on the host but keeps uint8
and normalizes on the device (4x fewer bytes to the card than float32);
``wire="f32"`` runs the fused native resize + normalize and ships float32.

Output wire: ``out_wire="f16"`` halves the bytes read back (float outputs
cast to float16 on the device); ``"u8"`` packs the [-1, 1]-bounded dense
fields (``pred_gravity`` unit vectors, ``pred_latitude`` clamped
sin-latitude) as round((clip(x, -1, 1) + 1) * 127.5), a quarter of the
bytes, and sends other float outputs as f16. Results are decoded back to
float32 on the host.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator, Sequence

import numpy as np
import torch

from . import native
from .api import PerspectiveFields, copy_to_host, host_buffer
from .utils.profiling import StageTimer

# Outputs bounded in [-1, 1] by construction: pred_gravity is a per-pixel
# unit up-vector (reference F.normalize, gravity_head.py:196) and
# pred_latitude is sin(latitude) hard-clamped to [-1, 1]
# (latitude_head.py:192): eligible for fixed-point u8 on the output wire.
_UNIT_RANGE_KEYS = frozenset({"pred_gravity", "pred_latitude"})
_U8_SCALE = 127.5


class BatchPredictor:
    """Streaming predictor over same-sized uint8 BGR images.

    Args:
        model: a PerspectiveFields instance (CUDA or CPU).
        batch_size: device batch; the tail batch is padded by repeating the
            last frame's pointer, and the padded rows are dropped.
        wire: "u8" (host resize, uint8 to the device, normalize there) or
            "f32" (fused host resize + normalize, float32 to the device).
        select: optional subset of output keys to return per image (e.g.
            ("pred_roll", "pred_pitch", "pred_general_vfov") for a
            camera-parameter service). Unselected outputs are never copied
            to the host.
        out_wire: device-to-host encoding. None / "f32" reads back float32
            (integer outputs as they are); "f16" casts float outputs to
            float16 on the device (half the bytes, ~5e-4 absolute error on
            unit-range fields); "u8" packs pred_gravity and pred_latitude
            into fixed-point uint8 (a quarter of the bytes) and uses f16
            for other float outputs. u8 quantizes at 1/255 a channel, up to
            about 0.23 degrees of up-vector angle: more than the repository's
            0.1-degree field tolerance, so it is for services whose users
            accept that step. Arrays are decoded to float32 on the host.
        depth: batches in flight before the host waits for the oldest.
            Each batch's device-to-host copies are issued when it is
            dispatched, so with depth > 1 the readback of batch k overlaps
            the preprocess and dispatch of batches k+1..k+depth.
    """

    def __init__(
        self,
        model: PerspectiveFields,
        batch_size: int = 64,
        wire: str = "u8",
        select: Sequence[str] | None = None,
        depth: int = 2,
        out_wire: str | None = None,
    ):
        if wire not in ("u8", "f32"):
            raise ValueError(f"wire must be 'u8' or 'f32', got {wire!r}")
        if out_wire not in (None, "f32", "f16", "u8"):
            raise ValueError(f"out_wire must be None, 'f32', 'f16' or 'u8', got {out_wire!r}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.model = model
        self.batch_size = batch_size
        self.timer = StageTimer()
        self.wire = wire
        self.select = tuple(select) if select is not None else None
        self.depth = depth
        self.out_wire = None if out_wire == "f32" else out_wire
        self._pack_modes: dict[str, str] = {}  # key -> "u8" | "f16" | "f32" | "raw"
        # u8 wire: the forward normalizes on the device; f32 wire: the host's
        # fused native preprocess already did
        self._fwd = model._forward_fn if wire == "u8" else model._forward_prenormalized_fn
        self._slots: list[list] = []  # ring of [pinned input batch, event of its last copy]
        self._next_slot = 0

    def _slot(self) -> list:
        """The next input slot of a ring of depth + 1, once its last
        host-to-device copy has completed."""
        if not self._slots:
            h, w = self.model.cfg.resize
            dtype = torch.uint8 if self.wire == "u8" else torch.float32
            self._slots = [[host_buffer((self.batch_size, h, w, 3), dtype, self.model.device), None]
                           for _ in range(self.depth + 1)]
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot[1] is not None:
            slot[1].synchronize()
        return slot

    def _preprocess(self, frames: list[np.ndarray], out: np.ndarray) -> np.ndarray:
        """Frames -> ``out``, the device-ready batch padded to batch_size:
        a gather-resize straight from the callers' frame buffers (the native
        pointer-array entry points), with no stacking copy of the frames."""
        h, w = self.model.cfg.resize
        flip = self.model.input_format == "RGB"
        if self.wire == "u8":
            return native.resize_list_u8(frames, h, w, bgr_flip=flip, pad_to=self.batch_size, out=out)
        return native.preprocess_list(
            frames, h, w, self.model._pixel_mean, self.model._pixel_std,
            bgr_flip=flip, pad_to=self.batch_size, out=out,
        )

    def _modes(self, out: dict[str, torch.Tensor]) -> dict[str, str]:
        modes = {}
        for k, v in out.items():
            if not v.is_floating_point():
                modes[k] = "raw"
            elif self.out_wire == "u8" and k in _UNIT_RANGE_KEYS:
                modes[k] = "u8"
            else:
                modes[k] = "f32" if self.out_wire is None else "f16"
        return modes

    def _pack(self, out: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The outputs as they cross to the host, encoded on the device."""
        if set(self._pack_modes) != set(out):
            self._pack_modes = self._modes(out)
        packed = {}
        for k, v in out.items():
            mode = self._pack_modes[k]
            if mode == "u8":
                x = v.float().clamp(-1.0, 1.0)
                packed[k] = ((x + 1.0) * _U8_SCALE).round().to(torch.uint8)
            elif mode == "f16":
                packed[k] = v.to(torch.float16)
            elif mode == "f32":
                packed[k] = v.float()
            else:
                packed[k] = v
        return packed

    def _decode_host(self, key: str, v: torch.Tensor) -> np.ndarray:
        """A host tensor as it crossed -> float32 numpy in pageable memory
        (integer outputs as they are). PyTorch's vectorised host ops give the
        bits of JAX's numpy decode, v.astype(float32) / 127.5 - 1.0, several
        times faster."""
        mode = self._pack_modes.get(key, "raw")
        if mode == "u8":
            return v.float().div_(_U8_SCALE).sub_(1.0).numpy()
        if mode == "f16":
            return v.float().numpy()
        if v.is_pinned():  # its block goes back to the caching host allocator
            v = torch.empty(v.shape, dtype=v.dtype).copy_(v)
        return v.numpy()

    def _dispatch(self, x: torch.Tensor) -> tuple[dict, torch.cuda.Event | None]:
        """Issue one batch's forward, pack and device-to-host copies."""
        with torch.inference_mode():
            out = self._fwd(x)
            if self.select is not None:
                missing = [k for k in self.select if k not in out]
                if missing:
                    raise ValueError(
                        f"select keys {missing} not in the model's outputs {sorted(out)}: "
                        "e.g. pred_roll/pitch need a ParamNet-enabled version"
                    )
                out = {k: out[k] for k in self.select}
            return copy_to_host(self._pack(out))

    def predict_iter(self, images: Iterable[np.ndarray]) -> Iterator[dict[str, np.ndarray]]:
        """Yields one raw-prediction dict per image (network resolution,
        float32 numpy), keeping up to ``depth`` batches in flight."""
        images = iter(images)
        inflight: list = []  # [(host tensors, event, count), ...] oldest first

        def batches():
            buf: list[np.ndarray] = []
            for img in images:
                buf.append(img)
                if len(buf) == self.batch_size:
                    yield buf
                    buf = []
            if buf:
                yield buf

        device = self.model.device
        for frames in batches():
            count = len(frames)
            with self.timer.stage("preprocess", count):
                slot = self._slot()
                self._preprocess(frames, slot[0].numpy())
            with self.timer.stage("dispatch", count):
                x = slot[0].to(device, non_blocking=True)
                if device.type == "cuda":
                    slot[1] = torch.cuda.Event()
                    slot[1].record()
                host, event = self._dispatch(x)
            inflight.append((host, event, count))
            if len(inflight) > self.depth:
                yield from self._drain(*inflight.pop(0))
        while inflight:
            yield from self._drain(*inflight.pop(0))

    def _drain(self, host: dict, event, count: int) -> Iterator[dict[str, np.ndarray]]:
        with self.timer.stage("device_wait", count):
            if event is not None:
                event.synchronize()  # this batch's copies only
        with self.timer.stage("decode", count):
            arrays = {k: self._decode_host(k, v) for k, v in host.items()}
        for i in range(count):
            yield {k: v[i] for k, v in arrays.items()}

    def predict(self, images: list[np.ndarray]) -> list[dict[str, np.ndarray]]:
        return list(self.predict_iter(images))
