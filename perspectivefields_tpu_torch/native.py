"""ctypes binding to the repository's native preprocess library (native/).

The same library as the JAX package's (``make -C native`` builds
``native/libpf_preprocess.so``): batched bit-exact PIL bilinear resize plus
normalize on the host, with OpenMP, from a stacked batch or from a list of
separate frames (a pointer array: no stacking copy of the raw frames). If it
cannot be built or loaded, the port's numpy ``pil_resize_uint8`` does the
same work, bit for bit, slower. ``backend()`` says which one runs.

Every batch function takes an optional ``out=``: a C-contiguous, writable
numpy array of the result's shape and dtype that the result is written into
(for example the ``.numpy()`` view of a pinned ``torch.empty(...,
pin_memory=True)``, so that the host writes straight into the buffer the
host-to-device copy reads).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

from .ops.image import pil_resize_uint8 as _np_resize

_DIR = Path(__file__).resolve().parent.parent / "native"
_SO = _DIR / "libpf_preprocess.so"
_lock = threading.Lock()
_lib = None
_tried = False

_P = ctypes.c_void_p
_I = ctypes.c_int
_PTRS = ctypes.POINTER(ctypes.c_void_p)
# native/pf_preprocess.cpp's exports: (argtypes, restype)
_SIGNATURES = {
    "pf_pil_resize_u8": ([_P, _I, _I, _I, _P, _I, _I], None),
    "pf_preprocess_batch": ([_P, _I, _I, _I, _P, _I, _I, _P, _P, _I], None),
    "pf_resize_batch_u8": ([_P, _I, _I, _I, _P, _I, _I, _I], None),
    "pf_resize_batch_u8_ptrs": ([_PTRS, _I, _I, _I, _P, _I, _I, _I], None),
    "pf_preprocess_batch_ptrs": ([_PTRS, _I, _I, _I, _P, _I, _I, _P, _P, _I], None),
    "pf_num_threads": ([], ctypes.c_int),
}


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        # make first: a no-op when the .so is current, a rebuild when stale.
        # If the environment's CXX cannot build it (e.g. a compiler without
        # OpenMP's libgomp), retry with the Makefile's own default, g++.
        for args in ([], ["CXX=g++"]):
            try:
                subprocess.run(["make", "-C", str(_DIR), *args], check=True, capture_output=True)
                break
            except (OSError, subprocess.CalledProcessError):
                continue
        if not _SO.exists():
            return None
        try:
            lib = ctypes.CDLL(str(_SO))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
        except (OSError, AttributeError):
            return None
        _lib = lib
        return _lib


def backend() -> str:
    """'native' when the C++ library is loaded, else 'numpy'."""
    return "native" if _load() is not None else "numpy"


def num_threads() -> int:
    """The native library's OpenMP thread count (1 on the numpy path)."""
    lib = _load()
    return lib.pf_num_threads() if lib is not None else 1


def _out(out, shape, dtype) -> np.ndarray:
    """``out`` checked against the result's shape and dtype, or a new array:
    the native code writes through its pointer, so a wrong one would be an
    out-of-bounds write."""
    if out is None:
        return np.empty(shape, dtype)
    if (out.shape != tuple(shape) or out.dtype != dtype or not out.flags.c_contiguous
            or not out.flags.writeable):
        raise ValueError(
            f"out must be a writable C-contiguous {np.dtype(dtype)} array of shape "
            f"{tuple(shape)}, got {out.dtype} {out.shape}"
        )
    return out


def _check_batch(imgs: np.ndarray, name: str) -> np.ndarray:
    imgs = np.ascontiguousarray(imgs)
    if imgs.ndim != 4 or imgs.shape[-1] != 3 or imgs.dtype != np.uint8:
        raise ValueError(f"{name} takes (N, H, W, 3) uint8, got {imgs.dtype} {imgs.shape}")
    return imgs


def pil_resize_uint8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bit-exact PIL bilinear resize of one uint8 image."""
    img = np.ascontiguousarray(img)
    lib = _load()
    if lib is None or img.ndim != 3:
        return _np_resize(img, out_h, out_w)
    out = np.empty((out_h, out_w, img.shape[2]), np.uint8)
    lib.pf_pil_resize_u8(
        img.ctypes.data, img.shape[0], img.shape[1], img.shape[2],
        out.ctypes.data, out_h, out_w,
    )
    return out


def _numpy_rows(frames, out: np.ndarray, bgr_flip: bool, mean=None, std=None) -> None:
    """The numpy path of the batch functions: each frame resized (and
    normalized when ``mean`` is given) into its row of ``out``; rows past the
    frames repeat the last frame's result."""
    out_h, out_w = out.shape[1:3]
    for i, im in enumerate(frames):
        r = _np_resize(im, out_h, out_w)
        if bgr_flip:
            r = r[..., ::-1]
        out[i] = r if mean is None else (r.astype(np.float32) - mean) / std
    if len(frames) < len(out):
        out[len(frames):] = out[len(frames) - 1]


def preprocess_batch(
    imgs: np.ndarray, out_h: int, out_w: int, mean, std, bgr_flip: bool = False, out=None
) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, out_h, out_w, 3) float32, PIL-exact resize
    then (x - mean) / std."""
    imgs = _check_batch(imgs, "preprocess_batch")
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = _out(out, (imgs.shape[0], out_h, out_w, 3), np.float32)
    lib = _load()
    if lib is None:
        _numpy_rows(imgs, out, bgr_flip, mean, std)
        return out
    lib.pf_preprocess_batch(
        imgs.ctypes.data, imgs.shape[0], imgs.shape[1], imgs.shape[2],
        out.ctypes.data, out_h, out_w,
        mean.ctypes.data, std.ctypes.data, int(bgr_flip),
    )
    return out


def resize_batch_u8(
    imgs: np.ndarray, out_h: int, out_w: int, bgr_flip: bool = False, out=None
) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, out_h, out_w, 3) uint8, bit-exact PIL
    bilinear: the uint8 wire, normalized on the device."""
    imgs = _check_batch(imgs, "resize_batch_u8")
    out = _out(out, (imgs.shape[0], out_h, out_w, 3), np.uint8)
    lib = _load()
    if lib is None:
        _numpy_rows(imgs, out, bgr_flip)
        return out
    lib.pf_resize_batch_u8(
        imgs.ctypes.data, imgs.shape[0], imgs.shape[1], imgs.shape[2],
        out.ctypes.data, out_h, out_w, int(bgr_flip),
    )
    return out


def _ptr_array(imgs, in_hw, pad_to: int = 0):
    """The frames' data pointers as a ctypes array, padded to ``pad_to``
    entries by repeating the last frame's pointer (no copy), and the
    contiguous frames themselves, which the caller holds until the native
    call returns. Every frame must have the first frame's shape and be
    uint8: the native gather reads ``in_hw`` rows from each pointer."""
    held = [np.ascontiguousarray(im) for im in imgs]
    for i, im in enumerate(held):
        if im.shape != (*in_hw, 3) or im.dtype != np.uint8:
            raise ValueError(
                f"frame {i}: expected uint8 {(*in_hw, 3)} (the batch's first frame "
                f"shape), got {im.dtype} {im.shape}"
            )
    n = max(len(held), pad_to)
    ptrs = [im.ctypes.data for im in held]
    ptrs += [ptrs[-1]] * (n - len(held))
    return (ctypes.c_void_p * n)(*ptrs), held


def _in_hw(imgs):
    if not len(imgs):
        raise ValueError("empty frame list")
    return imgs[0].shape[:2]


def resize_list_u8(
    imgs, out_h: int, out_w: int, bgr_flip: bool = False, pad_to: int = 0, out=None
) -> np.ndarray:
    """List of (H, W, 3) uint8 frames -> (max(N, pad_to), out_h, out_w, 3)
    uint8, bit-exact PIL bilinear, gathered from the frames' own buffers (no
    stacking copy). Rows past the frames repeat the last one (by pointer on
    the native path)."""
    in_hw = _in_hw(imgs)
    ptrs, held = _ptr_array(imgs, in_hw, pad_to)
    out = _out(out, (len(ptrs), out_h, out_w, 3), np.uint8)
    lib = _load()
    if lib is None:
        _numpy_rows(held, out, bgr_flip)
        return out
    lib.pf_resize_batch_u8_ptrs(
        ptrs, len(ptrs), in_hw[0], in_hw[1], out.ctypes.data, out_h, out_w, int(bgr_flip),
    )
    return out


def preprocess_list(
    imgs, out_h: int, out_w: int, mean, std, bgr_flip: bool = False, pad_to: int = 0,
    out=None,
) -> np.ndarray:
    """List of (H, W, 3) uint8 frames -> (max(N, pad_to), out_h, out_w, 3)
    float32, PIL-exact resize then (x - mean) / std, gathered from the
    frames' own buffers; rows past the frames repeat the last one."""
    in_hw = _in_hw(imgs)
    ptrs, held = _ptr_array(imgs, in_hw, pad_to)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = _out(out, (len(ptrs), out_h, out_w, 3), np.float32)
    lib = _load()
    if lib is None:
        _numpy_rows(held, out, bgr_flip, mean, std)
        return out
    lib.pf_preprocess_batch_ptrs(
        ptrs, len(ptrs), in_hw[0], in_hw[1], out.ctypes.data, out_h, out_w,
        mean.ctypes.data, std.ctypes.data, int(bgr_flip),
    )
    return out
