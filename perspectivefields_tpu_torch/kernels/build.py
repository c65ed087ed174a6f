"""Build the package's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (``library``). The output goes to
``perspectivefields_tpu_torch/_build/`` under a name keyed by a hash of the
sources and the flags, so an edit rebuilds and an unchanged tree reuses the
library. A failed build raises with nvcc's stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str | None:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def _digest(src: Path, flags: tuple) -> str:
    h = hashlib.sha256()
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the
    library's path. ptxas's register/shared-memory report is kept beside it
    as ``<lib>.log``. ``defines``: macros set for this build (``PF_PHASES``
    turns on csrc/hopper_gemm.cuh's phase stamps), kept apart from the
    plain build."""
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    lib = BUILD_DIR / f"lib{name}{''.join('-' + d for d in defines)}-{_digest(src, flags)}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {src.name}: nvcc not found (PATH, CUDA_HOME). The "
            "CUDA kernels build only where the CUDA toolkit is installed."
        )
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


_libs: dict[tuple, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def library(name: str, signatures: dict[str, list], defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` with ``defines`` once
    per process. ``signatures`` maps each C function to its ctypes
    argtypes; every one returns an int (a cudaError_t, or a count).
    ``pf_cuda_error_string``, which every source exports, is bound too."""
    with _libs_lock:
        lib = _libs.get((name, defines))
        if lib is None:
            lib = ctypes.CDLL(str(build(name, defines)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.pf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pf_cuda_error_string.restype = ctypes.c_char_p
            _libs[name, defines] = lib
        return lib


def raise_on_error(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error (its
    cudaGetLastError() right after the launches)."""
    if err != 0:
        msg = lib.pf_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")
