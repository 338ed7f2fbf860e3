"""Build and load the port's CUDA kernels (csrc/*.cu).

The pattern of runtime/nativecodec.py's build, without its fallback: at
the first CUDA use, ``nvcc`` compiles every ``csrc/*.cu`` for sm_90a
into one shared library with a plain C interface, which is loaded with
ctypes. The library's file name carries a hash of the sources, so a
changed source always rebuilds and a stale binary is never loaded.
Nothing here runs at import time: CPU-only hosts never call nvcc.

Every C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``;
:func:`check` raises :class:`KernelError` when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry point (all return int cudaError_t)
_SIGNATURES = {
    # yc, cbc, crc, qt, cv, out, batch, ch, cw, fh, fw, out_h, out_w, stream
    "ip_decode_coefs": [_P] * 6 + [_I] * 7 + [_P],
    # src, batch, src_h, src_w,
    # then for outputs a and b: r0, r1, fy, c0, c1, fx, dst, h, w; stream
    "ip_fused_resample": [_P, _I, _I, _I] + ([_P] * 7 + [_I, _I]) * 2 + [_P],
}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path() -> pathlib.Path:
    h = hashlib.sha1()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libipkernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _build(path: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a per-process name, then rename into place: processes
    # building at once never load a half-written library
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed ({proc.returncode}):\n"
                              f"{proc.stderr[-4000:]}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (raises on any
    failure — there is no fallback)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name} launch failed: cudaError {rc}")


def stream_ptr(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
