"""Build and load the port's CUDA kernels (csrc/*.cu).

The pattern of runtime/nativecodec.py's build, without its fallback: at
the first CUDA use, one ``nvcc`` per ``csrc/*.cu`` source, all started
together, compiles each for sm_90a into a shared library with a plain C
interface, which is loaded with ctypes. A library's file name carries a
hash of its source, the shared headers (``csrc/*.cuh``) and the flags, so
a changed source always rebuilds and a stale binary is never loaded.
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
import types

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: types.SimpleNamespace | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry point (all return int cudaError_t)
_SIGNATURES = {
    # yc, cbc, crc, qt, cv, out, batch, ch, cw, fh, fw, out_h, out_w, stream
    "ip_decode_coefs": [_P] * 6 + [_I] * 7 + [_P],
    # src, batch, src_h, src_w,
    # then for outputs a and b: r0, r1, fy, c0, c1, fx, dst, h, w; stream
    "ip_fused_resample": [_P, _I, _I, _I] + ([_P] * 7 + [_I, _I]) * 2 + [_P],
    # src, batch, src_h, src_w, r0, r1, fy, c0, c1, fx, dst, h, w, stream
    "ip_planar_resample": [_P, _I, _I, _I] + [_P] * 7 + [_I, _I, _P],
    # rgb, image/channel/row strides, valid, qt, yc, cbc, crc, batch, h, w,
    # stream
    "ip_encode_420": [_P] + [ctypes.c_longlong] * 3 + [_P] * 5 + [_I] * 3 + [_P],
}


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha1()
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _build(paths: dict[pathlib.Path, pathlib.Path]) -> None:
    """Compile each source into its library, all nvcc processes at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile to a per-process name, then rename into place: processes
    # building at once never load a half-written library
    jobs = []
    for src, path in paths.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((src, path, tmp, proc))
    errors = []
    try:
        for src, path, tmp, proc in jobs:
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                errors.append(f"{src.name}: nvcc failed ({proc.returncode}):\n"
                              f"{err[-4000:]}")
            else:
                os.replace(tmp, path)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if errors:
        raise KernelError("\n".join(errors))


def library() -> types.SimpleNamespace:
    """Every kernel entry point, each source built first if needed (raises
    on any failure — there is no fallback)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            paths = {src: _lib_path(src) for src in _sources()}
            missing = {s: p for s, p in paths.items() if not p.exists()}
            if missing:
                _build(missing)
            libs = [ctypes.CDLL(str(p)) for p in paths.values()]
            fns = {}
            for name, argtypes in _SIGNATURES.items():
                found = [lib for lib in libs if hasattr(lib, name)]
                if len(found) != 1:
                    raise KernelError(f"{name} is in {len(found)} kernel libraries")
                fn = getattr(found[0], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            _lib = types.SimpleNamespace(libraries=libs, **fns)
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name} launch failed: cudaError {rc}")


def stream_ptr(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
