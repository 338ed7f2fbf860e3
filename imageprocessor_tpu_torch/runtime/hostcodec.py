"""The port's host JPEG entropy scan, without libjpeg.

The reference's host half links libjpeg (runtime/nativecodec.py builds
native/ipcodec.cpp with ``-ljpeg``); on a host without libjpeg's headers
that library does not build. The streaming entropy scanner
(native/jpeg_scan.cpp) needs no libjpeg: it is built here into the
port's own library with g++, at first use, and bound with ctypes. It
fills the int16 coefficient canvases that kernel B1 decodes. Pixel
decode and every encode go to runtime/codecs.py (OpenCV, then PIL).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[2]
SOURCES = (_REPO / "native" / "jpeg_scan.cpp",)
BUILD_DIR = _REPO / "build" / "hostcodec"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# Scanner refuses larger frames (same cap as nativecodec's coefficient API).
_MAX_COEF_PIXELS = 100_000_000


class HostCodecError(RuntimeError):
    """The stream cannot be scanned, or the library failed to build."""


def _lib_path() -> pathlib.Path:
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libipjpeg-{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The scan library, built with g++ on first use (raises
    HostCodecError when it cannot be built or loaded)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    ["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                    capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise HostCodecError(f"g++ failed: {proc.stderr[-2000:]}")
                os.replace(tmp, path)
            except (OSError, subprocess.SubprocessError) as exc:
                raise HostCodecError(f"cannot build {path.name}: {exc}") from exc
            finally:
                tmp.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(path))
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ip_jpeg_scan_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                          ip, ip, ip, ip, ip, ip, ip]
        lib.ip_jpeg_scan_dims.restype = ctypes.c_int
        lib.ip_jpeg_scan_coefs.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p]
        lib.ip_jpeg_scan_coefs.restype = ctypes.c_int
        lib.ip_jpeg_scan_qtabs.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                           ctypes.c_void_p]
        lib.ip_jpeg_scan_qtabs.restype = ctypes.c_int
        _lib = lib
    return _lib


def scan_jpeg_coefficients(data: bytes):
    """One-pass entropy decode: (planes, qtabs, (img_w, img_h), sampling).

    planes: per component an int16 (rows, cols) canvas of quantized
    coefficients in the spatial block layout (coefficient (u, v) of
    block (by, bx) at [by*8+u, bx*8+v]), MCU-aligned; qtabs: (n, 8, 8)
    float32; sampling: per component (h, v) factors. Raises
    HostCodecError for streams the scanner refuses."""
    lib = library()
    ncomp, iw, ih = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    cbw, cbh, hs, vs = ((ctypes.c_int * 4)() for _ in range(4))
    rc = lib.ip_jpeg_scan_dims(data, len(data), ctypes.byref(ncomp),
                               ctypes.byref(iw), ctypes.byref(ih),
                               cbw, cbh, hs, vs)
    if rc != 0:
        raise HostCodecError(f"scan dims failed (rc={rc})")
    if iw.value <= 0 or ih.value <= 0 or iw.value * ih.value > _MAX_COEF_PIXELS:
        raise HostCodecError(f"frame {iw.value}x{ih.value} out of range")
    n = ncomp.value
    planes = [np.zeros((cbh[c] * 8, cbw[c] * 8), dtype=np.int16)
              for c in range(n)]
    while len(planes) < 3:
        planes.append(np.zeros((8, 8), dtype=np.int16))
    rc = lib.ip_jpeg_scan_coefs(data, len(data),
                                *(p.ctypes.data_as(ctypes.c_void_p)
                                  for p in planes[:3]))
    if rc != 0:
        raise HostCodecError(f"scan coefs failed (rc={rc})")
    qt = np.zeros((3, 64), dtype=np.uint16)
    rc = lib.ip_jpeg_scan_qtabs(data, len(data),
                                qt.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise HostCodecError(f"scan qtabs failed (rc={rc})")
    sampling = [(hs[c], vs[c]) for c in range(n)]
    return (planes[:n], qt[:n].reshape(n, 8, 8).astype(np.float32),
            (iw.value, ih.value), sampling)
