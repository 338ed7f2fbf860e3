"""The port's host JPEG entropy code and GIF quantizer, without libjpeg.

The reference's host half links libjpeg (runtime/nativecodec.py builds
native/ipcodec.cpp with ``-ljpeg``); on a host without libjpeg's headers
that library does not build. The streaming entropy scanner
(native/jpeg_scan.cpp), the entropy emitters (native/jpeg_emit.cpp) and
Go's Plan9 GIF quantizer (native/gifquant.cpp) need no libjpeg: they are
built here into the port's own library with g++, at first use, and bound
with ctypes. The functions below are nativecodec's bindings of the same
entry points, raising :class:`HostCodecError` where nativecodec raises
NativeCodecError:

* ``scan_jpeg_coefficients`` fills the int16 canvases kernel B1 decodes
  (``scan_jpeg_layout`` and ``scan_jpeg_coefficients_into``: the same
  scan into planes the caller holds, the engine's reused staging slabs);
* ``emit_jpeg_from_coefficients`` entropy-codes the canvases kernel B3
  writes;
* ``scan_jpeg_for_transcode``/``emit_jpeg_transcode`` are the watermark
  splice's scan and emit (runtime/splice.py), ``is_progressive`` its
  header probe;
* ``gif_quantize_plan9`` serves runtime/codecs.py's GIF outputs;
* ``crc32c`` checks every Kafka record batch (broker/kafkawire.py); its
  source is the port's own csrc/crc32c.cpp, a copy of native/ipcodec.cpp's
  ``ip_crc32c`` (ipcodec.cpp itself needs libjpeg);
* ``entropy_tables`` and ``copy_entropy`` stage a baseline stream for
  kernel B0 (ops/jpeg_entropy.py): the headers' Huffman tables and
  restart interval, and the scan's bytes destuffed (csrc/entropy_copy.cpp,
  the port's own);
* ``coef_rot_i16`` is the blocked rotation runtime/coeftx.py fuses a
  mirror + transpose pair onto; its source is csrc/coefrot.cpp, a copy of
  ipcodec.cpp's ``ip_coef_rot_i16``.

Pixel decode and every other encode go to runtime/codecs.py (OpenCV,
then PIL).
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
SOURCES = (*(_REPO / "native" / name
              for name in ("jpeg_scan.cpp", "jpeg_emit.cpp", "gifquant.cpp")),
           *(_REPO / "imageprocessor_tpu_torch" / "csrc" / name
             for name in ("crc32c.cpp", "coefrot.cpp", "entropy_copy.cpp")))
BUILD_DIR = _REPO / "build" / "hostcodec"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# Scanner refuses larger frames (same cap as nativecodec's coefficient API).
_MAX_COEF_PIXELS = 100_000_000

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_IP = ctypes.POINTER(ctypes.c_int)
# name -> (argtypes, restype) of every entry point bound here
_SIGNATURES = {
    "ip_jpeg_scan_dims": ([ctypes.c_char_p, ctypes.c_size_t] + [_IP] * 7, _I),
    "ip_jpeg_scan_coefs": ([ctypes.c_char_p, ctypes.c_size_t] + [_P] * 3, _I),
    "ip_jpeg_scan_qtabs": ([ctypes.c_char_p, ctypes.c_size_t, _P], _I),
    "ip_jpeg_scan_tables": ([ctypes.c_char_p, ctypes.c_size_t, _IP]
                            + [_P] * 8 + [_IP, _IP], _I),
    "ip_jpeg_scan_coefs_offsets_rst": (
        [ctypes.c_char_p, ctypes.c_size_t] + [_P] * 4 + [ctypes.c_size_t, _P,
                                                        ctypes.POINTER(ctypes.c_int64),
                                                        _P], _I),
    "ip_jpeg_emit_strided": ([_P] * 4 + [_I] * 6 + [_L] * 3
                             + [_P, ctypes.c_size_t], _L),
    "ip_jpeg_emit_transcode_rst": (
        [_P] * 3 + [_L] * 3 + [_P] * 8 + [_I] * 3 + [_P] * 3
        + [ctypes.c_int64] + [_P] * 3 + [ctypes.c_size_t, _I, _P], _L),
    "ip_gif_quantize_plan9": ([_P, _I, _I, _L, _I, _P, _P], _I),
    "ip_crc32c": ([ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32],
                  ctypes.c_uint32),
    "ip_coef_rot_i16": ([_P, ctypes.c_int64, ctypes.c_int64, _P, _I], _I),
    "ip_jpeg_entropy_copy": ([ctypes.c_char_p, ctypes.c_int64, _I, _P,
                              ctypes.c_int64, _P, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64), _IP], _I),
}


class HostCodecError(RuntimeError):
    """The stream cannot be scanned or emitted, or the library failed to
    build."""


# the name the reference's shared code catches (runtime/coeftx.py's
# ``_rot_native`` binds this module as ``nativecodec``)
NativeCodecError = HostCodecError


def _lib_path() -> pathlib.Path:
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libipjpeg-{h.hexdigest()[:16]}.so"


def library() -> ctypes.CDLL:
    """The host library, built with g++ on first use (raises
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
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def _ptr(a: np.ndarray | None):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _scan_dims(lib, data: bytes):
    """(plane shapes, (img_w, img_h), sampling) from the headers alone."""
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
    shapes = [(cbh[c] * 8, cbw[c] * 8) for c in range(n)]
    sampling = [(hs[c], vs[c]) for c in range(n)]
    return shapes, (iw.value, ih.value), sampling


def _zeros(shapes) -> list[np.ndarray]:
    return [np.zeros(s, dtype=np.int16) for s in shapes]


def scan_jpeg_layout(data: bytes):
    """(plane shapes, (img_w, img_h), sampling) of the planes
    ``scan_jpeg_coefficients`` would return, from the headers alone.
    Raises HostCodecError for streams the scanner refuses."""
    return _scan_dims(library(), data)


def scan_jpeg_coefficients(data: bytes):
    """One-pass entropy decode: (planes, qtabs, (img_w, img_h), sampling).

    planes: per component an int16 (rows, cols) canvas of quantized
    coefficients in the spatial block layout (coefficient (u, v) of
    block (by, bx) at [by*8+u, bx*8+v]), MCU-aligned; qtabs: (n, 8, 8)
    float32; sampling: per component (h, v) factors. Raises
    HostCodecError for streams the scanner refuses."""
    shapes, size, sampling = scan_jpeg_layout(data)
    planes = _zeros(shapes)
    return planes, scan_jpeg_coefficients_into(data, planes), size, sampling


def scan_jpeg_coefficients_into(data: bytes, planes) -> np.ndarray:
    """``scan_jpeg_coefficients`` into the caller's planes: one C-contiguous
    int16 array per component, of the shapes ``scan_jpeg_layout`` gives
    and all zero (the scanner writes only the non-zero coefficients).
    Returns qtabs, (n, 8, 8) float32. Raises HostCodecError for streams
    the scanner refuses, ValueError for planes that do not fit."""
    lib = library()
    shapes, _size, _sampling = _scan_dims(lib, data)
    if [tuple(p.shape) for p in planes] != shapes or not all(
            p.dtype == np.int16 and p.flags.c_contiguous for p in planes):
        raise ValueError(f"planes must be C-contiguous int16 of shapes {shapes}")
    n = len(planes)
    pv = list(planes) + _zeros([(8, 8)] * (3 - n))
    rc = lib.ip_jpeg_scan_coefs(data, len(data), *map(_ptr, pv[:3]))
    if rc != 0:
        raise HostCodecError(f"scan coefs failed (rc={rc})")
    qt = np.zeros((3, 64), dtype=np.uint16)
    rc = lib.ip_jpeg_scan_qtabs(data, len(data), _ptr(qt))
    if rc != 0:
        raise HostCodecError(f"scan qtabs failed (rc={rc})")
    return qt[:n].reshape(n, 8, 8).astype(np.float32)


def emit_jpeg_from_coefficients(planes, qtabs, img_w: int, img_h: int,
                                sampling=(2, 2),
                                restart_interval: int = 0) -> bytes:
    """Entropy-encode quantized coefficient planes into a baseline JFIF
    stream (Annex K Huffman tables).

    planes: 1 or 3 int16 arrays in the spatial block layout, MCU-aligned
    (luma (ceil(h/8v0)*8v0, ceil(w/8h0)*8h0), chroma divided by the
    sampling factors); row-strided views (a slice of a batch canvas) are
    read in place, with no copy. qtabs: (ncomp, 8, 8) or (ncomp, 64) in
    natural order, chroma sharing qtabs[1]. sampling: luma (h0, v0);
    chroma is always 1x1. restart_interval > 0 emits DRI + RSTn every
    that many MCUs."""
    lib = library()
    ncomp = len(planes)
    if ncomp not in (1, 3):
        raise HostCodecError(f"ncomp must be 1 or 3, got {ncomp}")
    arrs = []
    for p in planes:
        a = np.asarray(p)
        if (a.dtype != np.int16 or a.ndim != 2
                or a.strides[1] != a.itemsize):
            a = np.ascontiguousarray(a, dtype=np.int16)
        arrs.append(a)
    while len(arrs) < 3:
        arrs.append(np.zeros((8, 8), dtype=np.int16))
    qt = np.ascontiguousarray(np.asarray(qtabs), dtype=np.uint16)
    qt = qt.reshape(qt.shape[0], 64)
    qt2 = np.zeros((2, 64), dtype=np.uint16)
    qt2[0] = qt[0]
    qt2[1] = qt[1] if qt.shape[0] > 1 else qt[0]
    # the emitter writes 8-bit (pq=0) DQT segments
    if qt2.max() > 255 or qt2.min() < 1:
        raise HostCodecError(
            "quant table values must be in 1..255 (8-bit DQT); got "
            f"range {int(qt2.min())}..{int(qt2.max())}")
    h0, v0 = (int(sampling[0]), int(sampling[1])) if ncomp == 3 else (1, 1)
    mcus_x = -(-int(img_w) // (h0 * 8))
    mcus_y = -(-int(img_h) // (v0 * 8))
    for c in range(ncomp):
        need = ((mcus_y * (v0 if c == 0 else 1)) * 8,
                (mcus_x * (h0 if c == 0 else 1)) * 8)
        # the width must match exactly (the emitter derives each row's
        # length from the MCU grid); extra rows past the grid are ignored
        if arrs[c].shape[0] < need[0] or arrs[c].shape[1] != need[1]:
            raise HostCodecError(
                f"component {c} plane {arrs[c].shape} does not match the "
                f"MCU-aligned grid {need} for {img_w}x{img_h}")
    # worst case ~2 bytes/coefficient + headers
    cap = sum(a.size for a in arrs[:ncomp]) * 2 + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    strides = [a.strides[0] // a.itemsize for a in arrs]
    n = lib.ip_jpeg_emit_strided(
        *map(_ptr, arrs), _ptr(qt2), img_w, img_h, ncomp, h0, v0,
        int(restart_interval), *strides, _ptr(out), cap)
    if n < 0:
        raise HostCodecError(f"jpeg emit failed (rc={n})")
    return out[:n].tobytes()


class JpegSpliceContext:
    """Everything the splice emitter needs to splice-edit one JPEG:
    coefficient planes, the destuffed entropy stream with per-MCU bit
    offsets, and the input's own table assignments. Produced by
    scan_jpeg_for_transcode; consumed by emit_jpeg_transcode after the
    caller edits `planes` in place and flags the touched MCUs."""

    __slots__ = ("planes", "qt_slots", "qtabs", "size", "sampling",
                 "destuff", "mcu_bits", "destuff_bits", "comp_id",
                 "comp_tq", "comp_dc", "comp_ac", "dht_bits", "dht_vals",
                 "dht_present", "mcus_x", "mcus_y", "edited",
                 "restart_interval", "seg_bits", "undo")

    @property
    def nmcus(self) -> int:
        return self.mcus_x * self.mcus_y


def _scan_tables(lib, data: bytes):
    t = {"comp_id": np.zeros(3, np.uint8), "comp_tq": np.zeros(3, np.uint8),
         "comp_dc": np.zeros(3, np.uint8), "comp_ac": np.zeros(3, np.uint8),
         "dht_bits": np.zeros((8, 17), np.uint8),
         "dht_vals": np.zeros((8, 256), np.uint8),
         "dht_present": np.zeros(8, np.uint8),
         "qt_slots": np.zeros((4, 64), np.uint16)}
    nc2, dri, prog = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.ip_jpeg_scan_tables(data, len(data), ctypes.byref(nc2),
                                 *map(_ptr, t.values()),
                                 ctypes.byref(dri), ctypes.byref(prog))
    if rc != 0:
        raise HostCodecError(f"scan tables failed (rc={rc})")
    return t, int(dri.value), bool(prog.value)


def scan_jpeg_for_transcode(data: bytes) -> JpegSpliceContext:
    """Streaming entropy decode PLUS splice support: per-MCU bit offsets
    into a destuffed copy of the entropy stream, and the input's own
    Huffman/quant table specs. Restart-marker streams are supported.
    Raises HostCodecError for anything the splice emitter cannot
    reproduce (progressive, truncated streams)."""
    lib = library()
    shapes, (iw, ih), sampling = _scan_dims(lib, data)
    planes = _zeros(shapes)
    n = len(planes)
    if n not in (1, 3):
        raise HostCodecError(f"unsupported component count {n}")
    pv = planes + [np.zeros((8, 8), dtype=np.int16)] * (3 - n)
    hmax = max(s[0] for s in sampling) if n == 3 else 1
    vmax = max(s[1] for s in sampling) if n == 3 else 1
    mcus_x = -(-iw // (hmax * 8))
    mcus_y = -(-ih // (vmax * 8))
    nmcus = mcus_x * mcus_y
    # tables first (cheap header parse): the restart interval sizes the
    # destuff buffer and the per-segment end array
    tables, ri, _prog = _scan_tables(lib, data)
    nseg = -(-nmcus // ri) if ri > 0 else 1
    # +64: the scanner may append a few zero-fill bytes at the stream
    # tail and the splice emitter bulk-reads 8-byte windows; each restart
    # boundary can append up to 8 more
    destuff = np.zeros(len(data) + 64 + 8 * (nseg - 1), dtype=np.uint8)
    mcu_bits = np.zeros(nmcus + 1, dtype=np.int64)
    seg_bits = np.zeros(max(nseg - 1, 1), dtype=np.int64) if ri > 0 else None
    dbits = ctypes.c_int64()
    rc = lib.ip_jpeg_scan_coefs_offsets_rst(
        data, len(data), *map(_ptr, pv), _ptr(destuff), destuff.size,
        _ptr(mcu_bits), ctypes.byref(dbits), _ptr(seg_bits))
    if rc != 0:
        raise HostCodecError(f"splice scan failed (rc={rc})")
    if mcu_bits[nmcus] > dbits.value:
        raise HostCodecError("truncated entropy stream")
    ctx = JpegSpliceContext()
    ctx.planes = planes
    for name, value in tables.items():
        setattr(ctx, name, value)
    ctx.qtabs = np.stack([ctx.qt_slots[ctx.comp_tq[c]] for c in range(n)]
                         ).reshape(n, 8, 8).astype(np.float32)
    ctx.size = (iw, ih)
    ctx.sampling = sampling
    ctx.destuff = destuff
    ctx.mcu_bits = mcu_bits
    ctx.destuff_bits = int(dbits.value)
    ctx.mcus_x = mcus_x
    ctx.mcus_y = mcus_y
    ctx.restart_interval = ri
    ctx.seg_bits = seg_bits
    ctx.edited = False  # set by splice.watermark_band after a write-back
    ctx.undo = None     # band-edit snapshot (splice.watermark_band)
    return ctx


def emit_jpeg_transcode(ctx: JpegSpliceContext, reenc: np.ndarray) -> bytes:
    """Splice-emit a baseline JFIF stream from ctx after the caller
    edited ctx.planes in place: MCUs flagged in `reenc` (uint8,
    (mcus_y, mcus_x) or flat) are re-symbolized with the input's own
    Huffman tables; every other MCU's bits are copied from the original
    entropy stream. Raises HostCodecError when the input's tables cannot
    express an edited block."""
    lib = library()
    n = len(ctx.planes)
    flags = np.ascontiguousarray(reenc, dtype=np.uint8).reshape(-1)
    if flags.size != ctx.nmcus:
        raise HostCodecError(
            f"reenc has {flags.size} flags, stream has {ctx.nmcus} MCUs")
    pv = list(ctx.planes) + [np.zeros((8, 8), dtype=np.int16)] * (3 - n)
    samp_h = np.array([s[0] for s in ctx.sampling] + [1] * (3 - n), np.uint8)
    samp_v = np.array([s[1] for s in ctx.sampling] + [1] * (3 - n), np.uint8)
    w, hgt = ctx.size
    # worst case: every MCU re-symbolized (~2 bytes/coefficient) plus the
    # copied stream itself plus headers
    cap = (sum(int(p.size) for p in ctx.planes) * 2
           + ctx.destuff.size + (1 << 16))
    out = np.empty(cap, dtype=np.uint8)
    rc = lib.ip_jpeg_emit_transcode_rst(
        *map(_ptr, pv), *(p.strides[0] // 2 for p in pv),
        *map(_ptr, (ctx.qt_slots, ctx.comp_tq, ctx.comp_id, ctx.comp_dc,
                    ctx.comp_ac, ctx.dht_bits, ctx.dht_vals,
                    ctx.dht_present)),
        w, hgt, n, _ptr(samp_h), _ptr(samp_v), _ptr(ctx.destuff),
        ctypes.c_int64(ctx.destuff_bits), _ptr(ctx.mcu_bits), _ptr(flags),
        _ptr(out), cap, int(ctx.restart_interval or 0), _ptr(ctx.seg_bits))
    if rc < 0:
        raise HostCodecError(f"splice emit failed (rc={rc})")
    return out[:rc].tobytes()


def entropy_tables(data: bytes):
    """(tables, restart interval, progressive) from the headers alone:
    per component its id, quantization slot and DC / AC table ids, the
    eight DHT specs (``dht_bits`` (8, 17), ``dht_vals`` (8, 256),
    ``dht_present``; DC tables 0-3, then AC) and the quantization tables
    per slot (``qt_slots`` (4, 64), natural order). Raises HostCodecError
    on headers the scanner refuses."""
    return _scan_tables(library(), data)


def copy_entropy(data: bytes, restart_interval: int, max_segs: int,
                 out: np.ndarray) -> tuple[int, np.ndarray, bool]:
    """The scan's entropy-coded bytes copied into ``out`` (uint8, at least
    ``len(data) + 32`` long) with FF 00 destuffed, up to the first marker
    that is not a restart marker the interval expects, then zeros to a
    16-byte multiple at least 16 bytes on. -> (the destuffed bytes, each
    restart segment's first byte as int64, at most ``max_segs``
    segments; whether an EOI follows the scan's header, as
    codecs.jpeg_stream_complete finds it). Raises HostCodecError when
    the headers hold no scan."""
    if out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous uint8")
    segs = np.zeros(max(int(max_segs), 1), dtype=np.int64)
    nbytes, nsegs = ctypes.c_int64(), ctypes.c_int64()
    complete = ctypes.c_int()
    rc = library().ip_jpeg_entropy_copy(
        data, len(data), int(restart_interval), _ptr(out), out.size,
        _ptr(segs), segs.size, ctypes.byref(nbytes), ctypes.byref(nsegs),
        ctypes.byref(complete))
    if rc != 0:
        raise HostCodecError(f"entropy copy failed (rc={rc})")
    return int(nbytes.value), segs[:nsegs.value], bool(complete.value)


def is_progressive(data: bytes) -> bool:
    """Header-only probe: True for SOF2 (progressive) streams. Raises
    HostCodecError on unparseable headers."""
    return _scan_tables(library(), data)[2]


def gif_quantize_plan9(rgb: np.ndarray, dither: bool = True
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Quantize (H, W, 3) uint8 RGB to Go's gif.Encode semantics: the
    fixed Plan9 palette with Floyd-Steinberg dithering. Returns (indices
    (H, W) uint8, palette (256, 3) uint8)."""
    lib = library()
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] < 3:
        raise HostCodecError(
            f"gif_quantize needs an (H, W, >=3) array, got {rgb.shape}")
    rgb = np.ascontiguousarray(rgb[:, :, :3], dtype=np.uint8)
    h, w = rgb.shape[:2]
    idx = np.empty((h, w), dtype=np.uint8)
    pal = np.empty((256, 3), dtype=np.uint8)
    rc = lib.ip_gif_quantize_plan9(_ptr(rgb), w, h, rgb.strides[0],
                                   1 if dither else 0, _ptr(idx), _ptr(pal))
    if rc != 0:
        raise HostCodecError(f"gif quantize failed (rc={rc})")
    return idx, pal


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``: the
    checksum of a Kafka RecordBatch v2 (nativecodec.crc32c's binding).
    Raises HostCodecError when the library cannot be built."""
    return int(library().ip_crc32c(bytes(data), len(data), crc & 0xFFFFFFFF))


_ROT_MODES = {"transpose": 0, "rot90": 1, "rot270": 2}


def coef_rot_i16(plane: np.ndarray, mode: str) -> np.ndarray:
    """Blocked coefficient-plane rotation (csrc/coefrot.cpp,
    nativecodec.coef_rot_i16's binding): transpose the 8x8-block grid AND
    each block, with the frequency sign flips the rot90/rot270
    decompositions inherit from their mirror half. ``mode`` is
    "transpose", "rot90" or "rot270". Raises HostCodecError when a dim
    is not block-aligned or the C entry refuses."""
    lib = library()
    p = np.ascontiguousarray(plane, dtype=np.int16)
    hp, wp = p.shape
    if hp % 8 or wp % 8:
        raise HostCodecError("plane dims must be block-aligned")
    out = np.empty((wp, hp), dtype=np.int16)
    rc = lib.ip_coef_rot_i16(_ptr(p), hp // 8, wp // 8, _ptr(out),
                             _ROT_MODES[mode])
    if rc != 0:
        raise HostCodecError(f"coef rot failed (rc={rc})")
    return out
