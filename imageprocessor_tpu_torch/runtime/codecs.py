# Copy of imageprocessor_tpu/runtime/codecs.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
# Unlike the original it has no libjpeg shim (runtime/nativecodec.py): a
# host without libjpeg's headers cannot build it, so JPEG, PNG and the
# rest decode and encode through OpenCV, then PIL. GIF outputs go through
# the same Plan9 quantizer as the original's (native/gifquant.cpp, built
# without libjpeg by runtime/hostcodec.py).
"""Host image codecs and format negotiation.

Decode/encode never run on the TPU — entropy coding is branchy scalar work.
They run on host threads via OpenCV (libjpeg-turbo with SIMD, releases the
GIL) with PIL as the fallback for GIF and exotic formats.

Format rules replicate the reference exactly:
* resize/thumbnail encode switch: jpg/jpeg->jpeg(q85), png->png, gif->gif,
  anything else -> jpeg (operations/resize.go:78-91, thumbnail.go:66-85);
* watermark re-encodes GIF input as JPEG (operations/watermark.go:73-74);
* decode supports at least gif/jpeg/png like the reference's registered
  decoders (image_processor.go:8-10) — plus webp/bmp/tiff, which the
  reference's HTTP layer accepts but its worker then fails on.
"""

from __future__ import annotations

import io
import os

import numpy as np

from imageprocessor_tpu_torch.errors import DecodeError


def _png_compression() -> int:
    """PNG zlib compression level (IMAGEPROCESSOR_PNG_COMPRESSION,
    0-9). Default 6 = zlib's default = what Go's png.Encode emits
    (reference: operations/resize.go:83-85), so processed PNG sizes
    match the reference's. Measured tradeoff at 12 MP (PERF.md "PNG
    level tradeoff"): level 1 encodes ~1.25x faster but emits 3.2x
    LARGER files on graphics-like content (level 6: 58 KB vs 186 KB)
    and ~3% larger on photographic content — set 1 only when the host
    codec pool, not storage, is the bottleneck. Invalid values fall
    back to 6 (the size-parity default)."""
    raw = os.environ.get("IMAGEPROCESSOR_PNG_COMPRESSION", "6").strip()
    try:
        lvl = int(raw)
    except ValueError:
        lvl = -1
    if not 0 <= lvl <= 9:
        import warnings

        warnings.warn(
            f"IMAGEPROCESSOR_PNG_COMPRESSION={raw!r} is not 0-9; "
            "using 6 (Go png.Encode parity)", stacklevel=2)
        return 6
    return lvl


PNG_COMPRESSION = _png_compression()

try:  # OpenCV is the fast path; PIL covers the rest.
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

# The host library of the port (runtime/hostcodec.py): Go's Plan9 GIF
# quantizer, built without libjpeg.
from imageprocessor_tpu_torch.runtime import hostcodec as _native


# --- content sniffing (http.DetectContentType subset for images) -----------

_MAGIC = [
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"GIF87a", "image/gif"),
    (b"GIF89a", "image/gif"),
    (b"BM", "image/bmp"),
    (b"II*\x00", "image/tiff"),
    (b"MM\x00*", "image/tiff"),
]


def detect_content_type(head: bytes) -> str:
    """Magic-number sniff over the first 512 bytes, mirroring the upload
    usecase's http.DetectContentType gate (usecase/image/image.go:44-54)."""
    for magic, mime in _MAGIC:
        if head.startswith(magic):
            return mime
    if len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "image/webp"
    return "application/octet-stream"


def format_from_content_type(content_type: str) -> str:
    """MIME -> ImageFormat string (usecase/image/image.go:198-215)."""
    for key in ("jpeg", "png", "gif", "webp", "bmp", "tiff"):
        if key in content_type:
            return key
    return "jpeg"


def mime_from_path(path: str) -> str:
    """Extension -> content type (image_processor.go:164-182)."""
    ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
    return {
        "jpg": "image/jpeg", "jpeg": "image/jpeg", "png": "image/png",
        "gif": "image/gif", "webp": "image/webp", "bmp": "image/bmp",
        "tiff": "image/tiff", "tif": "image/tiff",
    }.get(ext, "image/jpeg")


def negotiate_format(requested: str, *, watermark: bool = False) -> str:
    """Output-format rule per op family (resize.go:78-91, watermark.go:66-79)."""
    fmt = (requested or "").lower()
    if fmt in ("jpg", "jpeg"):
        return "jpeg"
    if fmt == "png":
        return "png"
    if fmt == "gif":
        return "jpeg" if watermark else "gif"
    return "jpeg"


def jpeg_stream_complete(data: bytes) -> bool:
    """True iff a JPEG stream carries its EOI marker, i.e. was not cut
    mid-file. A naive `\\xff\\xd9 in tail` check false-positives when an
    embedded EXIF/JFIF *thumbnail's* EOI lands in the search window on a
    stream truncated inside the entropy data, so walk the length-prefixed
    header segments (skipping APPn/COM payloads) to the first SOS and
    search only the entropy data that follows: there, FF-stuffing
    (\\xff\\x00) and RSTn are the only FF escapes, so \\xff\\xd9 is
    genuinely the EOI. Returns False for unparseable headers too — the
    strict decoders downstream would reject those anyway (matching Go
    image.Decode error semantics, image_processor.go:47)."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return False
    i = 2
    while i + 2 <= n:
        if data[i] != 0xFF:
            return False  # lost marker sync: malformed header
        m = data[i + 1]
        if m == 0xFF:  # fill byte padding before a marker
            i += 1
            continue
        if m == 0xD9:  # EOI before any SOS: degenerate but complete
            return True
        if m == 0x01 or 0xD0 <= m <= 0xD8:  # TEM/RSTn/SOI: no payload
            i += 2
            continue
        if i + 4 > n:
            return False  # cut inside a marker's length field
        seg_len = (data[i + 2] << 8) | data[i + 3]
        if seg_len < 2:
            return False
        if m == 0xDA:  # SOS: entropy data follows the header payload
            return data.find(b"\xff\xd9", i + 2 + seg_len) != -1
        i += 2 + seg_len
    return False  # ran out of bytes before reaching SOS


# --- decode -----------------------------------------------------------------

def decode_image(data: bytes) -> tuple[np.ndarray, str]:
    """Decode to (H, W, 3) uint8 RGB + detected format string.

    Mirrors the worker's decode-once behavior (image_processor.go:47); a
    failure raises DecodeError, which the worker maps to status=failed.
    Alpha is composited the way Go's premultiplied RGBA pipeline renders
    semi-transparent pixels when later JPEG-encoded: rgb * alpha
    (i.e. over black).
    """
    mime = detect_content_type(data[:512])
    fmt = format_from_content_type(mime) if mime != "application/octet-stream" else ""

    if fmt == "jpeg" and not jpeg_stream_complete(data):
        # The stream was cut mid-file. Both libjpeg and cv2 RECOVER
        # from this (gray/zero fill) and would return a half-garbage
        # image as success; the reference's Go image.Decode errors
        # instead (worker marks the task failed), so match that.
        raise DecodeError("truncated JPEG stream (no EOI marker)")

    if fmt == "gif" or not _HAS_CV2:
        return _decode_pil(data, fmt)

    buf = np.frombuffer(data, dtype=np.uint8)
    arr = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    if arr is None:
        return _decode_pil(data, fmt)  # cv2 lacks the codec? try PIL
    # Normalize bit depth to uint8 BEFORE alpha handling: _flatten_alpha
    # divides alpha by 255, so a 16-bit RGBA (alpha up to 65535) fed in
    # first would scale rgb by up to 257x and saturate the whole image.
    if arr.dtype != np.uint8:
        arr = (arr.astype(np.float64) * (255.0 / np.iinfo(arr.dtype).max)).astype(np.uint8) \
            if np.issubdtype(arr.dtype, np.integer) else \
            np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = cv2.cvtColor(arr, cv2.COLOR_GRAY2RGB)
    elif arr.shape[2] == 4:
        arr = cv2.cvtColor(arr, cv2.COLOR_BGRA2RGBA)
        arr = _flatten_alpha(arr)
    else:
        arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    return np.ascontiguousarray(arr), fmt or "jpeg"


def _decode_pil(data: bytes, fmt_hint: str) -> tuple[np.ndarray, str]:
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(io.BytesIO(data)) as im:
            fmt = (im.format or fmt_hint or "jpeg").lower()
            if fmt == "jpg":
                fmt = "jpeg"
            im.seek(0)  # GIF: first frame only, like Go image.Decode
            # P-mode with a transparency index (transparent GIFs) must
            # route through RGBA: convert("RGB") would substitute the
            # palette entry's arbitrary color where Go's image/gif
            # yields {0,0,0,0} -> black after premultiplied encode.
            has_alpha = (im.mode in ("RGBA", "LA", "PA")
                         or (im.mode == "P"
                             and "transparency" in im.info))
            if has_alpha:
                arr = np.asarray(im.convert("RGBA"))
                arr = _flatten_alpha(arr)
            else:
                arr = np.asarray(im.convert("RGB"))
            return np.ascontiguousarray(arr), fmt
    except UnidentifiedImageError as exc:
        raise DecodeError(f"failed to decode image: {exc}") from exc
    except Exception as exc:  # truncated files etc.
        raise DecodeError(f"failed to decode image: {exc}") from exc


def _flatten_alpha(rgba: np.ndarray) -> np.ndarray:
    """Premultiply onto black: matches Go's RGBA (premultiplied) pipeline
    feeding jpeg.Encode, which uses the premultiplied channels directly."""
    a = rgba[..., 3:4].astype(np.float64) / 255.0
    rgb = (rgba[..., :3].astype(np.float64) * a)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


# --- encode -----------------------------------------------------------------

def encode_image(arr: np.ndarray, fmt: str, quality: int = 85) -> bytes:
    """Encode (H, W, 3) uint8 RGB. JPEG quality defaults to 85
    (domain/task.go:57)."""
    fmt = fmt.lower()
    if fmt == "jpg":
        fmt = "jpeg"
    if _HAS_CV2 and fmt in ("jpeg", "png", "bmp", "webp"):
        bgr = cv2.cvtColor(np.ascontiguousarray(arr), cv2.COLOR_RGB2BGR)
        if fmt == "jpeg":
            ok, out = cv2.imencode(".jpg", bgr,
                                   [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
        elif fmt == "png":
            # Default level 6 = Go png.Encode's zlib default (size
            # parity with the reference); IMAGEPROCESSOR_PNG_COMPRESSION
            # trades size for host throughput (see _png_compression for
            # the measured tradeoff).
            ok, out = cv2.imencode(
                ".png", bgr,
                [cv2.IMWRITE_PNG_COMPRESSION, PNG_COMPRESSION])
        elif fmt == "webp":
            ok, out = cv2.imencode(".webp", bgr,
                                   [cv2.IMWRITE_WEBP_QUALITY, int(quality)])
        else:
            ok, out = cv2.imencode(".bmp", bgr)
        if not ok:  # pragma: no cover
            raise DecodeError(f"failed to encode {fmt}")
        return out.tobytes()

    from PIL import Image

    bio = io.BytesIO()
    if fmt == "gif":
        # Go gif.Encode(nil) = fixed Plan9 palette + Floyd-Steinberg
        # (image/gif/writer.go -> draw.FloydSteinberg). The native
        # quantizer reproduces that arithmetic bit-for-bit, so decoded
        # pixels match the reference exactly; the LZW layer is lossless
        # and may differ byte-wise. IMAGEPROCESSOR_GIF_QUANTIZER=
        # adaptive restores the round-3/4 behavior (PIL median-cut
        # ADAPTIVE palette — usually higher PSNR but not Go-parity).
        mode = os.environ.get("IMAGEPROCESSOR_GIF_QUANTIZER", "go").lower()
        if mode != "adaptive":
            idx, pal = _native.gif_quantize_plan9(arr)
            pim = Image.fromarray(idx, mode="P")
            pim.putpalette(pal.reshape(-1).tolist())
            pim.save(bio, format="GIF")
            return bio.getvalue()
        Image.fromarray(arr).convert(
            "P", palette=Image.ADAPTIVE).save(bio, format="GIF")
        return bio.getvalue()
    im = Image.fromarray(arr)
    if fmt == "jpeg":
        im.save(bio, format="JPEG", quality=int(quality))
    else:
        im.save(bio, format=fmt.upper())
    return bio.getvalue()
