"""The plain reference: what each stored variant should hold, and the gap.

It imports nothing of the program. From an original's JPEG bytes, the
same bytes the generator handed to the program, it works out every
rendition the Go reference defines for the upload's flags:

* decode: libjpeg (OpenCV), the integer IDCT with fancy upsampling;
* thumbnail 200 crop-to-fit and resize 1024x768 keep-aspect: Go's
  ``xdraw.BiLinear`` in float64 and its 16-bit quantization (a frozen
  copy of the repository's independent oracle, tests/oracle.py);
* watermark: the text rasterized by FreeType at 72 dpi with the Go
  reference's metrics and anchor (watermark.go:96-151), composited
  src-over in float64, rounded half to even.

A stored variant is judged against that rendition as the configuration
stores it, a q85 4:2:0 JPEG, both decoded by libjpeg: ``gap_lsb`` is the
RMSE in 8-bit levels over the judged box between the stored variant and
the reference rendition encoded at the configuration's quality, and
``tile_gap_lsb`` the largest such RMSE over any 64 x 64 square of the
box (16 MCUs). Pixels that agree give the same JPEG and gaps of 0. A watermark is
judged over the text's box, where the program's JPEG splice re-encodes;
outside that box's band the splice keeps the original's own blocks, so
there ``outside_band_px`` counts the pixels that differ from the
original's at all.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import cv2
import numpy as np

THUMBNAIL_SIZE = 200
RESIZE_W, RESIZE_H = 1024, 768
WATERMARK_TEXT = "© ImageProcessor"
WATERMARK_OPACITY = 0.5
WATERMARK_FONT_SIZE = 36.0
WATERMARK_COLOR = (255, 255, 255)
WATERMARK_MARGIN = 20   # px, watermark.go:121


# --- the Go reference's resample (frozen copy of tests/oracle.py) ---------

def bilinear_resize_f64(img_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Go xdraw.BiLinear: src=(d+0.5)*S/D-0.5 clamped, 2-tap lerp, float64."""
    src_h, src_w, _ = img_u8.shape
    dst = np.arange(out_h, dtype=np.float64)
    src = np.clip((dst + 0.5) * (src_h / out_h) - 0.5, 0.0, src_h - 1.0)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, src_h - 1)
    f = (src - i0)[:, None, None]
    x = img_u8[i0].astype(np.float64) * (1 - f) + img_u8[i1].astype(np.float64) * f

    dst = np.arange(out_w, dtype=np.float64)
    src = np.clip((dst + 0.5) * (src_w / out_w) - 0.5, 0.0, src_w - 1.0)
    j0 = np.floor(src).astype(np.int64)
    j1 = np.minimum(j0 + 1, src_w - 1)
    f = (src - j0)[None, :, None]
    return x[:, j0] * (1 - f) + x[:, j1] * f


def quantize_go(x_f64: np.ndarray) -> np.ndarray:
    """Go 16-bit path: floor(g*257) >> 8 for g in [0,255] float."""
    g16 = np.floor(np.clip(x_f64, 0.0, 255.0) * 257.0).astype(np.int64)
    return (g16 >> 8).astype(np.uint8)


def keep_aspect_dims(w: int, h: int, width: int, height: int) -> tuple[int, int]:
    ratio = min(width / w, height / h)
    return max(int(w * ratio), 1), max(int(h * ratio), 1)


def resize_go(img_u8, width, height, keep_aspect=False):
    h, w = img_u8.shape[:2]
    if keep_aspect:
        width, height = keep_aspect_dims(w, h, width, height)
    return quantize_go(bilinear_resize_f64(img_u8, height, width))


def thumbnail_crop_go(img_u8, size):
    h, w = img_u8.shape[:2]
    if w > h:
        cx, cy, side = (w - h) // 2, 0, h
    else:
        cx, cy, side = 0, (h - w) // 2, w
    return quantize_go(bilinear_resize_f64(img_u8[cy:cy + side, cx:cx + side],
                                           size, size))


# --- the watermark --------------------------------------------------------

@dataclass(frozen=True)
class Text:
    coverage: np.ndarray   # (th, tw) float64 in [0, 1], baseline at ``ascent``
    width_px: int
    ascent: int


_TEXT: dict = {}


def rasterize(font_path: str, text: str = WATERMARK_TEXT,
              size: float = WATERMARK_FONT_SIZE) -> Text:
    """FreeType at 72 dpi (1 pt = 1 px); the text box is the sum of the
    glyph advances wide (watermark.go:109-116)."""
    key = (font_path, text, size)
    if key not in _TEXT:
        from PIL import Image, ImageDraw, ImageFont

        font = ImageFont.truetype(font_path, int(round(size)))
        ascent, descent = font.getmetrics()
        width_px = int(math.ceil(font.getlength(text)))
        img = Image.new("L", (width_px + 8, ascent + descent), 0)
        ImageDraw.Draw(img).text((0, 0), text, fill=255, font=font)
        _TEXT[key] = Text(np.asarray(img, dtype=np.float64) / 255.0,
                          width_px, ascent)
    return _TEXT[key]


def text_box(text: Text, h: int, w: int) -> tuple[int, int, int, int]:
    """(y0, x0, y1, x1) of the text's tile, anchored bottom-right: the
    baseline WATERMARK_MARGIN above the bottom, the box's right edge
    WATERMARK_MARGIN from the right (watermark.go:121-148), clipped."""
    th, tw = text.coverage.shape
    x0 = w - text.width_px - WATERMARK_MARGIN
    y0 = h - WATERMARK_MARGIN - text.ascent
    return max(y0, 0), max(x0, 0), min(y0 + th, h), min(x0 + tw, w)


def watermark(img_u8: np.ndarray, text: Text) -> np.ndarray:
    """Src-over composite of the white text at opacity 0.5 (alpha
    int(255 * 0.5) / 255, as the Go reference's colour.RGBA)."""
    h, w = img_u8.shape[:2]
    th, tw = text.coverage.shape
    x0 = w - text.width_px - WATERMARK_MARGIN
    y0 = h - WATERMARK_MARGIN - text.ascent
    ys, xs, ye, xe = text_box(text, h, w)
    out = img_u8.copy()
    cov = text.coverage[ys - y0:ye - y0, xs - x0:xe - x0]
    m = (cov * (int(255 * WATERMARK_OPACITY) / 255.0))[:, :, None]
    col = np.asarray(WATERMARK_COLOR, dtype=np.float64)
    region = out[ys:ye, xs:xe].astype(np.float64) * (1 - m) + col * m
    out[ys:ye, xs:xe] = np.clip(np.round(region), 0, 255).astype(np.uint8)
    return out


# --- JPEG in and out ------------------------------------------------------

def decode(data: bytes) -> np.ndarray:
    """(h, w, 3) RGB by libjpeg; ValueError when it is no image."""
    arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if arr is None:
        raise ValueError("not a decodable image")
    return cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)


def encode(rgb: np.ndarray, quality: int) -> bytes:
    ok, out = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
    if not ok:
        raise RuntimeError("cv2 could not encode")
    return out.tobytes()


def jpeg_dims(data: bytes) -> tuple[int, int] | None:
    """(h, w) from a JPEG's SOF marker, without decoding; None when the
    bytes hold none."""
    if data[:2] != b"\xff\xd8":
        return None
    i = 2
    while i + 9 < len(data):
        if data[i] != 0xFF:
            return None
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg = int.from_bytes(data[i + 2:i + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return (int.from_bytes(data[i + 5:i + 7], "big"),
                    int.from_bytes(data[i + 7:i + 9], "big"))
        i += 2 + seg
    return None


# --- what an upload should produce -----------------------------------------

def operations(flags: list[str]) -> list[str]:
    """The operations the API makes of the upload's flags, in order
    (handler/image/image.go:222-277): none means thumbnail and resize."""
    ops = [op for op in ("thumbnail", "resize", "watermark") if op in flags]
    return ops or ["thumbnail", "resize"]


def expected_dims(op: str, h: int, w: int) -> tuple[int, int]:
    if op == "thumbnail":
        return THUMBNAIL_SIZE, THUMBNAIL_SIZE
    if op == "resize":
        rw, rh = keep_aspect_dims(w, h, RESIZE_W, RESIZE_H)
        return rh, rw
    return h, w


@dataclass
class Rendition:
    pixels: np.ndarray                   # the reference's u8 rendition
    box: tuple[int, int, int, int]       # where it is judged: (y0, x0, y1, x1)
    keep: np.ndarray | None = None       # pixels kept exactly outside the band


def renditions(original: bytes, ops: list[str], font_path: str) -> dict[str, Rendition]:
    src = decode(original)
    h, w = src.shape[:2]
    out = {}
    for op in ops:
        if op == "thumbnail":
            px = thumbnail_crop_go(src, THUMBNAIL_SIZE)
            out[op] = Rendition(px, (0, 0, *px.shape[:2]))
        elif op == "resize":
            px = resize_go(src, RESIZE_W, RESIZE_H, keep_aspect=True)
            out[op] = Rendition(px, (0, 0, *px.shape[:2]))
        elif op == "watermark":
            text = rasterize(font_path)
            out[op] = Rendition(watermark(src, text), text_box(text, h, w), keep=src)
        else:
            raise ValueError(f"no reference for {op!r}")
    return out


def stored_view(expected: Rendition, quality: int) -> np.ndarray:
    """The reference rendition as the store would hold it, over its box:
    encoded at ``quality`` and decoded by libjpeg. Only the box's band
    is encoded: its blocks and chroma samples are those of the whole
    image."""
    y0, x0, y1, x1 = expected.box
    h, w = expected.pixels.shape[:2]
    a0, b0, a1, b1 = band(expected.box, h, w)
    crop = np.ascontiguousarray(expected.pixels[a0:a1, b0:b1])
    return decode(encode(crop, quality))[y0 - a0:y1 - a0, x0 - b0:x1 - b0]


def band(box: tuple[int, int, int, int], h: int, w: int) -> tuple[int, int, int, int]:
    """The box widened to the 16-px MCU grid and by one MCU more each
    side: the most that re-encoding the box's blocks can change in a
    4:2:0 JPEG, the chroma upsampling's reach across an edge included."""
    y0, x0, y1, x1 = box
    return (max(y0 // 16 * 16 - 16, 0), max(x0 // 16 * 16 - 16, 0),
            min(-(-y1 // 16) * 16 + 16, h), min(-(-x1 // 16) * 16 + 16, w))


def outside_band_px(stored: np.ndarray, expected: Rendition) -> float:
    """Pixels outside the box's band where the stored variant, decoded,
    differs from the original decoded by the same decoder; 0 where the
    rendition keeps nothing; inf when the dims differ."""
    if expected.keep is None:
        return 0.0
    if stored.shape != expected.keep.shape:
        return math.inf
    h, w = stored.shape[:2]
    a0, b0, a1, b1 = band(expected.box, h, w)
    changed = (stored != expected.keep).any(axis=2)
    changed[a0:a1, b0:b1] = False
    return float(changed.sum())


def tile_gap_lsb(stored: np.ndarray, expected: Rendition, view: np.ndarray,
                 tile: int = 64) -> float:
    """The largest RMSE in 8-bit levels over any ``tile`` x ``tile``
    square of the box: a fault confined to a few blocks, which the box's
    RMSE averages away, reads here diluted only to the square. Squares
    step by ``tile`` from the box's corner; the last of each row and
    column ends at the box's far edge, so that every square is whole
    (a box narrower than ``tile`` gives squares as wide as the box)."""
    if stored.shape != expected.pixels.shape:
        return math.inf
    y0, x0, y1, x1 = expected.box
    d = stored[y0:y1, x0:x1].astype(np.float64) - view
    if not d.size:
        return math.inf
    h, w = d.shape[:2]
    th, tw = min(tile, h), min(tile, w)
    c = np.zeros((h + 1, w + 1))
    c[1:, 1:] = (d * d).sum(axis=2).cumsum(axis=0).cumsum(axis=1)
    rows = np.unique(np.append(np.arange(0, h - th + 1, tile), h - th))
    cols = np.unique(np.append(np.arange(0, w - tw + 1, tile), w - tw))
    r, q = rows[:, None], cols[None, :]
    sums = c[r + th, q + tw] - c[r, q + tw] - c[r + th, q] + c[r, q]
    return float(np.sqrt(sums.max() / (th * tw * d.shape[2])))


def gap_lsb(stored: np.ndarray, expected: Rendition, view: np.ndarray) -> float:
    """RMSE in 8-bit levels over the rendition's box between the stored
    variant (decoded) and ``view``, the reference's (stored_view); inf
    when the dims differ."""
    if stored.shape != expected.pixels.shape:
        return math.inf
    y0, x0, y1, x1 = expected.box
    d = stored[y0:y1, x0:x1].astype(np.float64) - view
    return float(np.sqrt(np.mean(d * d))) if d.size else math.inf
