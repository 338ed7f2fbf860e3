"""Text watermark: host-rasterized glyph tile, alpha-blended in place on the
device — the counterpart of imageprocessor_tpu/ops/watermark.py.

The glyph helpers (``WatermarkTile``, ``rasterize_text``, ``parse_color``,
``resolve_color``, ``anchor_baseline``/``_anchor_traced``, ``_pad_tile``,
``quantize_tile``) are copies of the reference's, which lives in a module
that imports jax; tests/test_torch_watermark.py holds their source and
their results equal to the originals'. ``_default_font_path`` looks in the
same places as the reference's, the reference package's
``assets/fonts`` directory included, so one font there serves both.

The blend (``watermark_planar_``) is the counterpart of
``batched_watermark_core_planar`` and ``_blend_at_planar``: per image,
the window is clamped into the canvas and the tile read shifted by the
same amount, pixels past the image's valid (h, w) are masked, the
composite is float32, rounded half to even and clipped. It writes into
the canvas it is given (the reference donates its input buffer for the
same effect). The reference blends with XLA ops, not a Pallas kernel, so
this is plain tensor code.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from imageprocessor_tpu_torch.domain.task import WatermarkPosition

_MARGIN = 20  # px, reference watermark.go:121

# the reference package's bundled-font directory, read as a path (never
# imported), so a font dropped there serves both packages
_REFERENCE_FONTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "imageprocessor_tpu", "assets", "fonts")


@dataclass(frozen=True)
class WatermarkTile:
    """Host-rasterized coverage mask plus the metrics the anchor math needs.

    coverage: (Th, Tw) float32 in [0, 1] — glyph coverage, baseline at row
    `ascent`. width_px/height_px mirror the reference's text-box metrics
    (watermark.go:109-116): advance-sum width, fontSize*1.2 height.
    """

    coverage: np.ndarray
    width_px: int
    height_px: int
    ascent: int
    descent: int


_FONT_LOCK = threading.Lock()
# Bounded like PipelineModel's arg caches: the key is user-controlled
# (watermark_text form field), so an unbounded dict is a slow memory
# leak on a long-lived worker. FIFO eviction via dict insertion order.
_TILE_CACHE: dict[tuple, WatermarkTile] = {}
_TILE_CACHE_MAX = 128
_DEFAULT_FONT_PATH: str | None = None

# Widest tile the rasterizer will allocate. The blend window clips to
# the image and no bucket exceeds 6144 px, so glyphs past this are
# never visible; without the cap a 64 KiB watermark_text rasterizes a
# multi-GB coverage buffer (the Go reference draws clipped into the
# image and never allocates text-proportional memory,
# watermark.go:96-151). Anchor math uses the CLIPPED width for
# right/center positions — a documented divergence for absurd texts.
_MAX_TILE_W = 8192


def _default_font_path() -> str:
    """Bundled-font lookup, in the reference's priority order:

    1. IMAGEPROCESSOR_FONT env var,
    2. a Go-Regular TTF in the reference package's assets/fonts/,
    3. matplotlib's DejaVu Sans as fallback.
    """
    global _DEFAULT_FONT_PATH
    if _DEFAULT_FONT_PATH is None:
        env = os.environ.get("IMAGEPROCESSOR_FONT")
        if env:
            _DEFAULT_FONT_PATH = env
        else:
            for name in ("Go-Regular.ttf", "GoRegular.ttf", "goregular.ttf"):
                cand = os.path.join(_REFERENCE_FONTS, name)
                if os.path.exists(cand):
                    _DEFAULT_FONT_PATH = cand
                    break
            else:
                import matplotlib
                _DEFAULT_FONT_PATH = (
                    matplotlib.get_data_path() + "/fonts/ttf/DejaVuSans.ttf")
    return _DEFAULT_FONT_PATH


def rasterize_text(text: str, font_size: float = 36.0,
                   font_path: str | None = None) -> WatermarkTile:
    """Render `text` to a coverage tile (cached per (text, size, font)).

    Uses FreeType via PIL at DPI 72 (1 pt == 1 px), matching the
    reference's freetype context setup (watermark.go:96-104).
    """
    font_path = font_path or _default_font_path()
    key = (text, float(font_size), font_path)
    tile = _TILE_CACHE.get(key)
    if tile is not None:
        return tile
    with _FONT_LOCK:
        tile = _TILE_CACHE.get(key)
        if tile is not None:
            return tile
        from PIL import Image, ImageDraw, ImageFont

        font = ImageFont.truetype(font_path, int(round(font_size)))
        ascent, descent = font.getmetrics()
        # Reference width = ceil(sum of glyph advances) (watermark.go:109-115)
        width_px = min(int(np.ceil(font.getlength(text))), _MAX_TILE_W - 8)
        height_px = int(np.ceil(font_size * 1.2))  # watermark.go:116
        th = ascent + descent
        tw = max(width_px + 8, 1)  # small slack for right-side overhang
        img = Image.new("L", (tw, th), 0)
        draw = ImageDraw.Draw(img)
        draw.text((0, 0), text, fill=255, font=font)
        coverage = np.asarray(img, dtype=np.float32) / 255.0
        tile = WatermarkTile(coverage=coverage, width_px=width_px,
                             height_px=height_px, ascent=ascent,
                             descent=descent)
        while len(_TILE_CACHE) >= _TILE_CACHE_MAX:
            _TILE_CACHE.pop(next(iter(_TILE_CACHE)))
        _TILE_CACHE[key] = tile
        return tile


def anchor_baseline(position: str, img_w, img_h, tile: WatermarkTile):
    """Baseline origin (x, y) for the text, reference watermark.go:121-148.

    Works with Python ints (static path) or traced int32 scalars/arrays
    (batched path). Unknown positions fall through to bottom-right, like
    the reference's default case. One implementation for both entry
    points: delegates to _anchor_traced (same arithmetic, runtime
    width/height inputs) so the single-image and batched paths cannot
    drift."""
    return _anchor_traced(position, img_w, img_h,
                          tile.width_px, tile.height_px)


def parse_color(color_str: str, opacity: float) -> tuple[int, int, int, int]:
    """"R,G,B[,A]" -> RGBA, reference parseColor (watermark.go:159-186).

    Invalid strings fall back to white at opacity alpha — but note the
    reference then *uses black* when parse errors (watermark.go:92-94);
    callers pass the parsed flag accordingly.
    """
    s = color_str.replace(" ", "")
    parts = s.split(",")
    default_a = int(255 * opacity)
    if len(parts) not in (3, 4):
        raise ValueError("invalid color format")
    try:
        r, g, b = int(parts[0]), int(parts[1]), int(parts[2])
    except ValueError as exc:
        raise ValueError("invalid color values") from exc
    clamp = lambda v: max(0, min(255, v))  # noqa: E731
    a = default_a
    if len(parts) == 4:
        try:
            a = clamp(int(parts[3]))
        except ValueError:
            a = default_a
    return clamp(r), clamp(g), clamp(b), a


def resolve_color(color_str: str, opacity: float) -> tuple[int, int, int, int]:
    """Reference error path: parse failure -> black at opacity
    (watermark.go:92-94)."""
    try:
        return parse_color(color_str, opacity)
    except ValueError:
        return 0, 0, 0, int(255 * opacity)


def _pad_tile(tile: WatermarkTile) -> np.ndarray:
    th, tw = tile.coverage.shape
    out = np.zeros((3 * th, 3 * tw), dtype=np.float32)
    out[th:2 * th, tw:2 * tw] = tile.coverage
    return out


def quantize_tile(tile: WatermarkTile, h_mult: int = 16,
                  w_mult: int = 64) -> WatermarkTile:
    """Zero-pad coverage to quantized dims so different watermark texts
    share one compiled program (shape stability; content stays dynamic)."""
    th, tw = tile.coverage.shape
    qh = -(-th // h_mult) * h_mult
    qw = -(-tw // w_mult) * w_mult
    if (qh, qw) == (th, tw):
        return tile
    cov = np.zeros((qh, qw), dtype=np.float32)
    cov[:th, :tw] = tile.coverage
    return WatermarkTile(coverage=cov, width_px=tile.width_px,
                         height_px=tile.height_px, ascent=tile.ascent,
                         descent=tile.descent)


def _anchor_traced(position: str, img_w, img_h, width_px, height_px):
    """Anchor arithmetic (watermark.go:121-148) over traced scalars —
    width_px/height_px are runtime inputs so text changes don't recompile."""
    try:
        pos = WatermarkPosition(position)
    except ValueError:
        pos = WatermarkPosition.BOTTOM_RIGHT
    m = _MARGIN
    if pos is WatermarkPosition.TOP_LEFT:
        return m + 0 * img_w, m + height_px + 0 * img_h
    if pos is WatermarkPosition.TOP_RIGHT:
        return img_w - width_px - m, m + height_px + 0 * img_h
    if pos is WatermarkPosition.TOP_CENTER:
        return (img_w - width_px) // 2, m + height_px + 0 * img_h
    if pos is WatermarkPosition.BOTTOM_LEFT:
        return m + 0 * img_w, img_h - m
    if pos is WatermarkPosition.BOTTOM_CENTER:
        return (img_w - width_px) // 2, img_h - m
    if pos is WatermarkPosition.CENTER:
        return (img_w - width_px) // 2, (img_h + height_px) // 2
    return img_w - width_px - m, img_h - m


def watermark_planar_(imgs: torch.Tensor, src_hw: np.ndarray,
                      tile: WatermarkTile, color: tuple[int, int, int],
                      alpha: float, position: str) -> torch.Tensor:
    """Blend ``tile`` into each image of a (B, 3, H, W) u8 canvas, in place.

    src_hw: (B, 2) valid dims; the text anchors to each image's valid
    extent and is masked past it. color: (r, g, b); alpha: a / 255. The
    window is clamped into the canvas and the tile read shifted by the
    same amount (zeros where the text falls outside the window), exactly
    as the reference's ``_blend_at_planar``. Every image's window is
    gathered, blended and scattered back at once: the window table is
    built on the host and copied with the tile. Returns ``imgs``."""
    b, _, h, w = imgs.shape
    th, tw = tile.coverage.shape
    win_h, win_w = min(th, h), min(tw, w)
    geo = np.zeros((b, 6), np.int64)   # dy, dx, ty, tx, valid h, valid w
    for i, (vh, vw) in enumerate(np.asarray(src_hw, dtype=np.int64)):
        bx, by = _anchor_traced(position, int(vw), int(vh), tile.width_px,
                                tile.height_px)
        x0, y0 = int(bx), int(by) - tile.ascent
        dx = min(max(x0, 0), w - win_w)
        dy = min(max(y0, 0), h - win_h)
        geo[i] = (dy, dx, min(max(dy - y0 + th, 0), 3 * th - win_h),
                  min(max(dx - x0 + tw, 0), 3 * tw - win_w), vh, vw)
    dev = imgs.device
    dy, dx, ty, tx, vh, vw = torch.from_numpy(geo).to(dev).unbind(1)
    padded = torch.from_numpy(_pad_tile(tile)).to(dev)
    r = torch.arange(win_h, device=dev)
    c = torch.arange(win_w, device=dev)
    rows = (dy[:, None] + r)[:, None, :, None]          # (B, 1, win_h, 1)
    cols = (dx[:, None] + c)[:, None, None, :]          # (B, 1, 1, win_w)
    cov = padded[(ty[:, None] + r)[:, :, None], (tx[:, None] + c)[:, None, :]]
    inside = (rows < vh[:, None, None, None]) & (cols < vw[:, None, None, None])
    m = cov[:, None] * inside.to(torch.float32) * np.float32(alpha).item()
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ci = torch.arange(3, device=dev)[None, :, None, None]
    region = imgs[bi, ci, rows, cols].to(torch.float32)  # (B, 3, win_h, win_w)
    col = torch.tensor(color, dtype=torch.float32).to(dev)[None, :, None, None]
    blended = region * (1.0 - m) + col * m
    imgs[bi, ci, rows, cols] = torch.clamp(torch.round(blended), 0, 255).to(torch.uint8)
    return imgs


def watermark_image(arr_hwc: np.ndarray, op) -> np.ndarray:
    """One (h, w, 3) u8 image watermarked on the CPU — the splice's host
    fallback (the reference's ``watermark_image`` with a plan op's
    text, position, opacity, font size and colour). Returns a new array."""
    tile = rasterize_text(op.text, op.font_size)
    r, g, b, a = resolve_color(op.font_color, op.opacity)
    h, w = arr_hwc.shape[:2]
    imgs = torch.from_numpy(
        np.asarray(arr_hwc)[:, :, :3].transpose(2, 0, 1).copy())[None]
    watermark_planar_(imgs, np.array([[h, w]]), tile, (r, g, b), a / 255.0,
                      op.position)
    return imgs[0].permute(1, 2, 0).contiguous().numpy()
