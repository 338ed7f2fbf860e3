"""Resampling coordinate math — counterpart of imageprocessor_tpu/ops/coords.py.

Go's x/image/draw maps destination pixel centres to source space as
``src = (dst + 0.5) * (srcN / dstN) - 0.5`` with neighbour indices
clamped to the source bounds; output dims follow Go's float64 arithmetic
with int truncation. The three dims helpers are plain Python copies (the
reference module imports jax at its top); ``bilinear_coords`` and
``quantize_go_xdraw`` are the torch forms of the reference's jnp ones.
"""

from __future__ import annotations

import torch


def keep_aspect_dims(orig_w: int, orig_h: int, width: int, height: int) -> tuple[int, int]:
    """Aspect-preserving target size, min-ratio rule with truncation.

    Reference: operations/resize.go:63-72 — ratio = min(w/W, h/H);
    new = int(float64(orig) * ratio).
    """
    width_ratio = float(width) / float(orig_w)
    height_ratio = float(height) / float(orig_h)
    ratio = min(width_ratio, height_ratio)
    return int(float(orig_w) * ratio), int(float(orig_h) * ratio)


def thumbnail_dims(orig_w: int, orig_h: int, size: int) -> tuple[int, int]:
    """Non-cropping thumbnail target: shorter side == size.

    Reference: operations/thumbnail.go:53-64 (int truncation of the
    float64 product, longer side scaled proportionally).
    """
    if orig_w > orig_h:
        return int(float(orig_w) * float(size) / float(orig_h)), size
    return size, int(float(orig_h) * float(size) / float(orig_w))


def center_crop_rect(orig_w: int, orig_h: int) -> tuple[int, int, int]:
    """Center square crop (x, y, side). Reference: thumbnail.go:114-126."""
    if orig_w > orig_h:
        return (orig_w - orig_h) // 2, 0, orig_h
    return 0, (orig_h - orig_w) // 2, orig_w


def bilinear_coords(out_size: int, src_size: int, *, src_offset: float = 0.0,
                    scale: float | None = None, device=None):
    """Per-output-index source indices and lerp weight, float32 like the
    reference: (idx0, idx1, frac), each of shape (out_size,)."""
    if scale is None:
        scale = src_size / out_size
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    src = (dst + 0.5) * scale - 0.5 + src_offset
    src = torch.clamp(src, 0.0, float(src_size) - 1.0)
    idx0 = torch.floor(src).to(torch.int32)
    idx1 = torch.clamp(idx0 + 1, max=src_size - 1)
    frac = src - idx0.to(torch.float32)
    return idx0, idx1, frac


def quantize_go_xdraw(x: torch.Tensor) -> torch.Tensor:
    """Float [0, 255] -> uint8 with Go x/image/draw's 16-bit path:
    floor(g * 257) >> 8 == floor(g * 257 / 256)."""
    return torch.clamp(torch.floor(x * (257.0 / 256.0)), 0.0, 255.0).to(torch.uint8)
