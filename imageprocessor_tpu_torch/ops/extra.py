"""Crop, rotate, flip and grayscale — counterpart of
imageprocessor_tpu/ops/extra.py.

The Go service declares these operation types and rejects them at
dispatch; the reference implements all four on the device, and so does
the port. None of them reaches a hand-written kernel in the reference
(they are gathers and elementwise arithmetic), so here they are plain
PyTorch ops that run on whatever device their input lies on.

Two families, as in the reference:

* single-image functions on one (h, w, C) u8 tensor (``crop_image``,
  ``rotate_image``, ``flip_image``, ``grayscale_image``): the
  single-image path of the engine;
* batched functions on one padded group (``batched_crop``,
  ``batched_flip``, ``batched_rotate``, ``batched_grayscale_planar``),
  each image valid inside its own (h_i, w_i) extent of the bucket. The
  reference runs crop, flip and rotate on its HWC layout only because its
  planar layout exists for the Pallas kernels; the port's bucket is
  planar (B, 3, Hb, Wb) everywhere, so the batched functions take and
  return planar tensors (the reference's axes 1, 2 are 2, 3 here).

Arithmetic follows the reference operation by operation, in float32:
Go's 16-bit luma for grayscale, and for angles that are not multiples of
90 degrees an inverse-mapped bilinear sample about the image's centre,
black outside the source, rounded half to even.
"""

from __future__ import annotations

import numpy as np
import torch


def crop_image(img: torch.Tensor, x: int, y: int, width: int,
               height: int) -> torch.Tensor:
    """Rectangular crop of (h, w, C), clamped to the image bounds."""
    h, w = int(img.shape[0]), int(img.shape[1])
    x = max(0, min(x, w - 1))
    y = max(0, min(y, h - 1))
    width = max(1, min(width, w - x))
    height = max(1, min(height, h - y))
    return img[y:y + height, x:x + width]


def _cos_sin(angle_deg: float) -> tuple[float, float]:
    """cos and sin of the angle, computed in float32 on the host (the
    angle is a plan constant), so every device samples with the same
    two numbers."""
    theta = torch.deg2rad(torch.tensor(angle_deg, dtype=torch.float32))
    return torch.cos(theta).item(), torch.sin(theta).item()


def _rotate_about_centre(img_chw: torch.Tensor, h: int, w: int,
                         cos_t: float, sin_t: float) -> torch.Tensor:
    """Counter-clockwise rotation of the (h, w) image in the top-left of
    a (C, Hc, Wc) u8 canvas about its own centre, onto the same canvas.

    Destination pixels map back to the source (inverse map, screen y
    pointing down); the four neighbours are clamped to the image's own
    extent, so edge samples replicate border pixels and never read the
    canvas padding; samples whose source lies outside
    [-0.5, dim - 0.5] are black."""
    hc, wc = int(img_chw.shape[1]), int(img_chw.shape[2])
    dev = img_chw.device
    cy, cx = (h - 1.0) / 2.0, (w - 1.0) / 2.0
    dy = torch.arange(hc, dtype=torch.float32, device=dev)[:, None] - cy
    dx = torch.arange(wc, dtype=torch.float32, device=dev)[None, :] - cx
    src_x = cos_t * dx - sin_t * dy + cx
    src_y = sin_t * dx + cos_t * dy + cy
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = src_x - x0
    fy = src_y - y0
    valid = ((src_x >= -0.5) & (src_x <= w - 0.5)
             & (src_y >= -0.5) & (src_y <= h - 0.5))
    x0, y0 = x0.long(), y0.long()

    def g(yi, xi):
        return img_chw[:, yi.clamp(0, h - 1), xi.clamp(0, w - 1)].to(torch.float32)

    p00, p10 = g(y0, x0), g(y0 + 1, x0)
    top = p00 + (g(y0, x0 + 1) - p00) * fx
    bot = p10 + (g(y0 + 1, x0 + 1) - p10) * fx
    out = top + (bot - top) * fy
    out = torch.where(valid, out, torch.zeros((), device=dev))
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _rotate_arbitrary(img: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """(h, w, C) rotated by any angle about its centre, same canvas."""
    h, w = int(img.shape[0]), int(img.shape[1])
    out = _rotate_about_centre(img.permute(2, 0, 1), h, w, *_cos_sin(angle_deg))
    return out.permute(1, 2, 0).contiguous()


def rotate_image(img: torch.Tensor, angle: float) -> torch.Tensor:
    """Rotate (h, w, C) counter-clockwise. Multiples of 90 degrees are
    exact pixel shuffles (``np.rot90``'s convention); other angles use the
    inverse-mapped bilinear sample on the same canvas."""
    a = float(angle) % 360.0
    if a == 0.0:
        return img
    if a in (90.0, 180.0, 270.0):
        return torch.rot90(img, k=int(a // 90), dims=(0, 1))
    return _rotate_arbitrary(img, a)


def flip_image(img: torch.Tensor, direction: str = "horizontal") -> torch.Tensor:
    """Mirror (h, w, C) horizontally (default) or vertically."""
    return torch.flip(img, dims=(0,) if direction == "vertical" else (1,))


def _luma_u8(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Go color.GrayModel on u8 channels, in the reference's float32
    order: y = (299 r + 587 g + 114 b + 500) / 1000 on 16-bit channels
    (v * 0x101), then the high byte.

    The reference's compiler turns the division by the constant 1000
    into a multiplication by float32(0.001); the multiplication is
    written out here, so both round the same way (the float32 sum passes
    2**24, so neither is Go's integer result everywhere: they differ from
    it by 1 at about one pixel in 10**5)."""
    r, g, b = (c.to(torch.float32) * 257.0 for c in (r, g, b))
    y16 = (299.0 * r + 587.0 * g + 114.0 * b + 500.0) * 0.001
    return torch.clamp(torch.floor(torch.floor(y16) / 256.0), 0, 255).to(torch.uint8)


def grayscale_image(img: torch.Tensor) -> torch.Tensor:
    """Luma grayscale of (h, w, 3 or 4), replicated across RGB so the
    output keeps its channels; an alpha channel is kept as it is."""
    y8 = _luma_u8(img[..., 0], img[..., 1], img[..., 2])
    out = y8[..., None].repeat(1, 1, 3)
    if img.shape[-1] == 4:
        out = torch.cat([out, img[..., 3:]], dim=-1)
    return out


# --- batched variants on a planar bucket -------------------------------------

def batched_grayscale_planar(imgs: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) luma over a full bucket; padding is harmless. The
    result is contiguous (three written planes, not a broadcast view), so
    kernel B3 reads it in place."""
    y8 = _luma_u8(imgs[:, 0], imgs[:, 1], imgs[:, 2])
    return y8[:, None].repeat(1, 3, 1, 1)


def _extents(src_hw, device) -> torch.Tensor:
    """(B, 2) valid dims as an int64 tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(src_hw), dtype=torch.int64,
                           device=device)


def batched_flip(imgs: torch.Tensor, src_hw,
                 direction: str = "horizontal") -> torch.Tensor:
    """Per-image mirror inside a padded (B, 3, Hb, Wb) bucket.

    A plain flip would mirror the padding into view; instead gather with
    per-image reversed indices clamped to the bucket. src_hw: (B, 2)
    valid (h, w) of each image on this canvas."""
    axis = 2 if direction == "vertical" else 3
    n = imgs.shape[axis]
    extent = _extents(src_hw, imgs.device)[:, axis - 2]
    idx = (extent[:, None] - 1 - torch.arange(n, device=imgs.device)).clamp(0, n - 1)
    idx = idx[:, None, :, None] if axis == 2 else idx[:, None, None, :]
    return torch.gather(imgs, axis, idx.expand(imgs.shape))


def batched_crop(imgs: torch.Tensor, src_hw, x: int, y: int, width: int,
                 height: int) -> torch.Tensor:
    """Plan-static crop rect, clamped per image like ``crop_image``.

    Output canvas (B, 3, height, width); each image's valid extent is
    (min(height, h_i - y_i), min(width, w_i - x_i)) with the same origin
    clamping as the single-image op (the engine computes those dims on
    the host). A clamped index gather, not a slice of the bucket: a slice
    would have to start at bucket - size when the rect passes the bucket
    edge, which shifts the crop origin; per-row and per-column clamped
    indices keep the origin exact, and what lies past an image's valid
    extent is cropped off when the output is finished."""
    b, c, bh, bw = imgs.shape
    dev = imgs.device
    hw = _extents(src_hw, dev)
    # clip(origin, 0, max(dim_i - 1, 0)) per image
    cy = (hw[:, 0] - 1).clamp(min=0, max=max(y, 0))
    cx = (hw[:, 1] - 1).clamp(min=0, max=max(x, 0))
    ry = (cy[:, None] + torch.arange(height, device=dev)).clamp(0, bh - 1)
    rx = (cx[:, None] + torch.arange(width, device=dev)).clamp(0, bw - 1)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    ci = torch.arange(c, device=dev)[None, :, None, None]
    return imgs[bi, ci, ry[:, None, :, None], rx[:, None, None, :]]


def batched_rotate(imgs: torch.Tensor, src_hw, angle: float) -> torch.Tensor:
    """Per-image rotate inside a padded (B, 3, Hb, Wb) bucket.

    Multiples of 90 degrees are exact shuffles composed from a transpose
    and the extent-aware flip (for 90 and 270 the valid dims swap and the
    output canvas is the transposed bucket, (B, 3, Wb, Hb)). Other angles
    inverse-map about each image's own centre; pixels from outside the
    source are black. Always returns a new tensor, so the caller may
    write into ``imgs`` afterwards."""
    a = float(angle) % 360.0
    if a == 0.0:
        return imgs.clone()
    hw = np.asarray(src_hw)
    if a in (90.0, 270.0):
        tr = imgs.transpose(2, 3)            # (B, 3, Wb, Hb)
        hw_t = hw[:, ::-1]                   # valid (w_i, h_i)
        # 90: out[y, x] = in[x, w_i - 1 - y]
        return batched_flip(tr, hw_t, "vertical" if a == 90.0 else "horizontal")
    if a == 180.0:
        return batched_flip(batched_flip(imgs, hw, "horizontal"), hw, "vertical")
    cos_t, sin_t = _cos_sin(a)
    return torch.stack([_rotate_about_centre(img, int(h), int(w), cos_t, sin_t)
                        for img, (h, w) in zip(imgs, hw)])
