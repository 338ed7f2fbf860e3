"""Plain PyTorch JPEG coefficient decode — the counterpart of
imageprocessor_tpu/ops/jpeg_decode.py:batched_decode_ycbcr.

This is the plain version of kernel B1 (csrc/jpeg_decode.cu): the CPU
tests run it, and chip_smoke.py holds the kernel against it on the card.
It computes, per image of the batch:

* dequantize with the image's own 8x8 tables, clamp to +-DEQUANT_CLAMP;
* separable 8-point IDCT, +128 level shift;
* for subsampled chroma: replicate the last valid chroma row/col (the
  image's ``chroma_valid`` extent) over the canvas padding, clamp to
  [0, 255], libjpeg's fancy (triangular) 2x upsample per subsampled axis;
* BT.601 YCbCr -> RGB, crop to (out_h, out_w), round half to even, clip.

Pixels outside an image's valid (h, w) region are unspecified.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# |dequantized coef| from pixel-sourced streams stays <= 255*8 + q/2; the
# clamp only bites synthetic canvases (same constant as the reference).
DEQUANT_CLAMP = 4096.0


@functools.lru_cache(maxsize=1)
def idct_basis() -> np.ndarray:
    """D[k, n] such that spatial = D^T @ coef @ D (type-III DCT), float32."""
    d = np.zeros((8, 8), dtype=np.float64)
    for k in range(8):
        ck = np.sqrt(0.25) if k else np.sqrt(0.125)
        for n in range(8):
            d[k, n] = ck * np.cos((2 * n + 1) * k * np.pi / 16.0)
    return d.astype(np.float32)


def idct_planes(coefs: torch.Tensor, qtabs: torch.Tensor) -> torch.Tensor:
    """(B, bh*8, bw*8) int16 quantized coefs + (B, 8, 8) float32 tables
    -> float32 samples, level-shifted +128."""
    b, hh, ww = coefs.shape
    d = torch.from_numpy(idct_basis()).to(coefs.device)
    x = coefs.to(torch.float32).reshape(b, hh // 8, 8, ww // 8, 8)
    x = x * qtabs[:, None, :, None, :]
    x = torch.clamp(x, -DEQUANT_CLAMP, DEQUANT_CLAMP)
    x = torch.einsum("ki,bhkwl->bhiwl", d, x)   # vertical
    x = torch.einsum("bhiwl,lj->bhiwj", x, d)   # horizontal
    return x.reshape(b, hh, ww) + 128.0


def clamp_extent(plane: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
    """Replicate each image's last valid row/col across the canvas
    padding: (B, h, w) planes, (B, 2) valid extents."""
    b, h, w = plane.shape
    vh = torch.clamp(valid_hw[:, :1].to(torch.int64), 1, h)
    vw = torch.clamp(valid_hw[:, 1:2].to(torch.int64), 1, w)
    iy = torch.minimum(torch.arange(h, device=plane.device)[None], vh - 1)
    plane = torch.gather(plane, 1, iy[:, :, None].expand(b, h, w))
    ix = torch.minimum(torch.arange(w, device=plane.device)[None], vw - 1)
    return torch.gather(plane, 2, ix[:, None, :].expand(b, h, w))


def fancy_up2(plane: torch.Tensor, dim: int) -> torch.Tensor:
    """libjpeg "fancy" 2x upsample along ``dim`` (edges clamp):
    out[2i] = (3*in[i] + in[i-1]) / 4, out[2i+1] = (3*in[i] + in[i+1]) / 4."""
    n = plane.shape[dim]
    prev = torch.cat([plane.narrow(dim, 0, 1), plane.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([plane.narrow(dim, 1, n - 1), plane.narrow(dim, n - 1, 1)], dim)
    even = (3.0 * plane + prev) * 0.25
    odd = (3.0 * plane + nxt) * 0.25
    shape = list(plane.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def decode_ycbcr(yc: torch.Tensor, cbc: torch.Tensor, crc: torch.Tensor,
                 qtabs: torch.Tensor, chroma_valid: torch.Tensor,
                 fh: int = 2, fw: int = 2,
                 out_h: int | None = None, out_w: int | None = None
                 ) -> torch.Tensor:
    """Batched YCbCr coefficient decode into a planar u8 bucket.

    yc: (B, H, W) int16 luma canvases; cbc/crc: (B, H/fh, W/fw) int16;
    qtabs: (B, 3, 8, 8) float32; chroma_valid: (B, 2) int32, each image's
    chroma plane dims. fh/fw: (2, 2) 4:2:0, (1, 2) 4:2:2, (2, 1) 4:4:0,
    (1, 1) 4:4:4. Returns (B, 3, out_h, out_w) uint8 (default: H, W).
    """
    y = idct_planes(yc, qtabs[:, 0])
    cb = idct_planes(cbc, qtabs[:, 1])
    cr = idct_planes(crc, qtabs[:, 2])
    if fh > 1 or fw > 1:
        cb = torch.clamp(clamp_extent(cb, chroma_valid), 0.0, 255.0)
        cr = torch.clamp(clamp_extent(cr, chroma_valid), 0.0, 255.0)
    if fh == 2:
        cb, cr = fancy_up2(cb, 1), fancy_up2(cr, 1)
    if fw == 2:
        cb, cr = fancy_up2(cb, 2), fancy_up2(cr, 2)
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    bch = y + 1.772 * cb
    rgb = torch.stack([r, g, bch], dim=1)
    rgb = rgb[:, :, :out_h, :out_w]
    return torch.clamp(torch.round(rgb), 0.0, 255.0).to(torch.uint8)
