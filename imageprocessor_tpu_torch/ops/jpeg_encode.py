"""Plain PyTorch JPEG encode front half — the counterpart of
imageprocessor_tpu/ops/jpeg_encode.py:batched_encode_420.

This is the plain version of kernel B3 (csrc/jpeg_encode.cu): the CPU
tests run it, and chip_smoke.py holds the kernel against it on the card.
Per image of the batch it computes:

* edge replication: samples past the image's valid (h, w) repeat its last
  valid row and column (libjpeg pads the MCU grid the same way);
* BT.601/JFIF RGB -> YCbCr;
* 4:2:0 chroma: the 2x2 box mean;
* the orthonormal 8x8 FDCT, coef = D @ (x - 128) @ D^T, in float32 with
  the exact basis (the reference's default rounds the basis to bf16, a
  TPU matmul precision mode; both sit within one quantization step of
  the exact transform);
* divide by the quality-scaled IJG table, round half to even, clamp to
  the baseline range +-1023.

Coefficients of blocks past ceil16(valid) are computed but never emitted.
``quality_qtables`` and the Annex K tables are copies of the reference's
(tests/test_torch_jpeg_encode.py holds them equal).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageprocessor_tpu_torch.ops.jpeg_decode import clamp_extent, idct_basis

# Annex K (K.1/K.2) base quantization tables, natural (row-major) order.
_BASE_QT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], dtype=np.int32).reshape(8, 8)
_BASE_QT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], dtype=np.int32).reshape(8, 8)

# Largest magnitude of a baseline (8-bit) quantized coefficient.
COEF_CLAMP = 1023


@functools.lru_cache(maxsize=32)
def quality_qtables(quality: int) -> np.ndarray:
    """(2, 8, 8) uint16 quant tables for an IJG-style quality in [1, 100]
    (the scaling libjpeg and Go's image/jpeg both apply to Annex K)."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = np.empty((2, 8, 8), dtype=np.uint16)
    for i, base in enumerate((_BASE_QT_LUMA, _BASE_QT_CHROMA)):
        t = (base * scale + 50) // 100
        out[i] = np.clip(t, 1, 255).astype(np.uint16)
    return out


def fdct_quantize(planes: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """(B, bh*8, bw*8) float32 samples + (8, 8) float32 table -> int16
    quantized coefficients in the spatial block layout."""
    b, hh, ww = planes.shape
    d = torch.from_numpy(idct_basis()).to(planes.device)
    x = planes.reshape(b, hh // 8, 8, ww // 8, 8) - 128.0
    x = torch.einsum("ki,bhiwj->bhkwj", d, x)   # vertical
    x = torch.einsum("bhkwj,lj->bhkwl", x, d)   # horizontal
    c = torch.round(x / qtab[None, None, :, None, :])
    return torch.clamp(c, -COEF_CLAMP, COEF_CLAMP).to(torch.int16).reshape(b, hh, ww)


def box_down2(p: torch.Tensor) -> torch.Tensor:
    """2x2 box mean of (B, H, W) planes, summed in the kernel's order."""
    return ((p[:, 0::2, 0::2] + p[:, 0::2, 1::2])
            + (p[:, 1::2, 0::2] + p[:, 1::2, 1::2])) * 0.25


def encode_420_plain(rgb: torch.Tensor, valid_hw: torch.Tensor,
                     qt: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched 4:2:0 encode front half.

    rgb: (B, 3, H, W) u8, H and W multiples of 16; valid_hw: (B, 2) int32
    valid dims (edges replicate from there); qt: (2, 8, 8) float32 luma
    and chroma tables. Returns int16 (Y (B, H, W), Cb (B, H/2, W/2),
    Cr (B, H/2, W/2))."""
    x = rgb.to(torch.float32)
    r, g, b = (clamp_extent(x[:, c], valid_hw) for c in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    return (fdct_quantize(y, qt[0]), fdct_quantize(box_down2(cb), qt[1]),
            fdct_quantize(box_down2(cr), qt[1]))
