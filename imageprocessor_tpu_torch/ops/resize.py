"""Single-image bilinear resize — counterpart of
imageprocessor_tpu/ops/resize.py's ``resize_image``.

Go's ``xdraw.BiLinear.Scale`` semantics (half-pixel source mapping, edge
clamping, 16-bit quantization), served as a one-image call of the
batched machinery: ``make_taps`` builds the tap tables and
``planar_resample`` runs them — kernel B4 for a tensor on a card, its
plain version on the CPU. The reference's XLA gather resamplers
(``batched_resize_bilinear``) have no counterpart: B2 and B4 take any
scale.
"""

from __future__ import annotations

import numpy as np
import torch

from imageprocessor_tpu_torch.ops.coords import keep_aspect_dims
from imageprocessor_tpu_torch.ops.fused_resample import make_taps
from imageprocessor_tpu_torch.ops.planar_resample import planar_resample


def resample_hwc(img: torch.Tensor, out_h: int, out_w: int,
                 crop_yx: tuple[int, int] | None = None,
                 crop_hw: tuple[int, int] | None = None) -> torch.Tensor:
    """(h, w, 3) u8 -> (out_h, out_w, 3) u8 through ``planar_resample``,
    optionally from a source window (crop_yx, crop_hw)."""
    h, w = int(img.shape[0]), int(img.shape[1])
    window = (None, None) if crop_yx is None else (np.array([crop_yx]),
                                                   np.array([crop_hw]))
    taps = make_taps(np.array([[h, w]]), np.array([[out_h, out_w]]),
                     (out_h, out_w), (h, w), *window).to(img.device)
    planar = img.permute(2, 0, 1)[None].contiguous()
    return planar_resample(planar, taps)[0].permute(1, 2, 0).contiguous()


def resize_image(img: torch.Tensor, width: int, height: int,
                 keep_aspect: bool = False) -> torch.Tensor:
    """``Resizer.Process`` (operations/resize.go:26-91) on one (h, w, 3)
    u8 image. ``width`` and ``height`` must be positive (the plan checks
    them). With keep_aspect the min-ratio rule picks the target size."""
    if keep_aspect:
        out_w, out_h = keep_aspect_dims(int(img.shape[1]), int(img.shape[0]),
                                        width, height)
        out_w, out_h = max(out_w, 1), max(out_h, 1)
    else:
        out_w, out_h = width, height
    return resample_hwc(img, out_h, out_w)
