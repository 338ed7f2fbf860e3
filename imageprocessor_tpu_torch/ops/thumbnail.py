"""Single-image thumbnail — counterpart of
imageprocessor_tpu/ops/thumbnail.py's ``thumbnail_image``.

``Thumbnailer.Process`` (operations/thumbnail.go:25-132): crop_to_fit
takes the centre square and scales it to size x size (one offset bilinear
pass over the crop window, as the reference); otherwise the shorter side
becomes ``size`` and the longer side follows with int truncation. Both
are one-image calls of ``planar_resample`` (ops/resize.py).
"""

from __future__ import annotations

import torch

from imageprocessor_tpu_torch.ops.coords import center_crop_rect, thumbnail_dims
from imageprocessor_tpu_torch.ops.resize import resample_hwc


def thumbnail_image(img: torch.Tensor, size: int,
                    crop_to_fit: bool = False) -> torch.Tensor:
    """(h, w, 3) u8 -> its thumbnail, (size, size, 3) when cropping."""
    h, w = int(img.shape[0]), int(img.shape[1])
    if crop_to_fit:
        cx, cy, side = center_crop_rect(w, h)
        return resample_hwc(img, size, size, (cy, cx), (side, side))
    out_w, out_h = thumbnail_dims(w, h, size)
    return resample_hwc(img, max(out_h, 1), max(out_w, 1))
