"""Single-output planar resample: the wrapper of kernel B4
(csrc/planar_resample.cu) — the counterpart of
imageprocessor_tpu/ops/pallas_resample.py's ``planar_resample``.

One Go half-pixel bilinear resample of a planar (B, 3, H, W) u8 bucket,
with per-image dims and the thumbnail's centre crop folded into the
source coordinates. The host tap tables are fused_resample's
(``make_taps``, ``center_crop_windows``: the reference's ``make_args``
and ``_axis_coords`` semantics), and so is the plain version
(``resample_plain`` with one ``Taps``). It serves every resize and
thumbnail op that is not the fused pair kernel B2 takes.
"""

from __future__ import annotations

import torch

from imageprocessor_tpu_torch import kernels
from imageprocessor_tpu_torch.ops.fused_resample import Taps, check_operands, resample_plain

# Launches of kernel B4 in this process (reset by callers that count a run).
launches = 0


def planar_resample(src: torch.Tensor, taps: Taps) -> torch.Tensor:
    """(B, 3, H, W) u8 -> (B, 3, h, w) u8 on the ``taps`` grid.

    A CPU source takes the plain version; a CUDA source launches kernel
    B4 (or raises)."""
    global launches
    check_operands(src, taps)
    if src.device.type == "cpu":
        return resample_plain(src, taps)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    src = src.contiguous()
    b, _, sh, sw = src.shape
    h, w = taps.shape
    dst = torch.empty((b, 3, h, w), dtype=torch.uint8, device=src.device)
    rc = kernels.library().ip_planar_resample(
        src.data_ptr(), b, sh, sw,
        *(t.data_ptr() for t in (taps.r0, taps.r1, taps.fy, taps.c0, taps.c1,
                                 taps.fx)),
        dst.data_ptr(), h, w, kernels.stream_ptr(src.device))
    kernels.check(rc, "ip_planar_resample")
    launches += 1
    return dst
