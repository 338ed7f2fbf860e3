"""Fused two-output resample: host tap tables, the plain PyTorch version
and the wrapper of kernel B2 (csrc/fused_resample.cu).

Counterpart of imageprocessor_tpu/ops/pallas_fused.py (and the host half
of its ``make_fused_args``, with ``pallas_resample._axis_coords``'s tap
semantics): one pass over a planar (B, 3, H, W) u8 bucket writes up to
two outputs, each a Go half-pixel bilinear resample with per-image dims —
the keep-aspect resize and the thumbnail (centre-square crop folded into
the tap offsets, or aspect mode). Vertical lerp first, then horizontal, in
float32, then xdraw's floor(v * 257/256) clipped to u8.

The TPU kernel's tiling (bands, owned rows, DMA depth, garbage zones,
8/128 alignment, one-hot matmuls) has no counterpart: taps are gathered
directly, at any scale.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from imageprocessor_tpu_torch import kernels
from imageprocessor_tpu_torch.ops.coords import center_crop_rect, quantize_go_xdraw

# Launches of kernel B2 in this process (reset by callers that count a run).
launches = 0


def axis_taps(out_valid: np.ndarray, src_valid: np.ndarray,
              src_offset: np.ndarray, out_len: int, cap: int):
    """Go half-pixel source taps per image along one axis, in float64:
    (B, out_len) i0, i1 (int32) and frac (float32). Indices past
    ``out_valid`` keep extrapolating and are clamped (their outputs are
    cropped away); ``src_offset`` shifts into a crop window; ``cap``
    bounds indices to the bucket."""
    dst = np.arange(out_len, dtype=np.float64)[None, :]
    scale = (src_valid.astype(np.float64)
             / np.maximum(out_valid, 1).astype(np.float64))[:, None]
    src = (dst + 0.5) * scale - 0.5
    hi = np.maximum(src_valid.astype(np.float64) - 1.0, 0.0)[:, None]
    src = np.clip(src, 0.0, hi)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, np.maximum(src_valid[:, None] - 1, 0))
    frac = (src - i0).astype(np.float32)
    i0 = np.clip(i0 + src_offset[:, None], 0, cap - 1)
    i1 = np.clip(i1 + src_offset[:, None], 0, cap - 1)
    return i0.astype(np.int32), i1.astype(np.int32), frac


@dataclass
class Taps:
    """One output's tap tables: rows (B, h) and cols (B, w)."""

    r0: torch.Tensor
    r1: torch.Tensor
    fy: torch.Tensor
    c0: torch.Tensor
    c1: torch.Tensor
    fx: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return int(self.r0.shape[1]), int(self.c0.shape[1])

    def to(self, device) -> "Taps":
        return Taps(*(t.to(device) for t in (self.r0, self.r1, self.fy,
                                             self.c0, self.c1, self.fx)))


def make_taps(src_hw: np.ndarray, out_hw: np.ndarray,
              canvas: tuple[int, int], bucket: tuple[int, int],
              crop_yx: np.ndarray | None = None,
              crop_hw: np.ndarray | None = None) -> Taps:
    """Host tap tables for one output on a ``canvas``-sized grid.

    src_hw: (B, 2) valid source dims; out_hw: (B, 2) valid output dims;
    crop_yx/crop_hw: optional per-image source window (the thumbnail's
    centre square). Built in float64 like the reference's host args."""
    b = src_hw.shape[0]
    eff = np.asarray(crop_hw if crop_hw is not None else src_hw, np.int64)
    off = (np.asarray(crop_yx, np.int64) if crop_yx is not None
           else np.zeros((b, 2), np.int64))
    out_hw = np.asarray(out_hw, np.int64)
    r0, r1, fy = axis_taps(out_hw[:, 0], eff[:, 0], off[:, 0], canvas[0],
                           bucket[0])
    c0, c1, fx = axis_taps(out_hw[:, 1], eff[:, 1], off[:, 1], canvas[1],
                           bucket[1])
    return Taps(*(torch.from_numpy(np.ascontiguousarray(a))
                  for a in (r0, r1, fy, c0, c1, fx)))


def center_crop_windows(src_hw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-image centre-square crop (coords.center_crop_rect): (crop_yx,
    crop_hw), each (B, 2)."""
    rects = [center_crop_rect(int(w), int(h)) for h, w in src_hw]
    crop_yx = np.array([(y, x) for x, y, _ in rects], np.int64).reshape(-1, 2)
    crop_hw = np.array([(s, s) for _, _, s in rects], np.int64).reshape(-1, 2)
    return crop_yx, crop_hw


def resample_plain(src: torch.Tensor, taps: Taps) -> torch.Tensor:
    """Plain PyTorch version of one kernel output: (B, 3, H, W) u8 ->
    (B, 3, h, w) u8, with the kernel's operation order."""
    outs = []
    for i in range(src.shape[0]):
        img = src[i]
        fy = taps.fy[i][None, :, None]
        fx = taps.fx[i][None, None, :]
        v = ((1.0 - fy) * img[:, taps.r0[i].long(), :].to(torch.float32)
             + fy * img[:, taps.r1[i].long(), :].to(torch.float32))
        h = ((1.0 - fx) * v[:, :, taps.c0[i].long()]
             + fx * v[:, :, taps.c1[i].long()])
        outs.append(h)
    return quantize_go_xdraw(torch.stack(outs))


def check_operands(src: torch.Tensor, taps: Taps | None) -> None:
    """Raise ValueError unless ``src`` is (B, 3, H, W) u8 and ``taps`` (if
    given) are contiguous int32/float32 (B, n) tables on its device."""
    if src.dtype != torch.uint8 or src.dim() != 4 or src.shape[1] != 3:
        raise ValueError(f"expected (B, 3, H, W) uint8, got {tuple(src.shape)} "
                         f"{src.dtype}")
    if taps is None:
        return
    b = src.shape[0]
    for t, dt in ((taps.r0, torch.int32), (taps.r1, torch.int32),
                  (taps.fy, torch.float32), (taps.c0, torch.int32),
                  (taps.c1, torch.int32), (taps.fx, torch.float32)):
        if (t.dtype != dt or t.dim() != 2 or t.shape[0] != b
                or not t.is_contiguous()):
            raise ValueError("tap tables must be contiguous (B, n) "
                             "int32/float32")
        if t.device != src.device:
            raise ValueError("tap tables and source must share a device")
    h, w = taps.shape
    if taps.r1.shape[1] != h or taps.fy.shape[1] != h or \
            taps.c1.shape[1] != w or taps.fx.shape[1] != w:
        raise ValueError("tap table lengths disagree")


def fused_resample(src: torch.Tensor, taps_a: Taps | None,
                   taps_b: Taps | None
                   ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Both outputs of one source sweep; either may be absent (None).

    A CPU source takes the plain version; a CUDA source launches kernel
    B2 (or raises)."""
    global launches
    check_operands(src, taps_a)
    check_operands(src, taps_b)
    if src.device.type == "cpu":
        return tuple(None if t is None else resample_plain(src, t)
                     for t in (taps_a, taps_b))
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    src = src.contiguous()
    b, _, sh, sw = src.shape
    args, outs = [], []
    for t in (taps_a, taps_b):
        if t is None:
            args += [None] * 7 + [0, 0]
            outs.append(None)
            continue
        h, w = t.shape
        dst = torch.empty((b, 3, h, w), dtype=torch.uint8, device=src.device)
        args += [x.data_ptr() for x in (t.r0, t.r1, t.fy, t.c0, t.c1, t.fx)]
        args += [dst.data_ptr(), h, w]
        outs.append(dst)
    rc = kernels.library().ip_fused_resample(
        src.data_ptr(), b, sh, sw, *args, kernels.stream_ptr(src.device))
    kernels.check(rc, "ip_fused_resample")
    launches += 1
    return outs[0], outs[1]
