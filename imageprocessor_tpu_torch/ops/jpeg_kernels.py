"""Wrapper of kernel B1 (csrc/jpeg_decode.cu) — the counterpart of
imageprocessor_tpu/ops/pallas_jpeg.py's ``decode_420`` entry point.

``decode_coefs`` validates its operands, then takes the plain PyTorch
version (ops/jpeg_decode.py) for tensors on the CPU and launches the CUDA
kernel for tensors on a card. There is no fallback from the kernel: a
CUDA tensor launches it or raises.
"""

from __future__ import annotations

import torch

from imageprocessor_tpu_torch import kernels
from imageprocessor_tpu_torch.ops.jpeg_decode import decode_ycbcr

# Launches of kernel B1 in this process (reset by callers that count a run).
launches = 0


def _check(yc, cbc, crc, qt, cv, fh: int, fw: int,
           out_hw: tuple[int, int]) -> None:
    if fh not in (1, 2) or fw not in (1, 2):
        raise ValueError(f"subsampling factors {fh}x{fw} not supported")
    if yc.dim() != 3 or yc.dtype != torch.int16:
        raise ValueError("yc must be (B, H, W) int16")
    b, ch, cw = yc.shape
    if ch % (8 * fh) or cw % (8 * fw):
        raise ValueError(f"canvas {ch}x{cw} is not MCU-aligned for {fh}x{fw}")
    for name, t in (("cbc", cbc), ("crc", crc)):
        if t.dtype != torch.int16 or tuple(t.shape) != (b, ch // fh, cw // fw):
            raise ValueError(f"{name} must be (B, H/fh, W/fw) int16")
    if qt.dtype != torch.float32 or tuple(qt.shape) != (b, 3, 8, 8):
        raise ValueError("qt must be (B, 3, 8, 8) float32")
    if cv.dtype != torch.int32 or tuple(cv.shape) != (b, 2):
        raise ValueError("cv must be (B, 2) int32")
    if not 0 < out_hw[0] <= ch or not 0 < out_hw[1] <= cw:
        raise ValueError(f"output {out_hw} must lie inside the canvas")
    if any(t.device != yc.device for t in (cbc, crc, qt, cv)):
        raise ValueError("all operands must share a device")


def decode_coefs(yc: torch.Tensor, cbc: torch.Tensor, crc: torch.Tensor,
                 qt: torch.Tensor, cv: torch.Tensor, fh: int, fw: int,
                 out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, H, W) + 2 x (B, H/fh, W/fw) int16 coefficient canvases, (B, 3,
    8, 8) float32 tables and (B, 2) int32 valid chroma extents ->
    (B, 3, out_h, out_w) uint8 planar RGB (the canvas cropped to the
    bucket)."""
    global launches
    _check(yc, cbc, crc, qt, cv, fh, fw, out_hw)
    if yc.device.type == "cpu":
        return decode_ycbcr(yc, cbc, crc, qt, cv, fh=fh, fw=fw,
                            out_h=out_hw[0], out_w=out_hw[1])
    if yc.device.type != "cuda":
        raise ValueError(f"unsupported device {yc.device}")
    yc, cbc, crc, qt, cv = (t.contiguous() for t in (yc, cbc, crc, qt, cv))
    b, ch, cw = yc.shape
    out = torch.empty((b, 3, out_hw[0], out_hw[1]), dtype=torch.uint8,
                      device=yc.device)
    rc = kernels.library().ip_decode_coefs(
        yc.data_ptr(), cbc.data_ptr(), crc.data_ptr(), qt.data_ptr(),
        cv.data_ptr(), out.data_ptr(), b, ch, cw, fh, fw, out_hw[0],
        out_hw[1], kernels.stream_ptr(yc.device))
    kernels.check(rc, "ip_decode_coefs")
    launches += 1
    return out
