"""Wrappers of kernels B1 (csrc/jpeg_decode.cu) and B3
(csrc/jpeg_encode.cu) — the counterparts of
imageprocessor_tpu/ops/pallas_jpeg.py's ``decode_420`` and ``encode_420``
entry points.

Each wrapper validates its operands, then takes the plain PyTorch version
(ops/jpeg_decode.py, ops/jpeg_encode.py) for tensors on the CPU and
launches the CUDA kernel on the card the tensors lie on. There is no
fallback from a kernel: a CUDA tensor launches it or raises.
"""

from __future__ import annotations

import torch

from imageprocessor_tpu_torch import kernels
from imageprocessor_tpu_torch.ops.jpeg_decode import decode_ycbcr
from imageprocessor_tpu_torch.ops.jpeg_encode import encode_420_plain

# Launches of kernels B1 and B3 in this process, every card's (reset by
# callers that count a run; kernels.count_lock guards them).
launches = 0
encode_launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned base (the kernels' 16-byte
    loads need both): a view that is not is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _aligned_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """rgb as B3 reads it in place: columns contiguous, and the base and
    the image, channel and row strides multiples of 8 bytes (its 8-byte
    loads need all of them). A view that is not — a bucket whose width is
    not a multiple of 8 gives such a row stride — is copied."""
    if (rgb.stride(3) == 1 and rgb.data_ptr() % 8 == 0
            and all(rgb.stride(d) % 8 == 0 for d in range(3))):
        return rgb
    return rgb.clone(memory_format=torch.contiguous_format)


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
    yc, cbc, crc, qt = (_aligned(t) for t in (yc, cbc, crc, qt))
    cv = cv.contiguous()
    b, ch, cw = yc.shape
    out = torch.empty((b, 3, out_hw[0], out_hw[1]), dtype=torch.uint8,
                      device=yc.device)
    kernels.launch("ip_decode_coefs", yc.device, yc.data_ptr(),
                   cbc.data_ptr(), crc.data_ptr(), qt.data_ptr(),
                   cv.data_ptr(), out.data_ptr(), b, ch, cw, fh, fw,
                   out_hw[0], out_hw[1])
    with kernels.count_lock:
        launches += 1
    return out


def _check_encode(rgb, valid_hw, qt) -> None:
    if rgb.dtype != torch.uint8 or rgb.dim() != 4 or rgb.shape[1] != 3:
        raise ValueError(f"rgb must be (B, 3, H, W) uint8, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")
    b, _, h, w = rgb.shape
    if h % 16 or w % 16 or h == 0 or w == 0:
        raise ValueError(f"canvas {h}x{w} is not a whole number of 16x16 MCUs")
    if valid_hw.dtype != torch.int32 or tuple(valid_hw.shape) != (b, 2):
        raise ValueError("valid_hw must be (B, 2) int32")
    if qt.dtype != torch.float32 or tuple(qt.shape) != (2, 8, 8):
        raise ValueError("qt must be (2, 8, 8) float32")
    if any(t.device != rgb.device for t in (valid_hw, qt)):
        raise ValueError("all operands must share a device")


def encode_420(rgb: torch.Tensor, valid_hw: torch.Tensor, qt: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, 3, H, W) u8 planar RGB (H, W multiples of 16; a view whose
    columns are contiguous and whose base and strides are multiples of 8
    is read in place, any other is copied), (B, 2) int32 valid dims and
    (2, 8, 8) float32 luma/chroma tables -> int16 4:2:0 coefficient
    canvases Y (B, H, W), Cb and Cr (B, H/2, W/2). Blocks past ceil16 of
    an image's valid extent are unspecified."""
    global encode_launches
    _check_encode(rgb, valid_hw, qt)
    if rgb.device.type == "cpu":
        return encode_420_plain(rgb, valid_hw, qt)
    if rgb.device.type != "cuda":
        raise ValueError(f"unsupported device {rgb.device}")
    rgb = _aligned_rgb(rgb)
    valid_hw, qt = valid_hw.contiguous(), _aligned(qt)
    b, _, h, w = rgb.shape
    yc = torch.empty((b, h, w), dtype=torch.int16, device=rgb.device)
    cbc = torch.empty((b, h // 2, w // 2), dtype=torch.int16, device=rgb.device)
    crc = torch.empty_like(cbc)
    kernels.launch("ip_encode_420", rgb.device, rgb.data_ptr(),
                   rgb.stride(0), rgb.stride(1), rgb.stride(2),
                   valid_hw.data_ptr(), qt.data_ptr(), yc.data_ptr(),
                   cbc.data_ptr(), crc.data_ptr(), b, h, w)
    with kernels.count_lock:
        encode_launches += 1
    return yc, cbc, crc
