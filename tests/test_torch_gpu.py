"""Kernels B1-B4 on the card against their plain PyTorch versions.

These need a CUDA card and nvcc (the kernels have no CPU mode); without a
card they skip. B1 runs every subsampling at the edges of its tiling and
of its two store widths (``b1_shapes``). Run them on a GPU host with:

    python -m pytest tests/test_torch_gpu.py -m gpu

Limits: B1 <= 1 LSB inside each valid region (IDCT summation order); B2
and B4 exactly equal (same float32 operations in the same order); B3
<= 1 quantization step inside each image's ceil16(valid) grid (FDCT
summation order).
"""

import numpy as np
import pytest
import torch

from imageprocessor_tpu_torch.ops import fused_resample as fr
from imageprocessor_tpu_torch.ops import jpeg_kernels
from imageprocessor_tpu_torch.ops import planar_resample as pr
from imageprocessor_tpu_torch.ops.jpeg_decode import decode_ycbcr
from imageprocessor_tpu_torch.ops.jpeg_encode import encode_420_plain, quality_qtables

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _coefs(dims, h, w, fh, fw, seed, device):
    rng = np.random.default_rng(seed)
    b = len(dims)
    yc = rng.integers(-512, 512, (b, h, w)).astype(np.int16)
    cbc = rng.integers(-256, 256, (b, h // fh, w // fw)).astype(np.int16)
    crc = rng.integers(-256, 256, (b, h // fh, w // fw)).astype(np.int16)
    qt = (np.abs(rng.normal(6, 2, (b, 3, 8, 8))) + 1).astype(np.float32)
    cv = np.array([[-(-vh // (8 * fh)) * 8, -(-vw // (8 * fw)) * 8]
                   for vh, vw in dims], np.int32)
    return [torch.from_numpy(a).to(device) for a in (yc, cbc, crc, qt, cv)]


def b1_shapes(fh: int, fw: int) -> dict:
    """(canvas h, w, valid dims, out_hw) at the edges of B1's tiling, for
    an MCU of 8 fh x 8 fw: the 200 rung on a 208 canvas; one MCU row at
    batch 1; one MCU column; a canvas wider than one 256-wide tile and not
    a multiple of it (16 x 528, whole 16 x 16 MCUs); an out_w that is not
    a multiple of 8 (bytewise stores) with out_h < ch."""
    mh, mw = 8 * fh, 8 * fw
    return {
        "w200": (208, 208, [(200, 200), (190, 196)], (200, 200)),
        "mcu_row_b1": (mh, 256, [(mh - 1, 250)], (mh, 256)),
        "mcu_col": (64, mw, [(61, mw - 1), (64, mw)], (64, mw)),
        "w528": (16, 528, [(16, 528), (13, 517)], (16, 528)),
        "out_w_odd": (64, 528, [(61, 523), (50, 200)], (61, 523)),
    }


@pytest.mark.parametrize("shape", sorted(b1_shapes(2, 2)))
@pytest.mark.parametrize("fh,fw", [(2, 2), (1, 2), (2, 1), (1, 1)])
def test_b1_matches_plain(cuda, fh, fw, shape):
    h, w, dims, out_hw = b1_shapes(fh, fw)[shape]
    args = _coefs(dims, h, w, fh, fw, seed=fh * 10 + fw, device=cuda)
    n = jpeg_kernels.launches
    got = jpeg_kernels.decode_coefs(*args, fh, fw, out_hw)
    want = decode_ycbcr(*args, fh=fh, fw=fw, out_h=out_hw[0], out_w=out_hw[1])
    torch.cuda.synchronize()
    assert jpeg_kernels.launches == n + 1
    for i, (vh, vw) in enumerate(dims):
        assert (got[i, :, :vh, :vw].int() - want[i, :, :vh, :vw].int()).abs().max() <= 1


def test_b2_matches_plain(cuda):
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.integers(0, 256, (2, 3, 384, 512),
                                        dtype=np.uint8)).to(cuda)
    src_hw = np.array([[300, 400], [384, 256]])
    cy, chw = fr.center_crop_windows(src_hw)
    thumb = fr.make_taps(src_hw, np.full((2, 2), 200), (200, 200), (384, 512),
                         cy, chw).to(cuda)
    resize = fr.make_taps(src_hw, np.array([[768, 1024], [768, 512]]),
                          (768, 1024), (384, 512)).to(cuda)
    n = fr.launches
    a, b = fr.fused_resample(src, thumb, resize)
    torch.cuda.synchronize()
    assert fr.launches == n + 1
    assert torch.equal(a, fr.resample_plain(src, thumb))
    assert torch.equal(b, fr.resample_plain(src, resize))


def test_b3_matches_plain(cuda):
    rng = np.random.default_rng(3)
    dims = [(200, 200), (190, 196), (1, 1)]
    canvas = torch.from_numpy(rng.integers(0, 256, (3, 3, 224, 256),
                                           dtype=np.uint8)).to(cuda)
    rgb = canvas[:, :, :208, :208]   # a strided view, read in place
    vh = torch.tensor(dims, dtype=torch.int32, device=cuda)
    qt = torch.from_numpy(quality_qtables(85).astype(np.float32)).to(cuda)
    n = jpeg_kernels.encode_launches
    got = jpeg_kernels.encode_420(rgb, vh, qt)
    want = encode_420_plain(rgb, vh, qt)
    torch.cuda.synchronize()
    assert jpeg_kernels.encode_launches == n + 1
    for g, w, div in zip(got, want, (1, 2, 2)):
        for i, (h, wd) in enumerate(dims):
            gh, gw = -(-h // 16) * 16 // div, -(-wd // 16) * 16 // div
            assert (g[i, :gh, :gw].int() - w[i, :gh, :gw].int()).abs().max() <= 1


def test_b4_matches_plain(cuda):
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.integers(0, 256, (2, 3, 384, 512),
                                        dtype=np.uint8)).to(cuda)
    src_hw = np.array([[300, 400], [384, 256]])
    cy, chw = fr.center_crop_windows(src_hw)
    for taps in (fr.make_taps(src_hw, np.full((2, 2), 200), (200, 200), (384, 512),
                              cy, chw),
                 fr.make_taps(src_hw, np.array([[768, 1024], [90, 60]]),
                              (768, 1024), (384, 512))):
        taps = taps.to(cuda)
        n = pr.launches
        got = pr.planar_resample(src, taps)
        torch.cuda.synchronize()
        assert pr.launches == n + 1
        assert torch.equal(got, fr.resample_plain(src, taps))
