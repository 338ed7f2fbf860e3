"""Plain kernel B4 (ops/planar_resample.planar_resample on CPU tensors)
against the reference's Pallas planar resample in interpret mode with
compute_dtype="float32", and against the float64 Go oracle.

Contracts over each image's valid output: <= 1 LSB against the Pallas
kernel (both float32; the kernel's one-hot matmuls sum in another order,
so a value on a floor boundary may move by one) and, against
tests/oracle.py, <= 1 LSB with PSNR > 45 dB (the repo's resample
contract).
"""

import numpy as np
import pytest
import torch

from imageprocessor_tpu.ops.pallas_resample import make_args, make_plan
from imageprocessor_tpu.ops.pallas_resample import planar_resample as ref_resample
from imageprocessor_tpu_torch.ops import planar_resample as pr
from imageprocessor_tpu_torch.ops.fused_resample import center_crop_windows, make_taps
from tests.oracle import psnr, resize_go, thumbnail_go

RNG = np.random.default_rng(31)

# (sources (h, w), bucket, output (h, w), thumbnail crop)
CASES = [
    ([(200, 256), (180, 240)], (200, 256), (96, 128), False),    # downscale
    ([(64, 100)], (64, 128), (128, 256), False),                 # upscale
    ([(192, 256), (256, 192)], (256, 256), (64, 64), True),      # crop thumbnail
    ([(300, 40), (37, 301)], (384, 384), (150, 150), False),     # odd, mixed
]


def _run(shapes, bucket, out_hw, crop):
    b = len(shapes)
    imgs = np.zeros((b, 3, *bucket), np.uint8)
    src_hw = np.array(shapes, np.int64)
    originals = []
    for i, (h, w) in enumerate(shapes):
        img = RNG.integers(0, 256, (3, h, w), dtype=np.uint8)
        imgs[i, :, :h, :w] = img
        originals.append(img.transpose(1, 2, 0))
    out = np.tile(np.array([out_hw], np.int64), (b, 1))
    crop_yx, crop_hw = center_crop_windows(src_hw) if crop else (None, None)
    eff = crop_hw if crop else src_hw
    plan = make_plan(b, 3, *bucket, *out_hw,
                     max(float(np.max(eff[:, 0] / out[:, 0])), 1.0),
                     max(float(np.max(eff[:, 1] / out[:, 1])), 1.0),
                     compute_dtype="float32")
    args = make_args(plan, src_hw, out, crop_yx=crop_yx, crop_hw=crop_hw)
    want = np.asarray(ref_resample(imgs, plan, args, interpret=True))
    n = pr.launches
    got = pr.planar_resample(torch.from_numpy(imgs), make_taps(
        src_hw, out, out_hw, bucket, crop_yx, crop_hw)).numpy()
    assert pr.launches == n   # CPU tensors never launch the kernel
    return originals, want[:, :, :out_hw[0], :out_hw[1]], got


@pytest.mark.parametrize("shapes,bucket,out_hw,crop", CASES)
def test_plain_b4_matches_pallas_and_oracle(shapes, bucket, out_hw, crop):
    originals, want, got = _run(shapes, bucket, out_hw, crop)
    assert got.shape == (len(shapes), 3, *out_hw) and got.dtype == np.uint8
    assert np.abs(want.astype(int) - got.astype(int)).max() <= 1
    for img, g in zip(originals, got):
        ref = (thumbnail_go(img, out_hw[0], crop_to_fit=True) if crop
               else resize_go(img, out_hw[1], out_hw[0]))
        g = g.transpose(1, 2, 0)
        assert np.abs(ref.astype(int) - g.astype(int)).max() <= 1
        assert psnr(g, ref) > 45.0


def test_wrapper_refuses_other_devices():
    taps = make_taps(np.array([[16, 16]]), np.array([[4, 4]]), (4, 4), (16, 16))
    src = torch.zeros((1, 3, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="device"):
        pr.planar_resample(src.to("meta"), taps.to("meta"))
    with pytest.raises(ValueError, match="device"):
        pr.planar_resample(src, taps.to("meta"))
