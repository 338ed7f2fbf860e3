"""Plain PyTorch fused resample (the CPU side of kernel B2) against the
reference: the Pallas fused kernel in interpret mode on a float32 plan,
and the float64 Go oracle (tests/oracle.py).

Tolerances: <= 1 LSB, and PSNR > 45 dB against the oracle (the repo's
resample contract). Against the Pallas kernel the port is compared with
its float32 plan, not the bf16 default (ROADMAP: bf16 resample rounding
is no port fault); both run Go's taps in float32 and can differ by one
only where floor(v * 257/256) sits on a boundary. The host tap tables
must equal the reference's exactly (same float64 arithmetic).
"""

import numpy as np
import pytest
import torch

from imageprocessor_tpu.ops.coords import keep_aspect_dims
from imageprocessor_tpu.ops.pallas_fused import (
    fused_resample as pallas_fused_resample,
    make_fused_args,
    make_fused_plan,
)
from imageprocessor_tpu.ops.pallas_resample import _axis_coords
from imageprocessor_tpu_torch.ops import fused_resample as fr
from tests.oracle import psnr, resize_go, thumbnail_go


def _batch(shapes, bucket, seed):
    rng = np.random.default_rng(seed)
    imgs = np.zeros((len(shapes), 3, *bucket), np.uint8)
    src_hw = np.zeros((len(shapes), 2), np.int32)
    originals = []
    for i, (h, w) in enumerate(shapes):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        originals.append(img)
        imgs[i, :, :h, :w] = img.transpose(2, 0, 1)
        src_hw[i] = (h, w)
    return imgs, src_hw, originals


def _resize_hw(src_hw, width, height):
    return np.array([[max(keep_aspect_dims(w, h, width, height)[1], 1),
                      max(keep_aspect_dims(w, h, width, height)[0], 1)]
                     for h, w in src_hw], np.int32)


def _port(imgs, src_hw, r_out_hw, r_canvas, t_size, bucket, aspect_hw=None,
          t_canvas=None):
    taps_r = fr.make_taps(src_hw, r_out_hw, r_canvas, bucket)
    if aspect_hw is None:
        cy, chw = fr.center_crop_windows(src_hw)
        taps_t = fr.make_taps(src_hw, np.full((len(src_hw), 2), t_size),
                              (t_size, t_size), bucket, cy, chw)
    else:
        taps_t = fr.make_taps(src_hw, aspect_hw, t_canvas, bucket)
    rz, th = fr.fused_resample(torch.from_numpy(imgs), taps_r, taps_t)
    return rz.numpy(), th.numpy()


@pytest.mark.parametrize("shapes,bucket", [
    ([(512, 640), (448, 576)], (512, 640)),
    ([(640, 384), (384, 640)], (640, 640)),
    ([(640, 640), (200, 256)], (640, 640)),
])
def test_plain_matches_pallas_fused_float32(shapes, bucket):
    imgs, src_hw, _ = _batch(shapes, bucket, seed=101)
    r_out_hw = _resize_hw(src_hw, 128, 96)
    sc_r = src_hw[:, 0] / r_out_hw[:, 0]
    sc_t = np.minimum(src_hw[:, 0], src_hw[:, 1]) / 64
    plan = make_fused_plan(
        len(shapes), *bucket, 96, 128, 64, float(sc_r.min()), float(sc_r.max()),
        float(sc_t.min()), float(sc_t.max()),
        float((src_hw[:, 1] / r_out_hw[:, 1]).max()), float(sc_t.max()),
        compute_dtype="float32")
    args = make_fused_args(plan, src_hw, r_out_hw)
    assert args.ok
    ref_r, ref_t = (np.asarray(a) for a in
                    pallas_fused_resample(imgs, plan, args, interpret=True))
    rz, th = _port(imgs, src_hw, r_out_hw, (96, 128), 64, bucket)
    for i in range(len(shapes)):
        oh, ow = r_out_hw[i]
        assert np.abs(rz[i, :, :oh, :ow].astype(int)
                      - ref_r[i, :, :oh, :ow].astype(int)).max() <= 1
        assert np.abs(th[i].astype(int) - ref_t[i, :, :64, :64].astype(int)).max() <= 1


@pytest.mark.parametrize("shapes,bucket,req,t_size", [
    ([(512, 640), (448, 576)], (512, 640), (96, 128), 64),     # downscale
    ([(300, 400), (250, 330)], (384, 512), (768, 1024), 200),  # upscale
    ([(130, 90)], (200, 128), (768, 1024), 200),               # portrait up
])
def test_plain_matches_oracle(shapes, bucket, req, t_size):
    imgs, src_hw, originals = _batch(shapes, bucket, seed=7)
    r_out_hw = _resize_hw(src_hw, req[1], req[0])
    rz, th = _port(imgs, src_hw, r_out_hw, req, t_size, bucket)
    for i, img in enumerate(originals):
        oh, ow = r_out_hw[i]
        got = rz[i, :, :oh, :ow].transpose(1, 2, 0)
        ref = resize_go(img, req[1], req[0], keep_aspect=True)
        assert got.shape == ref.shape
        assert psnr(got, ref) > 45.0
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        got = th[i].transpose(1, 2, 0)
        ref = thumbnail_go(img, t_size, crop_to_fit=True)
        assert psnr(got, ref) > 45.0
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_aspect_thumbnail_matches_oracle():
    shapes, bucket = [(300, 400), (400, 300)], (512, 512)
    imgs, src_hw, originals = _batch(shapes, bucket, seed=9)
    aspect = np.array([[64, 85], [85, 64]], np.int32)   # thumbnail_dims(.., 64)
    r_out_hw = _resize_hw(src_hw, 128, 96)
    _, th = _port(imgs, src_hw, r_out_hw, (96, 128), 64, bucket,
                  aspect_hw=aspect, t_canvas=(128, 128))
    for i, img in enumerate(originals):
        h, w = aspect[i]
        ref = thumbnail_go(img, 64, crop_to_fit=False)
        got = th[i, :, :h, :w].transpose(1, 2, 0)
        assert got.shape == ref.shape
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_tap_tables_equal_reference():
    src_hw = np.array([[3000, 4000], [480, 640], [1, 1]], np.int64)
    out_hw = np.array([[768, 1024], [768, 1024], [1, 1]], np.int64)
    off = np.array([0, 7, 0], np.int64)
    for axis in (0, 1):
        a = _axis_coords(out_hw[:, axis], src_hw[:, axis], off, 1100, 4096)
        b = fr.axis_taps(out_hw[:, axis], src_hw[:, axis], off, 1100, 4096)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


def test_single_output_and_no_launch_on_cpu():
    imgs, src_hw, _ = _batch([(100, 120)], (128, 128), seed=3)
    taps = fr.make_taps(src_hw, np.array([[50, 60]]), (64, 64), (128, 128))
    before = fr.launches
    a, b = fr.fused_resample(torch.from_numpy(imgs), taps, None)
    assert b is None and a.shape == (1, 3, 64, 64)
    none_a, b2 = fr.fused_resample(torch.from_numpy(imgs), None, taps)
    assert none_a is None and torch.equal(a, b2)
    assert fr.launches == before


def test_wrapper_rejects_bad_operands():
    imgs, src_hw, _ = _batch([(100, 120)], (128, 128), seed=3)
    taps = fr.make_taps(src_hw, np.array([[50, 60]]), (64, 64), (128, 128))
    with pytest.raises(ValueError):
        fr.fused_resample(torch.from_numpy(imgs).float(), taps, None)
    taps.fy = taps.fy.double()
    with pytest.raises(ValueError):
        fr.fused_resample(torch.from_numpy(imgs), taps, None)
