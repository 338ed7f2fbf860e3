"""Plain kernel B3 (ops/jpeg_encode.encode_420_plain, what the wrapper
jpeg_kernels.encode_420 runs on the CPU) against the reference's encode
front half on the seeded cases of tests/test_pallas_jpeg.py.

Contracts, coefficient by coefficient inside each image's ceil16(valid)
grid (blocks past it are never emitted):

* vs the reference's default ``batched_encode_420`` and its Pallas kernel
  (interpret mode): <= 1 quantization step everywhere. The reference
  rounds its FDCT basis to bf16 (a TPU matmul mode, ENCODE_TRANSFORM_MODE
  "bf16x2"); the port keeps the exact float32 basis, so a coefficient
  near a rounding boundary may land one step away;
* vs an exact float64 oracle (the math of runtime/splice.py's
  ``_fdct_quantize_rect`` after float64 colour conversion, edge
  replication and box mean): <= 1 step on at most 2 + gh*gw/10000
  coefficients — the bound tests/test_pallas_jpeg.py holds the Pallas
  kernel to.
"""

import numpy as np
import pytest
import torch

from imageprocessor_tpu.ops import jpeg_encode as ref_enc
from imageprocessor_tpu.ops import pallas_jpeg as pj
from imageprocessor_tpu.runtime.splice import _fdct_quantize_rect
from imageprocessor_tpu_torch.ops import jpeg_encode as port_enc
from imageprocessor_tpu_torch.ops import jpeg_kernels

CASES = [
    (64, 256, [(60, 250), (64, 256), (40, 130)]),
    (64, 384, [(60, 380), (64, 384), (40, 200)]),
    (384, 512, [(380, 500), (384, 512), (200, 260)]),
]


def _case(h, w, dims, seed=4):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (len(dims), 3, h, w), dtype=np.uint8)
    return rgb, np.array(dims, np.int32), port_enc.quality_qtables(85).astype(np.float32)


def _port(rgb, vh, qt):
    return [x.numpy() for x in jpeg_kernels.encode_420(
        torch.from_numpy(rgb), torch.from_numpy(vh), torch.from_numpy(qt))]


def _diffs(want, got, dims):
    """Per (plane, image): |want - got| over the image's ceil16 grid."""
    for a, b, div in zip(want, got, (1, 2, 2)):
        for i, (h, w) in enumerate(dims):
            gh, gw = -(-h // 16) * 16 // div, -(-w // 16) * 16 // div
            yield (np.abs(a[i, :gh, :gw].astype(int) - b[i, :gh, :gw].astype(int)),
                   gh * gw)


def _oracle(rgb, dims, qt):
    """Float64 encode front half of each image, edges replicated."""
    out = [[], [], []]
    for img, (h, w) in zip(rgb, dims):
        hh, ww = img.shape[1:]
        x = img.astype(np.float64)[:, np.minimum(np.arange(hh), h - 1)]
        r, g, b = x[:, :, np.minimum(np.arange(ww), w - 1)]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
        cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0

        def down2(p):
            return p.reshape(hh // 2, 2, ww // 2, 2).mean(axis=(1, 3))

        out[0].append(_fdct_quantize_rect(y, qt[0]))
        out[1].append(_fdct_quantize_rect(down2(cb), qt[1]))
        out[2].append(_fdct_quantize_rect(down2(cr), qt[1]))
    return [np.stack(o) for o in out]


def test_tables_equal_reference():
    for q in (1, 10, 50, 75, 85, 95, 100):
        np.testing.assert_array_equal(port_enc.quality_qtables(q),
                                      ref_enc.quality_qtables(q))
    np.testing.assert_array_equal(port_enc._BASE_QT_LUMA, ref_enc._BASE_QT_LUMA)
    np.testing.assert_array_equal(port_enc._BASE_QT_CHROMA, ref_enc._BASE_QT_CHROMA)


@pytest.mark.parametrize("h,w,dims", CASES)
def test_plain_b3_within_one_step_of_reference(h, w, dims):
    rgb, vh, qt = _case(h, w, dims)
    got = _port(rgb, vh, qt)
    assert [g.shape for g in got] == [(len(dims), h, w), (len(dims), h // 2, w // 2),
                                     (len(dims), h // 2, w // 2)]
    assert all(g.dtype == np.int16 for g in got)
    xla = [np.asarray(x) for x in ref_enc.batched_encode_420(rgb, vh, qt)]
    for d, _ in _diffs(xla, got, dims):
        assert d.max() <= 1
    if h == 64 and w == 256:   # the interpret-mode kernel is slow; one case
        plan = pj.make_encode_plan(len(dims), h, w)
        args = pj.make_encode_args(plan, qt, vh)
        pallas = [np.asarray(x) for x in pj.encode_420(rgb, plan, args,
                                                       interpret=True)]
        for d, _ in _diffs(pallas, got, dims):
            assert d.max() <= 1


@pytest.mark.parametrize("h,w,dims", CASES + [(208, 208, [(200, 200), (190, 196)])])
def test_plain_b3_matches_exact_oracle(h, w, dims):
    rgb, vh, qt = _case(h, w, dims, seed=h + w)
    got = _port(rgb, vh, qt)
    for d, n in _diffs(_oracle(rgb, dims, qt), got, dims):
        assert d.max() <= 1
        assert (d > 0).sum() <= 2 + n // 10000


def test_emitted_stream_decodes_like_the_pixels():
    """B3's plain output through the port's entropy emitter is a JPEG that
    decodes close to its source (q85 of a smooth image)."""
    from imageprocessor_tpu.runtime.codecs import decode_image
    from imageprocessor_tpu_torch.runtime import hostcodec
    from tests.oracle import psnr

    h, w = 90, 140
    yy = np.linspace(0, 200, h)[:, None]
    xx = np.linspace(0, 50, w)[None, :]
    img = np.stack(np.broadcast_arrays(yy + xx, 255 - yy, xx * 3)).clip(0, 255).astype(np.uint8)
    canvas = np.zeros((1, 3, 96, 144), np.uint8)
    canvas[0, :, :h, :w] = img
    qt = port_enc.quality_qtables(85)
    yc, cb, cr = _port(canvas, np.array([[h, w]], np.int32), qt.astype(np.float32))
    data = hostcodec.emit_jpeg_from_coefficients([yc[0], cb[0], cr[0]], qt, w, h)
    out, fmt = decode_image(data)
    assert fmt == "jpeg" and out.shape == (h, w, 3)
    assert psnr(out, img.transpose(1, 2, 0)) > 35.0


def test_wrapper_refuses_bad_operands():
    rgb = torch.zeros((1, 3, 16, 24), dtype=torch.uint8)
    vh = torch.ones((1, 2), dtype=torch.int32)
    qt = torch.ones((2, 8, 8))
    with pytest.raises(ValueError, match="16x16"):
        jpeg_kernels.encode_420(rgb, vh, qt)
    with pytest.raises(ValueError, match="device"):
        jpeg_kernels.encode_420(torch.zeros((1, 3, 16, 16), dtype=torch.uint8,
                                            device="meta"), vh, qt)
