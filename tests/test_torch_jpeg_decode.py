"""Plain PyTorch JPEG coefficient decode (the CPU side of kernel B1) against
the reference: ops/jpeg_decode.batched_decode_ycbcr and the Pallas kernel
pallas_jpeg.decode_420 in interpret mode.

Tolerance: <= 1 LSB inside each image's valid region — the reference's own
kernel-vs-XLA contract (test_pallas_jpeg.py:45). Both sides are float32;
they differ only in IDCT summation order, which can move a value that
sits on a rounding boundary by one. Pixels outside the valid region are
unspecified on both sides and not compared.
"""

import numpy as np
import pytest
import torch

from imageprocessor_tpu.ops import pallas_jpeg as pj
from imageprocessor_tpu.ops.jpeg_decode import batched_decode_ycbcr
from imageprocessor_tpu_torch.ops import jpeg_kernels
from imageprocessor_tpu_torch.ops.jpeg_decode import decode_ycbcr
from tests.test_pallas_jpeg import _case
from tests.test_torch_gpu import b1_shapes

MODES = [(2, 2), (1, 2), (2, 1), (1, 1)]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _max_valid_diff(a, b, dims):
    return max(int(np.abs(a[i, :, :h, :w].astype(int)
                          - b[i, :, :h, :w].astype(int)).max())
               for i, (h, w) in enumerate(dims))


@pytest.mark.parametrize("fh,fw", MODES)
@pytest.mark.parametrize("H,W,dims", [
    (64, 256, [(60, 250), (64, 256), (40, 130)]),
    (384, 512, [(380, 500), (384, 512), (200, 260)]),
    (128, 640, [(120, 633), (128, 640)]),
])
def test_plain_matches_xla_decode(H, W, dims, fh, fw):
    yc, cbc, crc, qt, cv = _case(dims, H, W, fh=fh, fw=fw)
    ref = np.asarray(batched_decode_ycbcr(yc, cbc, crc, qt, cv, fh=fh, fw=fw))
    out = decode_ycbcr(*_torch(yc, cbc, crc, qt, cv), fh=fh, fw=fw).numpy()
    assert out.shape == ref.shape
    assert _max_valid_diff(ref, out, dims) <= 1


@pytest.mark.parametrize("fh,fw", MODES)
def test_plain_matches_pallas_kernel_interpret(fh, fw):
    dims = [(60, 250), (64, 256), (40, 130)]
    yc, cbc, crc, qt, cv = _case(dims, 64, 256, seed=3, fh=fh, fw=fw)
    plan = pj.make_plan(len(dims), 64, 256, fh, fw)
    ref = np.asarray(pj.decode_420(yc, cbc, crc, plan,
                                   pj.make_args(plan, qt, cv), interpret=True))
    out = decode_ycbcr(*_torch(yc, cbc, crc, qt, cv), fh=fh, fw=fw).numpy()
    assert _max_valid_diff(ref, out, dims) <= 1


@pytest.mark.parametrize("fh,fw", MODES)
def test_crop_to_bucket_and_pad_rows(fh, fw):
    """The 200 rung packs into a 208 canvas (coef_canvas); the decode crops
    back to the bucket exactly like the reference's out_h/out_w. Pad rows
    as Group.pack writes them (qt[..., 0, 0] = 1, cv = 1, zero
    coefficients) decode to flat finite pixels without faults."""
    dims = [(200, 200), (190, 196)]
    yc, cbc, crc, qt, cv = _case(dims, 208, 208, seed=5, fh=fh, fw=fw)
    pad = 2
    yc, cbc, crc = (np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                    for a in (yc, cbc, crc))
    qpad = np.zeros((pad, 3, 8, 8), np.float32)
    qpad[:, :, 0, 0] = 1.0
    qt = np.concatenate([qt, qpad])
    cv = np.concatenate([cv, np.ones((pad, 2), np.int32)])
    ref = np.asarray(batched_decode_ycbcr(yc, cbc, crc, qt, cv, fh=fh, fw=fw,
                                          out_h=200, out_w=200))
    out = jpeg_kernels.decode_coefs(*_torch(yc, cbc, crc, qt, cv), fh, fw,
                                    (200, 200)).numpy()
    assert out.shape == (4, 3, 200, 200)
    assert _max_valid_diff(ref, out, dims) <= 1
    assert (out[2:] == 128).all()   # zero coefficients: mid-grey


def _pallas_canvas(a, mh, mw):
    """a (B, h, w) zero-padded to the smallest canvas make_plan takes (h a
    multiple of 16, w of 128 and >= 256), scaled by the plane's
    subsampling (mh, mw). Padding lies past every valid extent, so valid
    pixels do not change."""
    _, h, w = a.shape
    hp = -(-h * mh // 16) * 16 // mh
    wp = max(256, -(-w * mw // 128) * 128) // mw
    return np.pad(a, ((0, 0), (0, hp - h), (0, wp - w)))


@pytest.mark.parametrize("fh,fw", MODES)
@pytest.mark.parametrize("shape", sorted(b1_shapes(2, 2)))
def test_plain_matches_reference_at_tiling_edges(shape, fh, fw):
    """The shapes that B1's kernel meets at the edges of its tiling and
    store widths (tests/test_torch_gpu.py holds the kernel to the plain
    version at the same ones): the plain decode against the XLA decode
    and the interpret-mode Pallas kernel, <= 1 LSB."""
    h, w, dims, (oh, ow) = b1_shapes(fh, fw)[shape]
    yc, cbc, crc, qt, cv = _case(dims, h, w, seed=7, fh=fh, fw=fw)
    out = jpeg_kernels.decode_coefs(*_torch(yc, cbc, crc, qt, cv), fh, fw,
                                    (oh, ow)).numpy()
    assert out.shape == (len(dims), 3, oh, ow)
    xla = np.asarray(batched_decode_ycbcr(yc, cbc, crc, qt, cv, fh=fh, fw=fw,
                                          out_h=oh, out_w=ow))
    assert _max_valid_diff(xla, out, dims) <= 1
    py, pb, pr = (_pallas_canvas(a, m, n) for a, m, n in
                  ((yc, 1, 1), (cbc, fh, fw), (crc, fh, fw)))
    plan = pj.make_plan(len(dims), *py.shape[1:], fh, fw)
    ref = np.asarray(pj.decode_420(py, pb, pr, plan, pj.make_args(plan, qt, cv),
                                   interpret=True))
    assert _max_valid_diff(ref, out, dims) <= 1


@pytest.mark.parametrize("offset", [0, 1, 3, 8])
def test_aligned_operands(offset):
    """B1's 16-byte loads need a 16-byte aligned base: a view that lacks
    one is copied, an aligned contiguous tensor passes through as it is."""
    base = torch.arange(64, dtype=torch.int16)
    view = base[offset:offset + 32]
    got = jpeg_kernels._aligned(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, view)
    if view.data_ptr() % 16 == 0:
        assert got.data_ptr() == view.data_ptr()


def test_wrapper_on_cpu_counts_no_launch():
    dims = [(60, 250)]
    args = _torch(*_case(dims, 64, 256))
    before = jpeg_kernels.launches
    out = jpeg_kernels.decode_coefs(*args, 2, 2, (64, 256))
    assert jpeg_kernels.launches == before   # the plain version ran
    ref = decode_ycbcr(*args, fh=2, fw=2)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("bad", ["dtype", "chroma_shape", "qt", "cv", "out",
                                 "factor", "canvas"])
def test_wrapper_rejects_bad_operands(bad):
    yc, cbc, crc, qt, cv = _torch(*_case([(60, 250)], 64, 256))
    fh, fw, out_hw = 2, 2, (64, 256)
    if bad == "dtype":
        yc = yc.to(torch.int32)
    elif bad == "chroma_shape":
        cbc = cbc[:, :16]
    elif bad == "qt":
        qt = qt.to(torch.float64)
    elif bad == "cv":
        cv = cv[:, :1]
    elif bad == "out":
        out_hw = (65, 256)
    elif bad == "factor":
        fh = 3
    else:
        yc, cbc, crc = yc[:, :56], cbc[:, :28], crc[:, :28]
    with pytest.raises(ValueError):
        jpeg_kernels.decode_coefs(yc, cbc, crc, qt, cv, fh, fw, out_hw)
