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
* vs an exact float64 oracle (tests/test_torch_gpu.py ``encode_oracle``,
  shared with the card's tests: the math of runtime/splice.py's
  ``_fdct_quantize_rect`` after float64 colour conversion, edge
  replication and box mean): <= 1 step on at most 2 + gh*gw/10000
  coefficients — the bound tests/test_pallas_jpeg.py holds the Pallas
  kernel to.

The same two contracts are held at the edge shapes of kernel B3's tiling
(``b3_shapes``; tests/test_torch_gpu.py holds the kernel to the plain
version, the reference and the oracle at the same ones on a card).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from imageprocessor_tpu.ops import jpeg_encode as ref_enc
from imageprocessor_tpu.ops import pallas_jpeg as pj
from imageprocessor_tpu_torch.ops import jpeg_encode as port_enc
from imageprocessor_tpu_torch.ops import jpeg_kernels
from imageprocessor_tpu_torch.ops.jpeg_decode import idct_basis
from tests.test_torch_gpu import b3_case, b3_shapes
from tests.test_torch_gpu import coef_diffs as _diffs
from tests.test_torch_gpu import encode_oracle as _oracle

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


def _shape_case(shape, seed):
    """A b3_shapes entry: the canvas (a view of its bucket), valid dims,
    q85 tables, and the valid dims as a list."""
    bucket, (h, w), vh, qt, dims = b3_case(shape, seed)
    return bucket[:, :, :h, :w], vh, qt, dims


@pytest.mark.parametrize("shape", sorted(b3_shapes()))
def test_plain_b3_edge_shapes_within_one_step_of_reference(shape):
    """The plain encode at the edges of B3's tiling against the
    reference's XLA encode, and at one MCU row (16 x 256, the smallest
    canvas the Pallas kernel takes) against the interpret-mode Pallas
    kernel: <= 1 quantization step (bf16 against exact float32 basis)."""
    rgb, vh, qt, dims = _shape_case(shape, seed=4)
    got = _port(rgb, vh, qt)
    xla = [np.asarray(x) for x in ref_enc.batched_encode_420(rgb, vh, qt)]
    for d, _ in _diffs(xla, got, dims):
        assert d.max() <= 1
    if shape == "mcu_row":
        plan = pj.make_encode_plan(len(dims), *rgb.shape[2:])
        args = pj.make_encode_args(plan, qt, vh)
        pallas = [np.asarray(x) for x in pj.encode_420(rgb, plan, args,
                                                       interpret=True)]
        for d, _ in _diffs(pallas, got, dims):
            assert d.max() <= 1


@pytest.mark.parametrize("shape", sorted(b3_shapes()))
def test_plain_b3_edge_shapes_match_exact_oracle(shape):
    """The plain encode at the edges of B3's tiling against the float64
    oracle: <= 1 step, on at most 2 + n / 10000 coefficients of an
    n-coefficient plane."""
    rgb, vh, qt, dims = _shape_case(shape, seed=5)
    got = _port(rgb, vh, qt)
    for d, n in _diffs(_oracle(rgb, dims, qt), got, dims):
        assert d.max() <= 1
        assert (d > 0).sum() <= 2 + n // 10000


@pytest.mark.parametrize("view,copied", [
    ("contiguous", False), ("row_stride_256", False), ("row_stride_200", False),
    ("row_stride_204", True), ("base_offset_4", True), ("column_stride_2", True)])
def test_aligned_rgb_operand(view, copied):
    """B3's 8-byte loads need columns contiguous and the base and the
    image, channel and row strides multiples of 8: a view that has them is
    passed through as it is (the 200 rung among them), any other is
    copied to a fresh contiguous tensor with the same content."""
    def bucket(h, w):
        return torch.arange(2 * 3 * h * w, dtype=torch.int64).to(torch.uint8) \
            .reshape(2, 3, h, w)

    rgb = {"contiguous": lambda: bucket(16, 32),
           "row_stride_256": lambda: bucket(32, 256)[:, :, :16, :208],
           "row_stride_200": lambda: bucket(32, 200)[:, :, :16, :192],
           "row_stride_204": lambda: bucket(32, 204)[:, :, :16, :192],
           "base_offset_4": lambda: bucket(16, 64)[:, :, :, 4:36],
           "column_stride_2": lambda: bucket(16, 64)[:, :, :, ::2]}[view]()
    got = jpeg_kernels._aligned_rgb(rgb)
    assert torch.equal(got, rgb)
    assert got.stride(3) == 1 and got.data_ptr() % 8 == 0
    assert all(got.stride(d) % 8 == 0 for d in range(3))
    assert (got.data_ptr() != rgb.data_ptr()) == copied
    if not copied:
        assert got.stride() == rgb.stride()


def test_wrapper_on_cpu_counts_no_launch():
    rgb, vh, qt, _ = _shape_case("mcu_col", seed=6)
    before = jpeg_kernels.encode_launches
    got = _port(rgb, vh, qt)
    assert jpeg_kernels.encode_launches == before   # the plain version ran
    want = port_enc.encode_420_plain(torch.from_numpy(rgb), torch.from_numpy(vh),
                                     torch.from_numpy(qt))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_cuda_basis_literals_equal_the_float32_basis():
    """B3's __constant__ FDCT basis literals are the float32 basis."""
    src = (Path(__file__).resolve().parent.parent / "imageprocessor_tpu_torch"
           / "csrc" / "jpeg_encode.cu").read_text()
    table = src[src.index("kDct[64] = {"):src.index("};", src.index("kDct[64]"))]
    vals = [np.float32(v) for v in re.findall(r"(-?\d\.\d+e[-+]\d+)f", table)]
    assert len(vals) == 64
    np.testing.assert_array_equal(np.array(vals, np.float32).reshape(8, 8),
                                  idct_basis())


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
