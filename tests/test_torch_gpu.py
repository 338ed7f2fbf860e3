"""Kernels B1-B4 on the card against their plain PyTorch versions, B1 and
B3 directly against the reference (the JAX package on CPU), and the
tensor ops of ops/extra.py (crop, flip, rotate, grayscale) and the
single-image resamples on the card against their own CPU results.

These need a CUDA card and nvcc (the kernels have no CPU mode); without a
card they skip. B1 runs every subsampling at the edges of its tiling and
of its two store widths (``b1_shapes``), B3 at the edges of its tiling
and on strided views (``b3_shapes``). Run them on a GPU host with:

    python -m pytest tests/test_torch_gpu.py -m gpu -s

Limits: B1 <= 1 LSB inside each valid region (IDCT summation order),
against its plain version and against the reference's
``batched_decode_ycbcr``; B2 and B4 exactly equal (same float32
operations in the same order); B3 <= 1 quantization step inside each
image's ceil16(valid) grid (FDCT summation order), against its plain
version and against the reference's ``batched_encode_420``, and <= 1 step
on at most 2 + n / 10000 coefficients of an n-coefficient plane against
the float64 oracle ``encode_oracle`` (the bound that
tests/test_torch_jpeg_encode.py holds the plain version to); crop, flip,
rotation by 90s and grayscale on the card equal to the CPU's result;
rotation by another angle <= 1 LSB from it (the differing pixels are
printed); ``resize_image`` and ``thumbnail_image`` launch B4 once each
and equal the CPU's plain version.
"""

import numpy as np
import pytest
import torch

from imageprocessor_tpu.ops import jpeg_decode as ref_dec
from imageprocessor_tpu.ops import jpeg_encode as ref_enc
from imageprocessor_tpu.runtime.splice import _fdct_quantize_rect
from imageprocessor_tpu_torch.ops import extra
from imageprocessor_tpu_torch.ops import fused_resample as fr
from imageprocessor_tpu_torch.ops import jpeg_kernels
from imageprocessor_tpu_torch.ops import planar_resample as pr
from imageprocessor_tpu_torch.ops.jpeg_decode import decode_ycbcr
from imageprocessor_tpu_torch.ops.jpeg_encode import encode_420_plain, quality_qtables
from imageprocessor_tpu_torch.ops.resize import resize_image
from imageprocessor_tpu_torch.ops.thumbnail import thumbnail_image

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


@pytest.mark.parametrize("shape", sorted(b1_shapes(2, 2)))
@pytest.mark.parametrize("fh,fw", [(2, 2), (1, 2), (2, 1), (1, 1)])
def test_b1_matches_reference(cuda, fh, fw, shape):
    """B1 on the card against the reference's XLA decode on the CPU, the
    same seeded coefficients: <= 1 LSB on each valid region (the two
    links B1 -> plain -> reference are each <= 1 LSB; this holds their
    sum to 1)."""
    h, w, dims, out_hw = b1_shapes(fh, fw)[shape]
    args = _coefs(dims, h, w, fh, fw, seed=fh * 10 + fw, device=cuda)
    got = jpeg_kernels.decode_coefs(*args, fh, fw, out_hw).cpu().numpy()
    want = np.asarray(ref_dec.batched_decode_ycbcr(
        *(a.cpu().numpy() for a in args), fh=fh, fw=fw, out_h=out_hw[0],
        out_w=out_hw[1]))
    for i, (vh, vw) in enumerate(dims):
        assert np.abs(got[i, :, :vh, :vw].astype(int)
                      - want[i, :, :vh, :vw].astype(int)).max() <= 1


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


def b3_shapes() -> dict:
    """(canvas h, w, valid dims, bucket) at the edges of B3's 64 x 256
    tiling: the 200 rung on a 208 canvas; several tiles each way
    (384 x 512); one MCU at batch 1; one MCU column; one MCU row; a canvas
    wider than one tile and not a multiple of it (16 x 528); valid dims of
    (1, 1); odd valid widths and odd valid heights; extents that end
    inside the first MCU of a tile. With a
    bucket (h, w) the canvas is the top-left view of an allocation of that
    size: row strides of 256 and of 200 (the one ladder rung that is a
    multiple of 8 but not of 16) are read in place, one of 204 is copied
    by the wrapper."""
    return {
        "w200": (208, 208, [(200, 200), (190, 196)], None),
        "384x512": (384, 512, [(380, 500), (384, 512), (200, 260)], None),
        "mcu_b1": (16, 16, [(16, 16)], None),
        "mcu_col": (64, 16, [(61, 15), (64, 16)], None),
        "mcu_row": (16, 256, [(15, 250)], None),
        "w528": (16, 528, [(16, 528), (13, 517)], None),
        "valid_1x1": (64, 256, [(1, 1), (1, 1)], None),
        "odd_vw": (80, 528, [(80, 261), (64, 7), (34, 527)], None),
        "odd_vh": (80, 528, [(61, 272), (7, 256), (79, 512)], None),
        "tile_first_mcu": (128, 528, [(70, 260), (65, 257), (128, 270)], None),
        "view_aligned": (208, 208, [(200, 200), (190, 196), (1, 1)], (224, 256)),
        "view_stride200": (192, 192, [(192, 192), (180, 185)], (200, 200)),
        "view_stride204": (192, 192, [(192, 192), (180, 185)], (200, 204)),
    }


def coef_diffs(want, got, dims):
    """Per (plane, image): |want - got| over the image's ceil16 grid."""
    for a, b, div in zip(want, got, (1, 2, 2)):
        for i, (h, w) in enumerate(dims):
            gh, gw = -(-h // 16) * 16 // div, -(-w // 16) * 16 // div
            yield (np.abs(a[i, :gh, :gw].astype(int) - b[i, :gh, :gw].astype(int)),
                   gh * gw)


def encode_oracle(rgb, dims, qt):
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


def b3_case(shape, seed):
    """A b3_shapes entry as numpy: the seeded bucket, the canvas dims
    (h, w) of its top-left view, valid dims (B, 2) int32, the q85 tables,
    and the valid dims as a list."""
    h, w, dims, bucket = b3_shapes()[shape]
    bh, bw = bucket or (h, w)
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (len(dims), 3, bh, bw), dtype=np.uint8), (h, w),
            np.array(dims, np.int32), quality_qtables(85).astype(np.float32), dims)


def _rgb(shape, seed, device):
    """b3_case on ``device``, the canvas a view of its bucket."""
    bucket, (h, w), vh, qt, dims = b3_case(shape, seed)
    return (torch.from_numpy(bucket).to(device)[:, :, :h, :w],
            torch.from_numpy(vh).to(device), torch.from_numpy(qt).to(device), dims)


@pytest.mark.parametrize("shape", sorted(b3_shapes()))
def test_b3_matches_plain(cuda, shape):
    rgb, vh, qt, dims = _rgb(shape, 3, cuda)
    n = jpeg_kernels.encode_launches
    got = jpeg_kernels.encode_420(rgb, vh, qt)
    want = encode_420_plain(rgb, vh, qt)
    torch.cuda.synchronize()
    assert jpeg_kernels.encode_launches == n + 1
    for g, w, div in zip(got, want, (1, 2, 2)):
        for i, (h, wd) in enumerate(dims):
            gh, gw = -(-h // 16) * 16 // div, -(-wd // 16) * 16 // div
            assert (g[i, :gh, :gw].int() - w[i, :gh, :gw].int()).abs().max() <= 1


@pytest.mark.parametrize("shape", sorted(b3_shapes()))
def test_b3_matches_reference(cuda, shape):
    """B3 on the card against the reference's XLA encode on the CPU
    (<= 1 step) and against the float64 oracle (<= 1 step on at most
    2 + n / 10000 coefficients per plane; the count is printed)."""
    rgb, vh, qt, dims = _rgb(shape, 5, cuda)
    got = [g.cpu().numpy() for g in jpeg_kernels.encode_420(rgb, vh, qt)]
    rgb_np, vh_np, qt_np = rgb.cpu().numpy(), vh.cpu().numpy(), qt.cpu().numpy()
    xla = [np.asarray(x) for x in ref_enc.batched_encode_420(rgb_np, vh_np, qt_np)]
    for d, _ in coef_diffs(xla, got, dims):
        assert d.max() <= 1
    counts = []
    for d, n in coef_diffs(encode_oracle(rgb_np, dims, qt_np), got, dims):
        assert d.max() <= 1
        assert (d > 0).sum() <= 2 + n // 10000
        counts.append(int((d > 0).sum()))
    print(f"B3 {shape} vs float64 oracle: coefficients that differ per "
          f"(plane, image) {counts}")


@pytest.mark.parametrize("what,offset,s_row", [("base", 4, 32), ("row", 0, 36)])
def test_b3_entry_refuses_misaligned(cuda, what, offset, s_row):
    """The C entry point refuses a base or a row stride that is not a
    multiple of 8 (the wrapper copies such a view before it calls)."""
    from imageprocessor_tpu_torch import kernels

    rgb = torch.zeros((1, 3, 16, 32), dtype=torch.uint8, device=cuda)
    vh = torch.tensor([[16, 16]], dtype=torch.int32, device=cuda)
    qt = torch.ones((2, 8, 8), device=cuda)
    outs = [torch.empty(n, dtype=torch.int16, device=cuda) for n in (256, 64, 64)]
    rc = kernels.library().ip_encode_420(
        rgb.data_ptr() + offset, rgb.stride(0), rgb.stride(1), s_row,
        vh.data_ptr(), qt.data_ptr(), *(o.data_ptr() for o in outs), 1, 16, 16,
        kernels.stream_ptr(cuda))
    assert rc != 0


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


# --- ops/extra.py and the single-image resamples ------------------------------

EXTRA_DIMS = [(300, 400), (384, 512), (37, 53), (1, 1)]


def _bucket(seed=9):
    """A planar (4, 3, 384, 512) bucket over nonzero padding, with mixed
    valid dims, an odd-sized image and a pad row."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(1, 256, (len(EXTRA_DIMS), 3, 384, 512),
                                          dtype=np.uint8)),
            np.array(EXTRA_DIMS, np.int32))


BATCHED = {
    "grayscale": lambda x, hw: extra.batched_grayscale_planar(x),
    "flip_h": lambda x, hw: extra.batched_flip(x, hw, "horizontal"),
    "flip_v": lambda x, hw: extra.batched_flip(x, hw, "vertical"),
    "crop": lambda x, hw: extra.batched_crop(x, hw, 21, 13, 150, 100),
    "crop_past_bucket": lambda x, hw: extra.batched_crop(x, hw, 400, 300, 512, 384),
    "rot90": lambda x, hw: extra.batched_rotate(x, hw, 90),
    "rot180": lambda x, hw: extra.batched_rotate(x, hw, 180),
    "rot270": lambda x, hw: extra.batched_rotate(x, hw, 270),
}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_extra_op_equals_cpu(cuda, name):
    imgs, hw = _bucket()
    want = BATCHED[name](imgs, hw)
    got = BATCHED[name](imgs.to(cuda), hw)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("angle", [30.0, 123.4, 359.0])
def test_batched_rotate_arbitrary_close_to_cpu(cuda, angle):
    imgs, hw = _bucket()
    want = extra.batched_rotate(imgs, hw, angle)
    got = extra.batched_rotate(imgs.to(cuda), hw, angle).cpu()
    diff = (got.int() - want.int()).abs()
    print(f"rotate {angle}: {int((diff > 0).sum())} of {diff.numel()} values "
          f"differ from the CPU's, max {int(diff.max())}")
    assert int((diff > 1).sum()) <= 8   # validity mask at a boundary pixel
    assert int((diff > 0).sum()) <= diff.numel() // 1000


SINGLE = {
    "crop": lambda x: extra.crop_image(x, 21, 13, 150, 100),
    "flip_h": lambda x: extra.flip_image(x, "horizontal"),
    "flip_v": lambda x: extra.flip_image(x, "vertical"),
    "rot90": lambda x: extra.rotate_image(x, 90),
    "rot270": lambda x: extra.rotate_image(x, 270),
    "grayscale": lambda x: extra.grayscale_image(x),
}


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_extra_op_equals_cpu(cuda, name):
    img = torch.from_numpy(np.random.default_rng(12).integers(
        0, 256, (301, 403, 3), dtype=np.uint8))
    got = SINGLE[name](img.to(cuda))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), SINGLE[name](img))


def test_grayscale_bucket_goes_into_b3_in_place(cuda):
    """The gray bucket on the card, sliced as the engine slices it, is
    read by B3 where it lies and encodes as the plain version does
    (<= 1 step)."""
    imgs, hw = _bucket()
    gray = extra.batched_grayscale_planar(imgs.to(cuda))
    view = gray[:, :, :304, :400]
    assert jpeg_kernels._aligned_rgb(view) is view
    vh = torch.from_numpy(np.minimum(hw, (304, 400)).astype(np.int32)).to(cuda)
    qt = torch.from_numpy(quality_qtables(85).astype(np.float32)).to(cuda)
    n = jpeg_kernels.encode_launches
    got = jpeg_kernels.encode_420(view, vh, qt)
    want = encode_420_plain(view, vh, qt)
    torch.cuda.synchronize()
    assert jpeg_kernels.encode_launches == n + 1
    for g, w, div in zip(got, want, (1, 2, 2)):
        for i, (h, wd) in enumerate(np.minimum(hw, (304, 400))):
            gh, gw = -(-h // 16) * 16 // div, -(-wd // 16) * 16 // div
            assert (g[i, :gh, :gw].int() - w[i, :gh, :gw].int()).abs().max() <= 1


@pytest.mark.parametrize("what", ["resize", "resize_keep_aspect", "thumbnail_crop",
                                  "thumbnail_aspect"])
def test_single_image_resample_launches_b4(cuda, what):
    img = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, (300, 400, 3), dtype=np.uint8))
    fn = {"resize": lambda x: resize_image(x, 128, 96),
          "resize_keep_aspect": lambda x: resize_image(x, 1024, 768, True),
          "thumbnail_crop": lambda x: thumbnail_image(x, 200, True),
          "thumbnail_aspect": lambda x: thumbnail_image(x, 64, False)}[what]
    n = pr.launches
    got = fn(img.to(cuda))
    torch.cuda.synchronize()
    assert pr.launches == n + 1
    want = fn(img)
    assert pr.launches == n + 1   # the CPU call launches nothing
    assert torch.equal(got.cpu(), want)
