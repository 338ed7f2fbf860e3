"""The port's host library (runtime/hostcodec.py, built without libjpeg)
against the reference's nativecodec bindings of the same native code.

Both call native/jpeg_scan.cpp, native/jpeg_emit.cpp and
native/gifquant.cpp, so every comparison is exact: the same scanned
planes, tables and offsets, the same emitted bytes, the same GIF indices
and palette.
"""

import io

import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.runtime import nativecodec
from imageprocessor_tpu.runtime import splice as ref_splice
from imageprocessor_tpu_torch.runtime import hostcodec
from imageprocessor_tpu_torch.runtime import splice as port_splice

RNG = np.random.default_rng(5)


def jpeg_bytes(h, w, subsampling=2, **save):
    yy = np.linspace(0, 170, h)[:, None, None]
    arr = np.clip(yy + RNG.integers(0, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="JPEG", quality=88,
                                 subsampling=subsampling, **save)
    return bio.getvalue()


def restart_marked(blob):
    planes, qt, (w, h), samp = nativecodec.scan_jpeg_coefficients(blob)
    return nativecodec.emit_jpeg_from_coefficients(planes, qt, w, h, samp[0],
                                                   restart_interval=5)


@pytest.mark.parametrize("h,w,subsampling", [(120, 168, 2), (97, 131, 0),
                                             (64, 200, 1)])
def test_scan_and_emit_equal_nativecodec(h, w, subsampling):
    blob = jpeg_bytes(h, w, subsampling)
    a = nativecodec.scan_jpeg_coefficients(blob)
    b = hostcodec.scan_jpeg_coefficients(blob)
    for pa, pb in zip(a[0], b[0]):
        np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2:] == b[2:]
    planes, qt, (iw, ih), samp = b
    assert (hostcodec.emit_jpeg_from_coefficients(planes, qt, iw, ih, samp[0])
            == nativecodec.emit_jpeg_from_coefficients(planes, qt, iw, ih,
                                                       samp[0]))


def test_strided_emit_of_batch_canvas_equals_contiguous():
    """The engine emits slices of B3's batch canvases in place."""
    yc = RNG.integers(-60, 60, (2, 64, 96)).astype(np.int16)
    cb = RNG.integers(-30, 30, (2, 32, 48)).astype(np.int16)
    cr = RNG.integers(-30, 30, (2, 32, 48)).astype(np.int16)
    qt = np.full((2, 8, 8), 4, np.uint16)
    h, w = 40, 70
    views = [yc[1, :48, :80], cb[1, :24, :40], cr[1, :24, :40]]
    assert views[0].strides[0] == 96 * 2
    got = hostcodec.emit_jpeg_from_coefficients(views, qt, w, h, (2, 2))
    want = nativecodec.emit_jpeg_from_coefficients(
        [np.ascontiguousarray(v) for v in views], qt, w, h, (2, 2))
    assert got == want
    with pytest.raises(hostcodec.HostCodecError):
        hostcodec.emit_jpeg_from_coefficients(views, qt, w + 16, h, (2, 2))


@pytest.mark.parametrize("kind", ["baseline", "restart", "444"])
def test_transcode_scan_and_splice_emit_equal_nativecodec(kind):
    blob = jpeg_bytes(136, 184, 0 if kind == "444" else 2)
    if kind == "restart":
        blob = restart_marked(blob)
    a = nativecodec.scan_jpeg_for_transcode(blob)
    b = hostcodec.scan_jpeg_for_transcode(blob)
    for name in nativecodec.JpegSpliceContext.__slots__:
        va, vb = getattr(a, name), getattr(b, name)
        if name == "planes":
            for pa, pb in zip(va, vb):
                np.testing.assert_array_equal(pa, pb)
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, name
    flags = np.zeros((b.mcus_y, b.mcus_x), np.uint8)
    flags[-2:, -3:] = 1
    for ctx in (a, b):
        ctx.planes[0][-16:, -24:] //= 2
    assert (hostcodec.emit_jpeg_transcode(b, flags)
            == nativecodec.emit_jpeg_transcode(a, flags))


def test_splice_copy_matches_reference():
    """The copied runtime/splice.py over the port's bindings emits the
    reference's bytes: the same C++ and the same font."""
    from types import SimpleNamespace

    op = SimpleNamespace(text="hi mark", opacity=0.5, position="bottom-right",
                         font_size=None, font_color="")
    blob = jpeg_bytes(168, 232)
    out_a = ref_splice.watermark_splice(nativecodec.scan_jpeg_for_transcode(blob), op)
    ctx = hostcodec.scan_jpeg_for_transcode(blob)
    out_b = port_splice.watermark_splice(ctx, op)
    assert out_a == out_b
    assert not ctx.edited
    np.testing.assert_array_equal(port_splice.decode_rgb(ctx), ref_splice.decode_rgb(
        nativecodec.scan_jpeg_for_transcode(blob)))
    ctx.edited = True
    with pytest.raises(hostcodec.HostCodecError):
        port_splice.watermark_splice(ctx, op)


def test_progressive_probe_and_refusals():
    blob = jpeg_bytes(64, 80)
    prog = jpeg_bytes(64, 80, progressive=True)
    assert not hostcodec.is_progressive(blob)
    assert hostcodec.is_progressive(prog) == nativecodec.is_progressive(prog) is True
    with pytest.raises(hostcodec.HostCodecError):
        hostcodec.scan_jpeg_for_transcode(prog)
    with pytest.raises(hostcodec.HostCodecError):
        hostcodec.scan_jpeg_for_transcode(blob[:len(blob) // 2])
    with pytest.raises(hostcodec.HostCodecError):
        hostcodec.is_progressive(b"\xff\xd8garbage")


@pytest.mark.parametrize("dither", [True, False])
def test_gif_quantizer_equals_nativecodec(dither):
    rgb = RNG.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    ia, pa = nativecodec.gif_quantize_plan9(rgb, dither=dither)
    ib, pb = hostcodec.gif_quantize_plan9(rgb, dither=dither)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(pa, pb)
