"""runtime/coeftx.py of the port (lossless coefficient-domain crop, flip,
rotate) against the reference's on the same seeded JPEGs.

The port's module is a copy of the reference's over the port's own
domain, splice and host library (tests/test_torch_shared_copies.py holds
the source), with one difference: the reference fuses a mirror +
transpose pair onto a native kernel of its libjpeg shim, the port always
takes the numpy path. So every comparison here is exact:

* ``eligible_prims``: the same primitive list (or None) over a grid of
  ops x image sizes x samplings, with the shift mirrors on and off;
* ``apply``: bit-equal planes, quantization tables, size and sampling,
  and the re-encoded stream byte-identical, for each op on each
  subsampling at block-aligned, half-MCU and odd dims;
* a transformed stream, decoded, equals the same transform of the
  decoded source exactly where the primitive is lossless (mirrors and
  rotations without ``_rs``; crops away from a subsampled crop edge).
"""

import io

import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.domain import OperationType as RefType
from imageprocessor_tpu.models.plan import NormalizedOp as RefOp
from imageprocessor_tpu.runtime import coeftx as ref_coeftx
from imageprocessor_tpu.runtime import nativecodec
from imageprocessor_tpu.runtime import splice as ref_splice
from imageprocessor_tpu_torch.domain import OperationType
from imageprocessor_tpu_torch.models.plan import NormalizedOp
from imageprocessor_tpu_torch.runtime import coeftx, hostcodec, splice

# name -> NormalizedOp fields (the type by its wire value)
OPS = {
    "flip_h": dict(type="flip", direction="horizontal"),
    "flip_v": dict(type="flip", direction="vertical"),
    "rot0": dict(type="rotate", angle=0.0),
    "rot90": dict(type="rotate", angle=90.0),
    "rot180": dict(type="rotate", angle=180.0),
    "rot270": dict(type="rotate", angle=270.0),
    "rot30": dict(type="rotate", angle=30.0),
    "crop_aligned": dict(type="crop", x=16, y=16, width=33, height=23),
    "crop_unaligned": dict(type="crop", x=5, y=9, width=40, height=30),
    "crop_luma_aligned": dict(type="crop", x=8, y=8, width=40, height=30),
    "crop_clamped": dict(type="crop", x=32, y=16, width=5000, height=5000),
    "crop_origin_outside": dict(type="crop", x=9000, y=9000, width=8, height=8),
    "grayscale": dict(type="grayscale"),
    "thumbnail": dict(type="thumbnail", size=64),
}
SAMPLINGS = {"420": [(2, 2), (1, 1), (1, 1)], "422": [(2, 1), (1, 1), (1, 1)],
             "440": [(1, 2), (1, 1), (1, 1)], "444": [(1, 1), (1, 1), (1, 1)],
             "gray": [(1, 1)]}
# (w, h): MCU multiples, half-MCU (1080-class), even non-block, odd
SIZES = [(64, 48), (1920, 1080), (1366, 768), (200, 120), (131, 97), (1, 1),
         (4000, 3000), (16, 8)]


def ops_of(name):
    """The same op as the reference's and the port's NormalizedOp."""
    kw = dict(OPS[name])
    t = kw.pop("type")
    return RefOp(type=RefType(t), **kw), NormalizedOp(type=OperationType(t), **kw)


def test_tx_types_equal_the_references():
    assert ({t.value for t in coeftx.TX_TYPES}
            == {t.value for t in ref_coeftx.TX_TYPES} == {"crop", "rotate", "flip"})


@pytest.mark.parametrize("rs", ["1", "0"], ids=["rs_on", "rs_off"])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("name", sorted(OPS))
def test_eligible_prims_equal_the_references(monkeypatch, name, sampling, rs):
    monkeypatch.setenv("IMAGEPROCESSOR_COEF_RS", rs)
    a, b = ops_of(name)
    for size in SIZES:
        want = ref_coeftx.eligible_prims(a, size, SAMPLINGS[sampling])
        got = coeftx.eligible_prims(b, size, SAMPLINGS[sampling])
        assert got == want, (size, got, want)
        if name in ("rot30", "grayscale", "thumbnail"):
            assert got is None


def jpeg_bytes(h, w, subsampling, seed, gray=False, **save):
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 170, h)[:, None, None]
    arr = np.clip(yy + rng.integers(0, 60, (h, w, 3)), 0, 255).astype(np.uint8)
    im = PILImage.fromarray(arr)
    kw = dict(quality=88, **save)
    if gray:
        im = im.convert("L")
    else:
        kw["subsampling"] = subsampling
    bio = io.BytesIO()
    im.save(bio, format="JPEG", **kw)
    return bio.getvalue()


def contexts(blob):
    """The reference's and the port's coefficient context of one stream."""
    out = []
    for codec, sp in ((nativecodec, ref_splice), (hostcodec, splice)):
        planes, qt, size, samp = codec.scan_jpeg_coefficients(blob)
        out.append(sp.promote_grayscale(planes, qt, size, samp)
                   if len(planes) == 1 else sp.coef_context(planes, qt, size, samp))
    return out


def assert_same_context(got, want):
    assert tuple(got.size) == tuple(want.size)
    assert [tuple(s) for s in got.sampling] == [tuple(s) for s in want.sampling]
    np.testing.assert_array_equal(np.asarray(got.qtabs), np.asarray(want.qtabs))
    assert len(got.planes) == len(want.planes)
    for p, q in zip(got.planes, want.planes):
        assert p.dtype == q.dtype == np.int16
        np.testing.assert_array_equal(p, q)


APPLY_OPS = [n for n in sorted(OPS)
             if n not in ("rot30", "grayscale", "thumbnail", "crop_origin_outside")]
# subsampling (PIL's number), (h, w): block-aligned; 1080-class half-MCU
# height; odd dims
SOURCES = {"420_aligned": (2, (96, 128)), "420_half_mcu": (2, (120, 176)),
           "420_odd": (2, (97, 131)), "422_odd": (1, (90, 131)),
           "444_odd": (0, (97, 131)), "gray": (None, (88, 120))}


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("name", APPLY_OPS)
def test_apply_equals_the_references(name, source):
    sub, (h, w) = SOURCES[source]
    blob = jpeg_bytes(h, w, sub or 0, seed=h + w, gray=sub is None)
    ctx_ref, ctx_port = contexts(blob)
    assert_same_context(ctx_port, ctx_ref)
    a, b = ops_of(name)
    prims = coeftx.eligible_prims(b, ctx_port.size, ctx_port.sampling)
    assert prims == ref_coeftx.eligible_prims(a, ctx_ref.size, ctx_ref.sampling)
    assert prims is not None
    before = [p.copy() for p in ctx_port.planes]
    want = ref_coeftx.apply(ctx_ref, prims)
    got = coeftx.apply(ctx_port, prims)
    assert_same_context(got, want)
    for p, q in zip(ctx_port.planes, before):   # the source is not mutated
        np.testing.assert_array_equal(p, q)
    assert splice.reencode(got) == ref_splice.reencode(want)


def test_apply_equals_the_references_numpy_path(monkeypatch):
    """The reference with its native rotation kernel switched off runs
    the code the port runs: same planes either way."""
    blob = jpeg_bytes(96, 128, 2, seed=3)
    ctx_ref, ctx_port = contexts(blob)
    monkeypatch.setattr(ref_coeftx, "_rot_native", lambda planes, mode: None)
    assert coeftx._rot_native(list(ctx_port.planes), "rot90") is None
    for name in ("rot90", "rot270"):
        _, b = ops_of(name)
        prims = coeftx.eligible_prims(b, ctx_port.size, ctx_port.sampling)
        assert_same_context(coeftx.apply(ctx_port, prims),
                            ref_coeftx.apply(ctx_ref, prims))


PIXEL_TX = {
    "flip_h": lambda a: a[:, ::-1], "flip_v": lambda a: a[::-1],
    "rot0": lambda a: a, "rot90": lambda a: np.rot90(a, 1),
    "rot180": lambda a: np.rot90(a, 2), "rot270": lambda a: np.rot90(a, 3),
    "crop_aligned": lambda a: a[16:39, 16:49],
}


@pytest.mark.parametrize("sub", [2, 1, 0], ids=["420", "422", "444"])
@pytest.mark.parametrize("name", sorted(PIXEL_TX))
def test_lossless_transform_commutes_with_the_decode(name, sub):
    """MCU-aligned dims: every primitive is lossless (no ``_rs``), the
    emitted stream rescans to the transformed planes, and its decoded
    pixels (the float64 decoder of runtime/splice.py) are the transform
    of the decoded source; a crop is exact away from its edges, where
    the chroma upsample clamps at the new plane boundary instead of
    reading the neighbours that were cropped away."""
    blob = jpeg_bytes(96, 128, sub, seed=11)
    _, ctx = contexts(blob)
    _, op = ops_of(name)
    prims = coeftx.eligible_prims(op, ctx.size, ctx.sampling)
    assert all(isinstance(p, tuple) or not p.endswith("_rs") for p in prims)
    out = coeftx.apply(ctx, prims)
    data = splice.reencode(out)
    planes, qt, size, samp = hostcodec.scan_jpeg_coefficients(data)
    assert tuple(size) == tuple(out.size)
    for p, q in zip(planes, out.planes):
        np.testing.assert_array_equal(p, q)
    want = PIXEL_TX[name](splice.decode_rgb(ctx))
    got = splice.decode_rgb(out)
    assert got.shape == want.shape
    assert PILImage.open(io.BytesIO(data)).size == want.shape[1::-1]
    if name == "crop_aligned":
        got, want = got[2:-2, 2:-2], want[2:-2, 2:-2]
    np.testing.assert_array_equal(got, want)
