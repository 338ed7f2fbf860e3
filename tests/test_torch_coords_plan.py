"""The port's copies of the reference's jax-free helpers stay equal to them.

imageprocessor_tpu_torch carries copies of coords' dims helpers,
models/plan.py and runtime/paths.py because the reference modules cannot
be imported without jax. Each side gets operations built from the same
wire (type, parameters) pairs with its own domain types. Every comparison
here is exact: the copies must not drift.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocessor_tpu import domain as ref_domain
from imageprocessor_tpu.models import plan as ref_plan
from imageprocessor_tpu.ops import coords as ref_coords
from imageprocessor_tpu.ops.jpeg_decode import _idct_basis
from imageprocessor_tpu.runtime import paths as ref_paths
from imageprocessor_tpu_torch import domain as port_domain
from imageprocessor_tpu_torch.models import plan as port_plan
from imageprocessor_tpu_torch.ops import coords as port_coords
from imageprocessor_tpu_torch.ops.jpeg_decode import idct_basis
from imageprocessor_tpu_torch.runtime import paths as port_paths

SIZES = [(4000, 3000), (3000, 4000), (640, 480), (1, 1), (1920, 1080),
         (200, 200), (7, 5000), (5000, 7), (333, 777)]


@pytest.mark.parametrize("w,h", SIZES)
def test_dims_helpers_equal(w, h):
    for tw, th in ((1024, 768), (128, 96), (1, 1), (5000, 5000)):
        assert (port_coords.keep_aspect_dims(w, h, tw, th)
                == ref_coords.keep_aspect_dims(w, h, tw, th))
    for size in (200, 64, 1, 4096):
        assert (port_coords.thumbnail_dims(w, h, size)
                == ref_coords.thumbnail_dims(w, h, size))
    assert port_coords.center_crop_rect(w, h) == ref_coords.center_crop_rect(w, h)


@pytest.mark.parametrize("out_size,src_size,offset", [
    (768, 3000, 0.0), (200, 3000, 500.0), (1024, 640, 0.0), (7, 5, 2.0)])
def test_bilinear_coords_equal(out_size, src_size, offset):
    a = ref_coords.bilinear_coords(out_size, src_size, src_offset=offset)
    b = port_coords.bilinear_coords(out_size, src_size, src_offset=offset)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_quantize_go_xdraw_equal():
    x = np.linspace(-3.0, 258.0, 100_003, dtype=np.float32)
    x = np.concatenate([x, np.arange(256, dtype=np.float32) * 256.0 / 257.0])
    np.testing.assert_array_equal(
        np.asarray(ref_coords.quantize_go_xdraw(jnp.asarray(x))),
        port_coords.quantize_go_xdraw(torch.from_numpy(x)).numpy())


OPS = [
    [],
    [("thumbnail", {"size": 200, "crop_to_fit": True}),
     ("resize", {"width": 1024, "height": 768, "keep_aspect": True})],
    [("resize", {"width": 10.7, "height": 3})],
    [("thumbnail", {})],
    [("watermark", {"text": "hi", "opacity": 0.3, "position": "nowhere"})],
    [("crop", {"x": -3, "y": 2, "width": 5, "height": 6}),
     ("rotate", {"angle": 450}),
     ("flip", {"direction": "vertical"}),
     ("grayscale", {})],
]
BAD_OPS = [
    [("resize", {"width": 0, "height": 3})],
    [("resize", {"width": float("inf"), "height": 3})],
    [("thumbnail", {"size": -1})],
    [("flip", {"direction": "diagonal"})],
    [("rotate", {})],
]


def _ops(domain, wire):
    """OperationParams of one package's domain from (type, params) pairs."""
    return [domain.OperationParams(domain.OperationType(t), dict(p))
            for t, p in wire]


@pytest.mark.parametrize("ops", OPS)
def test_normalize_operations_and_paths_equal(ops):
    a = ref_plan.normalize_operations(_ops(ref_domain, ops))
    b = port_plan.normalize_operations(_ops(port_domain, ops))
    assert a.compile_key() == b.compile_key()
    assert a.group_key() == b.group_key()
    assert len(a) == len(b)
    for op_a, op_b in zip(a, b):
        assert op_a.type.value == op_b.type.value
        assert ({**op_a.__dict__, "type": None}
                == {**op_b.__dict__, "type": None})
        for fmt in ("jpeg", "png", "gif"):
            assert (ref_paths.generate_path("img-1", op_a, fmt)
                    == port_paths.generate_path("img-1", op_b, fmt))


@pytest.mark.parametrize("ops", BAD_OPS)
def test_invalid_params_raise_alike(ops):
    with pytest.raises(ref_plan.InvalidParamsError) as ea:
        ref_plan.normalize_operations(_ops(ref_domain, ops))
    with pytest.raises(port_plan.InvalidParamsError) as eb:
        port_plan.normalize_operations(_ops(port_domain, ops))
    assert str(ea.value) == str(eb.value)


def test_op_path_prefixes_equal():
    assert port_paths.op_path_prefixes() == ref_paths.op_path_prefixes()


def test_idct_basis_and_cuda_literals_equal():
    """The kernel's __constant__ basis literals are the float32 basis."""
    np.testing.assert_array_equal(idct_basis(), _idct_basis())
    src = (Path(__file__).resolve().parent.parent / "imageprocessor_tpu_torch"
           / "csrc" / "jpeg_decode.cu").read_text()
    table = src[src.index("kIdct[64] = {"):src.index("};", src.index("kIdct[64]"))]
    vals = [np.float32(v) for v in re.findall(r"(-?\d\.\d+e[-+]\d+)f", table)]
    assert len(vals) == 64
    np.testing.assert_array_equal(np.array(vals, np.float32).reshape(8, 8),
                                  idct_basis())
