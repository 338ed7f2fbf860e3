"""The port's watermark (ops/watermark.py) against the reference's.

* The glyph helpers are copies: their source equals the original's, and
  the tiles, colours and anchors they return are equal.
* ``watermark_planar_`` is bit-equal to ``batched_watermark_core_planar``
  for all seven positions, on texts inside the image, clipped at its
  edges and larger than it, with the reference's quantized tile and with
  the plain one. Both composite in float32 in the same order and round
  half to even, so no tolerance is needed.
* ``watermark_image`` (the splice's host fallback) is bit-equal to the
  reference's single-image ``watermark_image``.
"""

import ast
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageprocessor_tpu.domain import WatermarkPosition
from imageprocessor_tpu.ops import watermark as ref_wm
from imageprocessor_tpu_torch.ops import watermark as port_wm

REPO = Path(__file__).resolve().parent.parent
COPIED = ["WatermarkTile", "_FONT_LOCK", "_TILE_CACHE", "_TILE_CACHE_MAX",
          "_DEFAULT_FONT_PATH", "_MAX_TILE_W", "_MARGIN", "rasterize_text",
          "anchor_baseline", "parse_color", "resolve_color", "_pad_tile",
          "quantize_tile", "_anchor_traced"]
POSITIONS = [p.value for p in WatermarkPosition]
TEXTS = [("© ImageProcessor", 36.0), ("hi", 12.0), ("W" * 60, 40.0)]


def _defs(path: Path) -> dict[str, str]:
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.unparse(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                out[t.id] = ast.unparse(node)
    return out


def test_copied_helpers_have_the_originals_source():
    ref = _defs(REPO / "imageprocessor_tpu" / "ops" / "watermark.py")
    port = _defs(REPO / "imageprocessor_tpu_torch" / "ops" / "watermark.py")
    for name in COPIED:
        assert port[name] == ref[name], name


def test_font_lookup_and_rasterizer_equal_reference():
    assert port_wm._default_font_path() == ref_wm._default_font_path()
    for text, size in TEXTS:
        a, b = ref_wm.rasterize_text(text, size), port_wm.rasterize_text(text, size)
        np.testing.assert_array_equal(a.coverage, b.coverage)
        assert (a.width_px, a.height_px, a.ascent, a.descent) == \
            (b.width_px, b.height_px, b.ascent, b.descent)
        np.testing.assert_array_equal(ref_wm._pad_tile(ref_wm.quantize_tile(a)),
                                      port_wm._pad_tile(port_wm.quantize_tile(b)))
        for pos in POSITIONS + ["nowhere"]:
            assert (port_wm.anchor_baseline(pos, 640, 480, b)
                    == ref_wm.anchor_baseline(pos, 640, 480, a))
    for color in ("255,200,0", "1,2,3,40", "bad", "9,9", "300,-4,7,x"):
        assert port_wm.resolve_color(color, 0.5) == ref_wm.resolve_color(color, 0.5)


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("text,size", TEXTS)
def test_planar_blend_bit_equal_to_reference(text, size, quantized):
    rng = np.random.default_rng(len(text))
    # valid dims: roomy, clipped at the right/bottom, smaller than the text
    imgs = rng.integers(0, 256, (3, 3, 96, 320), dtype=np.uint8)
    src_hw = np.array([[90, 300], [96, 320], [30, 40]], np.int32)
    tile = port_wm.rasterize_text(text, size)
    if quantized:
        tile = port_wm.quantize_tile(tile)
    th, tw = tile.coverage.shape
    r, g, b, a = port_wm.resolve_color("255,200,0", 0.5)
    for pos in POSITIONS:
        want = np.asarray(ref_wm.batched_watermark_core_planar(
            jnp.asarray(imgs), jnp.asarray(src_hw),
            jnp.asarray(port_wm._pad_tile(tile)),
            jnp.asarray([r, g, b], dtype=jnp.float32), jnp.float32(a / 255.0),
            jnp.int32(tile.width_px), jnp.int32(tile.height_px),
            jnp.int32(tile.ascent), position=pos, tile_h=th, tile_w=tw))
        got = torch.from_numpy(imgs.copy())
        out = port_wm.watermark_planar_(got, src_hw, tile, (r, g, b), a / 255.0, pos)
        assert out is got   # in place
        np.testing.assert_array_equal(got.numpy(), want, err_msg=pos)
        assert (want != imgs).any()


@pytest.mark.parametrize("pos", ["bottom-right", "top-left", "center"])
def test_host_watermark_image_equals_reference(pos):
    rng = np.random.default_rng(9)
    arr = rng.integers(0, 256, (70, 150, 3), dtype=np.uint8)
    op = SimpleNamespace(text="mark", position=pos, opacity=0.7, font_size=30.0,
                         font_color="10,250,30")
    want = np.asarray(ref_wm.watermark_image(
        arr, text=op.text, position=pos, opacity=op.opacity,
        font_size=op.font_size, font_color=op.font_color))
    got = port_wm.watermark_image(arr, op)
    np.testing.assert_array_equal(got, want)
    assert (got != arr).any()
