"""The port's copies of the reference's jax-free modules stay equal to them.

imageprocessor_tpu_torch never imports the reference package, so it
carries copies of the domain types, the errors, the memory broker, the
local-filesystem and SQLite stores, the batcher, the host codecs and the
metrics. Every top-level import, function, class and constant of a copy
must have the same source as the original's once the package name is
swapped back, and a copy may leave out only the names listed in OMITTED.

Three copies differ in named places:

* runtime/codecs.py has no libjpeg shim (runtime/nativecodec.py): it
  imports the port's host library (runtime/hostcodec.py) in its place,
  and its decode_image and encode_image are held to the original's
  results instead — PNG, BMP and GIF exactly (both quantize GIFs with the
  same native Plan9 code); JPEG within 1 LSB on decode (two libjpeg
  builds may round the IDCT and the chroma upsample differently) and
  PSNR > 45 dB on encode (the same IJG quality tables; the encoders may
  round their FDCTs differently);
* runtime/splice.py imports runtime/hostcodec.py and the port's
  ops/watermark.py where the original imports nativecodec and the
  reference's ops/watermark.py; only its import lines may differ;
* runtime/coeftx.py imports the port's domain, splice and host library,
  and its ``_rot_native`` returns None: the reference's calls a blocked
  rotation kernel of its libjpeg shim, which the port's host library
  (built without libjpeg) does not have, so ``apply`` takes the numpy
  path that the reference keeps as its behavioural reference
  (tests/test_torch_coeftx.py holds the results equal).
"""

import ast
import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.runtime import codecs as ref_codecs
from imageprocessor_tpu_torch.runtime import codecs as port_codecs
from tests.oracle import psnr

REPO = Path(__file__).resolve().parent.parent
REF, PORT = REPO / "imageprocessor_tpu", REPO / "imageprocessor_tpu_torch"

COPIES = ["domain/__init__.py", "domain/image.py", "domain/task.py", "errors.py",
          "broker/base.py", "broker/memory.py", "storage/object_store.py",
          "storage/localfs.py", "storage/metadata.py", "storage/sqlite_meta.py",
          "runtime/batcher.py", "runtime/codecs.py", "runtime/splice.py",
          "runtime/coeftx.py", "utils/metrics.py"]
# names of the original a copy leaves out: factories of backends the port
# lacks
OMITTED = {"broker/base.py": {"build_broker"},
           "storage/object_store.py": {"build_object_store"},
           "storage/metadata.py": {"build_metadata_store"}}
DIFFERS = {"runtime/codecs.py": {"from imageprocessor_tpu.runtime",
                                 "decode_image", "encode_image"},
           "runtime/coeftx.py": {"_rot_native"}}
# copies whose top-level imports are their own (the host library in place
# of nativecodec); every other top-level name keeps the original's source
OWN_IMPORTS = {"runtime/splice.py", "runtime/coeftx.py"}


def _top_level(path: Path, rename: bool) -> dict[str, str]:
    """Top-level imports, defs, classes and assignments -> their source."""
    src = path.read_text()
    if rename:
        src = src.replace("imageprocessor_tpu_torch", "imageprocessor_tpu")
    own_imports = path.relative_to(path.parents[1]).as_posix() in OWN_IMPORTS
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, ast.ImportFrom):
            if own_imports and node.module != "__future__":
                continue
            names = [node.module]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign):
            names = [node.target.id]
        else:
            continue
        for name in names:
            key = f"from {name}" if isinstance(node, ast.ImportFrom) else name
            out[key] = ast.unparse(node)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copy_has_the_originals_source(rel):
    port = _top_level(PORT / rel, rename=True)
    ref = _top_level(REF / rel, rename=False)
    assert port, rel
    assert set(ref) - set(port) == OMITTED.get(rel, set())
    for name, src in port.items():
        assert name in ref, f"{rel}: {name} is not in the original"
        if name not in DIFFERS.get(rel, ()):
            assert src == ref[name], f"{rel}: {name} differs from the original"


def _image(h, w, seed, alpha=False):
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 160, h)[:, None, None]
    xx = np.linspace(0, 80, w)[None, :, None]
    img = np.clip(yy + xx + rng.integers(0, 16, (h, w, 4 if alpha else 3)),
                  0, 255).astype(np.uint8)
    return img


def _blob(fmt, **save):
    bio = io.BytesIO()
    img = _image(97, 131, seed=len(fmt), alpha=fmt == "PNGA")
    PILImage.fromarray(img).save(bio, format=fmt[:3] if fmt == "PNGA" else fmt,
                                 **save)
    return bio.getvalue()


@pytest.mark.parametrize("fmt,save,lsb", [
    ("JPEG", {"quality": 90, "subsampling": 2}, 1),
    ("JPEG", {"quality": 90, "subsampling": 0}, 1),
    ("PNG", {}, 0), ("PNGA", {}, 0), ("GIF", {}, 0), ("BMP", {}, 0)])
def test_decode_image_matches_original(fmt, save, lsb):
    blob = _blob(fmt, **save)
    a, fa = ref_codecs.decode_image(blob)
    b, fb = port_codecs.decode_image(blob)
    assert fa == fb
    assert a.shape == b.shape
    assert np.abs(a.astype(int) - b.astype(int)).max() <= lsb


def test_truncated_jpeg_refused_alike():
    blob = _blob("JPEG", quality=90)[:600]
    with pytest.raises(ref_codecs.DecodeError):
        ref_codecs.decode_image(blob)
    with pytest.raises(port_codecs.DecodeError):
        port_codecs.decode_image(blob)


@pytest.mark.parametrize("fmt", ["jpeg", "png", "bmp", "gif"])
def test_encode_image_matches_original(fmt):
    img = _image(120, 161, seed=3)
    a, _ = ref_codecs.decode_image(ref_codecs.encode_image(img, fmt, 85))
    b, _ = ref_codecs.decode_image(port_codecs.encode_image(img, fmt, 85))
    assert a.shape == b.shape == img.shape
    if fmt == "jpeg":
        assert psnr(a, b) > 45.0
    else:
        np.testing.assert_array_equal(a, b)
