"""The port never needs jax or the reference package, never falls back
silently, and chip_smoke.py refuses to run without a card.

The first test imports the package, its engine, the watermark and
splice modules, the kernels' op modules and every module chip_smoke.py
imports in a fresh interpreter where ``import jax`` and
``import imageprocessor_tpu`` fail (``sys.modules[...] = None``), then
checks that no module of either got loaded.
"""

import ast
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from imageprocessor_tpu_torch.device import resolve_device
from imageprocessor_tpu_torch.ops import fused_resample as fr
from imageprocessor_tpu_torch.ops import jpeg_kernels
from imageprocessor_tpu_torch.ops import planar_resample as pr
from imageprocessor_tpu_torch.ops.jpeg_decode import decode_ycbcr
from imageprocessor_tpu_torch.ops.jpeg_encode import encode_420_plain
from imageprocessor_tpu_torch.ops.resize import resize_image
from imageprocessor_tpu_torch.ops.thumbnail import thumbnail_image

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "imageprocessor_tpu_torch"


def _chip_smoke_imports() -> list[str]:
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return sorted(set(mods) - {"__future__"})


def test_imports_succeed_with_jax_blocked():
    mods = ["imageprocessor_tpu_torch", "imageprocessor_tpu_torch.runtime.engine",
            "imageprocessor_tpu_torch.models.pipeline",
            "imageprocessor_tpu_torch.ops.watermark",
            "imageprocessor_tpu_torch.runtime.splice",
            "imageprocessor_tpu_torch.runtime.hostcodec",
            "imageprocessor_tpu_torch.ops.jpeg_encode",
            "imageprocessor_tpu_torch.ops.planar_resample",
            "imageprocessor_tpu_torch.ops.extra",
            "imageprocessor_tpu_torch.ops.resize",
            "imageprocessor_tpu_torch.ops.thumbnail",
            "imageprocessor_tpu_torch.runtime.coeftx", "chip_smoke",
            *_chip_smoke_imports()]
    assert "imageprocessor_tpu_torch.runtime.engine" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["imageprocessor_tpu"] = None
        sys.path.insert(0, {str(REPO)!r})
        for m in {mods!r}:
            importlib.import_module(m)
        loaded = [m for m in sys.modules if sys.modules[m] and m.split(".")[0]
                  in ("jax", "jaxlib", "imageprocessor_tpu")]
        assert not loaded, loaded
        print("imported", len({mods!r}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


def test_package_source_never_imports_jax_or_the_reference():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|imageprocessor_tpu)(\.|\s|$)", re.M)
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
    from imageprocessor_tpu_torch.storage import LocalFSObjectStore
    with pytest.raises(RuntimeError):
        TorchProcessingEngine(LocalFSObjectStore(str(tmp_path)))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_tensors_take_the_plain_path_and_others_raise():
    rng = np.random.default_rng(4)
    yc = torch.from_numpy(rng.integers(-64, 64, (1, 16, 16)).astype(np.int16))
    cb = torch.from_numpy(rng.integers(-64, 64, (1, 8, 8)).astype(np.int16))
    cr = cb.clone()
    qt = torch.ones((1, 3, 8, 8), dtype=torch.float32)
    cv = torch.tensor([[8, 8]], dtype=torch.int32)
    counts = (jpeg_kernels.launches, jpeg_kernels.encode_launches, fr.launches,
              pr.launches)
    out = jpeg_kernels.decode_coefs(yc, cb, cr, qt, cv, 2, 2, (16, 16))
    assert torch.equal(out, decode_ycbcr(yc, cb, cr, qt, cv))
    taps = fr.make_taps(np.array([[16, 16]]), np.array([[4, 4]]), (4, 4), (16, 16))
    a, _ = fr.fused_resample(out, taps, None)
    assert torch.equal(a, fr.resample_plain(out, taps))
    assert torch.equal(pr.planar_resample(out, taps), a)
    vh = torch.tensor([[12, 13]], dtype=torch.int32)
    qt2 = torch.full((2, 8, 8), 3.0)
    for x, y in zip(jpeg_kernels.encode_420(out, vh, qt2),
                    encode_420_plain(out, vh, qt2)):
        assert torch.equal(x, y)
    # the single-image resamples are one-image calls of planar_resample
    img = out[0].permute(1, 2, 0).contiguous()
    small = resize_image(img, 8, 6)
    assert tuple(small.shape) == (6, 8, 3)
    taps86 = fr.make_taps(np.array([[16, 16]]), np.array([[6, 8]]), (6, 8), (16, 16))
    assert torch.equal(small.permute(2, 0, 1)[None], fr.resample_plain(out, taps86))
    assert tuple(thumbnail_image(img, 4, crop_to_fit=True).shape) == (4, 4, 3)
    assert counts == (jpeg_kernels.launches, jpeg_kernels.encode_launches,
                      fr.launches, pr.launches)
    meta = [t.to("meta") for t in (yc, cb, cr, qt, cv)]
    with pytest.raises(ValueError, match="device"):
        jpeg_kernels.decode_coefs(*meta, 2, 2, (16, 16))
    with pytest.raises(ValueError, match="device"):
        fr.fused_resample(out.to("meta"), taps.to("meta"), None)
    with pytest.raises(ValueError, match="device"):
        pr.planar_resample(out.to("meta"), taps.to("meta"))
    with pytest.raises(ValueError, match="device"):
        jpeg_kernels.encode_420(out.to("meta"), vh.to("meta"), qt2.to("meta"))
    with pytest.raises(ValueError, match="device"):
        resize_image(img.to("meta"), 8, 6)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300, cwd=str(script.parent))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
