"""IMAGEPROCESSOR_DEVICE_JPEG on the port: the operator's switch that keeps
JPEG decode and encode on the host (the reference's
tests/test_engine_device_jpeg.py).

* parsing: 1/true/yes on, 0/false/no off, unset or anything else the auto
  policy, read once at construction; the keyword wins over the variable.
  The auto policy is the reference's: on where the host has fewer usable
  cores than IMAGEPROCESSOR_DEVICE_JPEG_CORES (default 127), which holds
  on the hosts this suite runs on;
* with 0: a JPEG that needs pixels decodes on the host (layout "hwc"),
  kernel B1's and B3's wrappers are never called, and the artifacts meet
  the engine contracts of tests/test_torch_engine.py against the
  reference engine built with device_jpeg=False (equal paths, PSNR > 45
  dB; a spliced watermark and a coefficient-route transform byte for
  byte: those host routes come before the switch in both engines).
"""

import io
import uuid

import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.domain import (
    ImageStatus,
    OperationParams,
    OperationType,
    ProcessingTask,
)
from imageprocessor_tpu.runtime.codecs import decode_image
from imageprocessor_tpu.runtime.engine import ProcessingEngine
from imageprocessor_tpu.storage import LocalFSObjectStore
from imageprocessor_tpu_torch import domain as port_domain
from imageprocessor_tpu_torch.models.plan import normalize_operations
from imageprocessor_tpu_torch.runtime import engine as engine_mod
from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
from imageprocessor_tpu_torch.storage import LocalFSObjectStore as PortLocalFS
from tests.oracle import psnr

RNG = np.random.default_rng(91)


def photo(h, w):
    yy = np.linspace(0, 150, h)[:, None, None]
    xx = np.linspace(0, 70, w)[None, :, None]
    return np.clip(yy + xx + RNG.integers(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def jpeg_bytes(h, w):
    bio = io.BytesIO()
    PILImage.fromarray(photo(h, w)).save(bio, format="JPEG", quality=90)
    return bio.getvalue()


BLOBS = [jpeg_bytes(300, 400), jpeg_bytes(250, 330), jpeg_bytes(380, 260)]
PLANS = {
    "default": [OperationParams(OperationType.THUMBNAIL, {"size": 200, "crop_to_fit": True}),
                OperationParams(OperationType.RESIZE,
                                {"width": 1024, "height": 768, "keep_aspect": True})],
    "flip": [OperationParams(OperationType.FLIP, {"direction": "horizontal"})],
    "watermark": [OperationParams(OperationType.WATERMARK,
                                  {"text": "host codec", "opacity": 0.5})],
}


def make_task(ops, fmt="jpeg"):
    return ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                          original_path="original/x.jpg", bucket="images",
                          operations=ops, format=fmt)


def to_port(task):
    return port_domain.ProcessingTask.from_json(task.to_json())


@pytest.mark.parametrize("value,want", [
    (None, True), ("1", True), ("true", True), ("yes", True), ("0", False),
    ("false", False), ("no", False), ("", True), ("maybe", True), ("off", True)])
def test_switch_parsing(tmp_path, monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("IMAGEPROCESSOR_DEVICE_JPEG", raising=False)
    else:
        monkeypatch.setenv("IMAGEPROCESSOR_DEVICE_JPEG", value)
    eng = TorchProcessingEngine(PortLocalFS(str(tmp_path)), device="cpu")
    try:
        assert eng.device_jpeg is want
        # read once, at construction
        monkeypatch.setenv("IMAGEPROCESSOR_DEVICE_JPEG", "1" if not want else "0")
        assert eng.device_jpeg is want
    finally:
        eng.close()


@pytest.mark.parametrize("keyword", [True, False])
def test_keyword_wins_over_the_variable(tmp_path, monkeypatch, keyword):
    monkeypatch.setenv("IMAGEPROCESSOR_DEVICE_JPEG", "0" if keyword else "1")
    eng = TorchProcessingEngine(PortLocalFS(str(tmp_path)), device="cpu",
                                device_jpeg=keyword)
    assert eng.device_jpeg is keyword
    eng.close()


def test_the_core_threshold_is_not_read(tmp_path, monkeypatch):
    """IMAGEPROCESSOR_DEVICE_JPEG_CORES is read, as the reference reads it:
    at 0 no host has fewer usable cores, so the auto policy keeps the
    codec on the host."""
    monkeypatch.delenv("IMAGEPROCESSOR_DEVICE_JPEG", raising=False)
    monkeypatch.setenv("IMAGEPROCESSOR_DEVICE_JPEG_CORES", "0")
    eng = TorchProcessingEngine(PortLocalFS(str(tmp_path)), device="cpu")
    assert eng.device_jpeg is False
    eng.close()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The reference and the port, each with its device codec off."""
    root = tmp_path_factory.mktemp("device_jpeg_off")
    s_ref = LocalFSObjectStore(str(root / "ref"))
    s_port = PortLocalFS(str(root / "port"))
    ref = ProcessingEngine(s_ref, device_jpeg=False, use_pallas=True,
                           pallas_interpret=True, compute_dtype="float32",
                           codec_threads=2)
    port = TorchProcessingEngine(s_port, device="cpu", codec_threads=2,
                                 device_jpeg=False)
    yield (ref, s_ref), (port, s_port)
    ref.close()
    port.close()


@pytest.fixture()
def codec_calls(monkeypatch):
    """Calls of B1's and B3's wrappers as the engine makes them."""
    calls = {"decode_coefs": 0, "encode_420": 0}
    for name in calls:
        inner = getattr(engine_mod, name)

        def counted(*a, _inner=inner, _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(engine_mod, name, counted)
    return calls


@pytest.mark.parametrize("splice", ["1", "0"], ids=["splice", "nosplice"])
@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_switch_off_keeps_the_codec_on_the_host(engines, codec_calls, monkeypatch,
                                               plan_name, splice):
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", splice)
    (ref, s_ref), (port, s_port) = engines
    ops = PLANS[plan_name]
    tasks = [make_task(ops) for _ in BLOBS]
    layout = port.decode_for_plan_ex(
        BLOBS[0], normalize_operations(to_port(tasks[0]).operations), "jpeg")[2]
    host_route = splice == "1" and plan_name in ("flip", "watermark")
    assert layout == ("splice" if host_route else "hwc")
    r_ref = ref.process_tasks(list(zip(tasks, BLOBS)))
    r_port = port.process_tasks([(to_port(t), b) for t, b in zip(tasks, BLOBS)])
    assert codec_calls == {"decode_coefs": 0, "encode_420": 0}
    for a, b in zip(r_ref, r_port):
        assert a.result.status is ImageStatus.COMPLETED, a.result.error
        assert b.result.status is port_domain.ImageStatus.COMPLETED, b.result.error
        assert a.result.processed_paths == b.result.processed_paths
        for op, path in a.result.processed_paths.items():
            x, y = s_ref.get_object(path), s_port.get_object(path)
            if host_route:
                assert x == y, path
            else:
                u, _ = decode_image(x)
                v, _ = decode_image(y)
                assert u.shape == v.shape
                assert psnr(u, v) > 45.0, path


@pytest.mark.parametrize("plan_name", ["default", "flip"])
def test_switch_on_takes_the_device_codec(tmp_path, codec_calls, monkeypatch,
                                          plan_name):
    """The control: unset, the same uploads go through B1 (and B3 for the
    flip's full-bucket JPEG rendition, splice off)."""
    monkeypatch.delenv("IMAGEPROCESSOR_DEVICE_JPEG", raising=False)
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    port = TorchProcessingEngine(PortLocalFS(str(tmp_path)), device="cpu")
    try:
        res = port.process_tasks([(to_port(make_task(PLANS[plan_name])), b)
                                  for b in BLOBS])
    finally:
        port.close()
    assert all(r.result.status is port_domain.ImageStatus.COMPLETED for r in res)
    assert codec_calls["decode_coefs"] == 3   # one group per bucket
    assert codec_calls["encode_420"] == (3 if plan_name == "flip" else 0)


@pytest.mark.parametrize("cores,on", [("1", False), ("100000", True)])
@pytest.mark.parametrize("plan_name", ["default", "flip"])
def test_the_core_threshold_decides_the_auto_policy(tmp_path, codec_calls,
                                                    monkeypatch, plan_name,
                                                    cores, on):
    """IMAGEPROCESSOR_DEVICE_JPEG unset: the device codec serves a host
    with fewer usable cores than IMAGEPROCESSOR_DEVICE_JPEG_CORES. At 1 the
    codec stays on the host (B1 and B3 are never called); at 100000 the
    same uploads go through B1, and the flip's JPEG rendition through B3
    (splice off)."""
    monkeypatch.delenv("IMAGEPROCESSOR_DEVICE_JPEG", raising=False)
    monkeypatch.setenv("IMAGEPROCESSOR_DEVICE_JPEG_CORES", cores)
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    assert engine_mod.usable_cores() < 100000
    port = TorchProcessingEngine(PortLocalFS(str(tmp_path)), device="cpu")
    try:
        assert port.device_jpeg is on
        res = port.process_tasks([(to_port(make_task(PLANS[plan_name])), b)
                                  for b in BLOBS])
    finally:
        port.close()
    assert all(r.result.status is port_domain.ImageStatus.COMPLETED for r in res)
    assert codec_calls["decode_coefs"] == (3 if on else 0)
    assert codec_calls["encode_420"] == (3 if on and plan_name == "flip" else 0)
