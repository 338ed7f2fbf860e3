"""TorchProcessingEngine (device="cpu": every kernel's plain version) against
the reference ProcessingEngine on the same seeded uploads.

The reference runs its device-JPEG path with the Pallas kernels in
interpret mode and float32 resampling (compute_dtype="float32"; the bf16
default is not a port target). Contracts:

* artifact paths and valid dims: equal;
* pre-encode device outputs: <= 1 LSB (decode and resample are float32 on
  both sides and differ only in summation order at rounding boundaries);
* decoded artifacts: PSNR > 45 dB — the port encodes through OpenCV
  (runtime/codecs.py), the reference through its own libjpeg shim, so
  the bytes may differ while the pixels agree closely; with the splice
  off, a watermark is encoded by kernel B3's plain version (exact fp32
  FDCT) where the reference's rounds its basis to bf16, both emitted by
  the same native code;
* spliced watermark artifacts: byte-identical — the same native splice
  code (runtime/hostcodec.py builds it without libjpeg), the same copied
  runtime/splice.py and the same font;
* GIF artifacts: equal decoded pixels — both quantize with the same
  native Plan9 code.

The seven plans the upload form produces (thumbnail, resize and
watermark flags) run with the splice on and off
(IMAGEPROCESSOR_JPEG_SPLICE, read per call).

Each engine gets tasks of its own package's domain types, made from the
same task JSON (the broker's wire format). The last test runs the port
engine inside the real service (aiohttp API + memory broker + worker
thread) through the harness of test_service_e2e; tasks and results cross
between the reference worker and the port engine as JSON.
"""

import io
import uuid

import httpx
import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu.domain import (
    ImageStatus,
    OperationParams,
    OperationType,
    ProcessingResult,
    ProcessingTask,
)
from imageprocessor_tpu.models.plan import normalize_operations as ref_normalize
from imageprocessor_tpu.runtime import engine as ref_engine
from imageprocessor_tpu.runtime import batcher as ref_batcher
from imageprocessor_tpu.runtime.codecs import decode_image
from imageprocessor_tpu.runtime.engine import ProcessingEngine
from imageprocessor_tpu.service.worker import Worker
from imageprocessor_tpu.storage import LocalFSObjectStore
from imageprocessor_tpu_torch import domain as port_domain
from imageprocessor_tpu_torch.models.plan import normalize_operations
from imageprocessor_tpu_torch.runtime import batcher as port_batcher
from imageprocessor_tpu_torch.runtime.engine import (
    PERMANENT,
    TorchProcessingEngine,
)
from imageprocessor_tpu_torch.storage import LocalFSObjectStore as PortLocalFS
from tests import test_service_e2e
from tests.oracle import psnr
from tests.test_service_e2e import ServerHarness, wait_status

RNG = np.random.default_rng(77)

DEFAULT = [OperationParams(OperationType.THUMBNAIL, {"size": 200, "crop_to_fit": True}),
           OperationParams(OperationType.RESIZE,
                           {"width": 1024, "height": 768, "keep_aspect": True})]
DOWNSCALE = [OperationParams(OperationType.THUMBNAIL, {"size": 64, "crop_to_fit": True}),
             OperationParams(OperationType.RESIZE,
                             {"width": 128, "height": 96, "keep_aspect": True})]
PLANS = {"default": DEFAULT, "downscale": DOWNSCALE}
WATERMARK = OperationParams(OperationType.WATERMARK, {
    "text": "© ImageProcessor", "opacity": 0.5, "position": "bottom-right"})
# the upload form's flags -> its plans (service/handlers.py
# parse_operations_from_form; no flag at all is the DEFAULT pair)
FORM_PLANS = {flags: [op for flag, op in zip("trw", (*DEFAULT, WATERMARK))
                      if flag in flags]
              for flags in ("t", "r", "w", "tr", "tw", "rw", "trw")}


def photo(h, w):
    yy = np.linspace(0, 150, h)[:, None, None]
    xx = np.linspace(0, 70, w)[None, :, None]
    return np.clip(yy + xx + RNG.integers(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def jpeg_bytes(h, w, subsampling=2):
    bio = io.BytesIO()
    PILImage.fromarray(photo(h, w)).save(bio, format="JPEG", quality=90,
                                         subsampling=subsampling)
    return bio.getvalue()


def make_task(ops, fmt="jpeg"):
    return ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                          original_path="original/x.jpg", bucket="images",
                          operations=ops, format=fmt)


def to_port(task):
    """The same task in the port's domain types, through its JSON."""
    return port_domain.ProcessingTask.from_json(task.to_json())


def port_plan(ops):
    return normalize_operations(to_port(make_task(ops)).operations)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine")
    s_ref = LocalFSObjectStore(str(root / "ref"))
    s_port = PortLocalFS(str(root / "port"))
    ref = ProcessingEngine(s_ref, device_jpeg=True, use_pallas=True,
                           pallas_interpret=True, compute_dtype="float32",
                           codec_threads=2)
    port = TorchProcessingEngine(s_port, device="cpu", codec_threads=2)
    yield (ref, s_ref), (port, s_port)
    ref.close()
    port.close()


BLOBS = [jpeg_bytes(300, 400), jpeg_bytes(250, 330), jpeg_bytes(380, 260)]


def _device_outputs(engine, normalize, batcher, tasks, blobs):
    items = []
    for i, (task, blob) in enumerate(zip(tasks, blobs)):
        plan = normalize(task.operations)
        arr, _det, layout, hw, sctx = engine.decode_for_plan_ex(blob, plan, "jpeg")
        items.append(batcher.BatchItem(item_id=str(i), image=arr,
                                       plan_key=plan.group_key(),
                                       payload=(i, task, "jpeg", plan),
                                       layout=layout, valid_hw=hw, splice=sctx))
    groups = batcher.group_items(items)
    return groups, [engine.device_group(g) for g in groups]


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_device_outputs_match_reference(engines, plan_name):
    (ref, _), (port, _) = engines
    tasks = [make_task(PLANS[plan_name]) for _ in BLOBS]
    g_ref, o_ref = _device_outputs(ref, ref_normalize, ref_batcher, tasks, BLOBS)
    g_port, o_port = _device_outputs(port, normalize_operations, port_batcher,
                                     [to_port(t) for t in tasks], BLOBS)
    assert [g.layout for g in g_port] == [g.layout for g in g_ref] == ["coef:22"] * 3
    for gr, gp, (plan, outs_r, hws_r, _), (_, outs_p, hws_p, _) in zip(
            g_ref, g_port, o_ref, o_port):
        assert sorted(hws_r) == sorted(hws_p)
        for oi, op in enumerate(plan.ops):
            for i in range(len(gr.items)):
                if oi in hws_r:
                    oh, ow = hws_r[oi][i]
                    assert tuple(hws_p[oi][i]) == (oh, ow)
                    a, b = outs_r[oi][i][:, :oh, :ow], outs_p[oi][i][:, :oh, :ow]
                else:
                    a, b = outs_r[oi][i], outs_p[oi][i]
                assert a.shape == b.shape
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, op.type


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_artifacts_match_reference(engines, plan_name):
    (ref, s_ref), (port, s_port) = engines
    tasks = [make_task(PLANS[plan_name]) for _ in BLOBS]
    r_ref = ref.process_tasks(list(zip(tasks, BLOBS)))
    r_port = port.process_tasks([(to_port(t), b) for t, b in zip(tasks, BLOBS)])
    for a, b in zip(r_ref, r_port):
        assert a.result.status is ImageStatus.COMPLETED, a.result.error
        assert b.result.status is port_domain.ImageStatus.COMPLETED, b.result.error
        assert a.result.processed_paths == b.result.processed_paths
        assert [(x.operation, x.path, x.mime_type, x.format) for x in a.artifacts] \
            == [(x.operation, x.path, x.mime_type, x.format) for x in b.artifacts]
        for path in a.result.processed_paths.values():
            x, _ = decode_image(s_ref.get_object(path))
            y, _ = decode_image(s_port.get_object(path))
            assert x.shape == y.shape
            assert psnr(x, y) > 45.0, path


@pytest.mark.parametrize("subsampling,layout", [(0, "coef:11"), (1, "coef:12")])
def test_other_subsamplings_match_reference(engines, subsampling, layout):
    (ref, s_ref), (port, s_port) = engines
    blob = jpeg_bytes(200, 260, subsampling=subsampling)
    assert port.decode_for_plan_ex(blob, port_plan(DOWNSCALE))[2] == layout
    task = make_task(DOWNSCALE)
    a = ref.process_tasks([(task, blob)])[0]
    b = port.process_tasks([(to_port(task), blob)])[0]
    assert b.result.status is port_domain.ImageStatus.COMPLETED, b.result.error
    for path in a.result.processed_paths.values():
        x, _ = decode_image(s_ref.get_object(path))
        y, _ = decode_image(s_port.get_object(path))
        assert psnr(x, y) > 45.0


def test_png_source_takes_pixel_path(engines):
    (ref, s_ref), (port, s_port) = engines
    bio = io.BytesIO()
    PILImage.fromarray(photo(150, 210)).save(bio, format="PNG")
    blob = bio.getvalue()
    assert port.decode_for_plan_ex(blob, port_plan(DOWNSCALE))[2] == "hwc"
    task = make_task(DOWNSCALE, fmt="png")
    a = ref.process_tasks([(task, blob)])[0]
    b = port.process_tasks([(to_port(task), blob)])[0]
    assert b.result.status is port_domain.ImageStatus.COMPLETED, b.result.error
    assert a.result.processed_paths == b.result.processed_paths
    for path in b.result.processed_paths.values():
        assert path.endswith(".png")
        x, _ = decode_image(s_ref.get_object(path))
        y, _ = decode_image(s_port.get_object(path))
        assert np.abs(x.astype(int) - y.astype(int)).max() <= 1


def test_unsupported_and_undecodable_fail_permanently(engines):
    _, (port, _) = engines
    crop = make_task([OperationParams(OperationType.CROP,
                                      {"x": 0, "y": 0, "width": 8, "height": 8})])
    bad = make_task(DEFAULT)
    ok = make_task(DEFAULT)
    res = port.process_tasks([(to_port(crop), BLOBS[0]),
                              (to_port(bad), BLOBS[0][:400]),
                              (to_port(ok), BLOBS[0])])
    status = port_domain.ImageStatus
    assert res[0].result.status is status.FAILED
    assert res[0].error_kind == PERMANENT
    assert "crop" in res[0].result.error
    assert res[1].result.status is status.FAILED
    assert res[1].error_kind == PERMANENT
    assert res[2].result.status is status.COMPLETED


def test_worker_steps_with_the_ports_service_pieces(tmp_path):
    """chip_smoke.py's main-path phase on the CPU: the port's own broker,
    stores and domain types around its engine."""
    from imageprocessor_tpu_torch.broker import MemoryBroker
    from imageprocessor_tpu_torch.storage import SQLiteMetadataStore

    d = port_domain
    store = PortLocalFS(str(tmp_path / "objects"))
    meta = SQLiteMetadataStore(str(tmp_path / "meta.db"))
    broker = MemoryBroker()
    broker.create_topic(d.KAFKA_TOPIC_PROCESSING, 3)
    ops = to_port(make_task(DEFAULT)).operations
    ids = []
    for k, blob in enumerate(BLOBS):
        path = store.save_original(f"u{k}.jpg", blob, "image/jpeg")
        image_id = str(uuid.uuid4())
        meta.save_image(d.Image(id=image_id, original_filename=f"u{k}.jpg",
                                original_size=len(blob), mime_type="image/jpeg",
                                status=d.ImageStatus.PROCESSING,
                                original_path=path, bucket="images"))
        task = d.ProcessingTask(id=str(uuid.uuid4()), image_id=image_id,
                                original_path=path, bucket="images",
                                operations=ops, format="jpeg")
        broker.produce(d.KAFKA_TOPIC_PROCESSING, image_id.encode(), task.to_json())
        ids.append(image_id)
    msgs = broker.poll(d.KAFKA_TOPIC_PROCESSING, d.KAFKA_GROUP_ID,
                       max_n=len(BLOBS), lease_s=60)
    tasks = [d.ProcessingTask.from_json(m.value) for m in msgs]
    engine = TorchProcessingEngine(store, device="cpu", batch_size=4)
    try:
        results = engine.process_tasks(
            [(t, store.get_object(t.original_path)) for t in tasks])
    finally:
        engine.close()
    for msg, task, res in zip(msgs, tasks, results):
        for art in res.artifacts:
            meta.save_processed_image(d.ProcessedImage(
                id="", image_id=task.image_id, operation=art.operation,
                path=art.path, size=art.size, mime_type=art.mime_type,
                format=art.format, status="completed"))
        meta.update_status(task.image_id, res.result.status)
        assert broker.ack(msg)
    for image_id in ids:
        assert meta.get_image(image_id).status is d.ImageStatus.COMPLETED
        assert ({p.operation for p in meta.list_processed(image_id)}
                == {d.OperationType.THUMBNAIL, d.OperationType.RESIZE})
    assert broker.depth(d.KAFKA_TOPIC_PROCESSING, d.KAFKA_GROUP_ID) == 0
    meta.close()


class WireEngine:
    """The port engine behind a reference worker. Tasks and results cross
    as JSON, since each package has its own copy of the domain types."""

    def __init__(self, engine: TorchProcessingEngine):
        self.engine = engine

    def process_tasks(self, tasks_with_data, device_section=None):
        results = self.engine.process_tasks(
            [(to_port(task), data) for task, data in tasks_with_data],
            device_section=device_section)
        return [ref_engine.EngineResult(
            result=ProcessingResult.from_json(r.result.to_json()),
            artifacts=[ref_engine.Artifact(**vars(a)) for a in r.artifacts],
            error_kind=r.error_kind) for r in results]

    def close(self):
        self.engine.close()


def test_service_with_injected_port_engine(tmp_path, monkeypatch):
    def worker_with_port_engine(cfg, *, meta, store, broker):
        engine = TorchProcessingEngine(store, device="cpu", batch_size=4)
        return Worker(cfg, meta=meta, store=store, broker=broker,
                      engine=WireEngine(engine))

    monkeypatch.setattr(test_service_e2e, "Worker", worker_with_port_engine)
    h = ServerHarness(tmp_path)
    assert isinstance(h.worker.engine, WireEngine)
    url = h.start()
    try:
        with httpx.Client(timeout=30) as c:
            r = c.post(f"{url}/api/images/upload",
                       files={"file": ("p.jpg", jpeg_bytes(300, 400), "image/jpeg")})
            assert r.status_code == 202, r.text
            image_id = r.json()["id"]
            wait_status(c, url, image_id, timeout=120)
            r = c.get(f"{url}/api/images/{image_id}", params={"operation": "thumbnail"})
            assert r.status_code == 200
            assert PILImage.open(io.BytesIO(r.content)).size == (200, 200)
            r = c.get(f"{url}/api/images/{image_id}", params={"operation": "resize"})
            assert r.status_code == 200
            assert PILImage.open(io.BytesIO(r.content)).size == (1024, 768)
            assert r.headers["Content-Type"] == "image/jpeg"
    finally:
        h.stop()
        h._worker_thread.join(timeout=10)
        h.worker.close()


def _compare_artifacts(engines, a, b, exact_ops=()):
    """Paths equal; ops in exact_ops byte-identical, the rest PSNR > 45."""
    (ref, s_ref), (port, s_port) = engines
    assert a.result.status is ImageStatus.COMPLETED, a.result.error
    assert b.result.status is port_domain.ImageStatus.COMPLETED, b.result.error
    assert a.result.processed_paths == b.result.processed_paths
    for op, path in a.result.processed_paths.items():
        x, y = s_ref.get_object(path), s_port.get_object(path)
        if op in exact_ops:
            assert x == y, path
        else:
            u, _ = decode_image(x)
            v, _ = decode_image(y)
            assert u.shape == v.shape
            assert psnr(u, v) > 45.0, path


@pytest.mark.parametrize("splice_on", [True, False], ids=["splice", "nosplice"])
@pytest.mark.parametrize("flags", sorted(FORM_PLANS))
def test_form_plans_match_reference(engines, monkeypatch, flags, splice_on):
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "1" if splice_on else "0")
    (ref, _), (port, _) = engines
    tasks = [make_task(FORM_PLANS[flags]) for _ in BLOBS]
    r_ref = ref.process_tasks(list(zip(tasks, BLOBS)))
    r_port = port.process_tasks([(to_port(t), b) for t, b in zip(tasks, BLOBS)])
    for a, b in zip(r_ref, r_port):
        _compare_artifacts(engines, a, b,
                           exact_ops=("watermark",) if splice_on else ())


def _wm_task(fmt="jpeg", **params):
    return make_task([OperationParams(OperationType.WATERMARK, {
        "text": "hi mark", "opacity": 0.5, "position": "bottom-right",
        **params})], fmt=fmt)


def _splice_sources():
    arr = photo(320, 448)
    out = {}
    for name, save in (("progressive", {"progressive": True}), ("baseline", {})):
        bio = io.BytesIO()
        PILImage.fromarray(arr).save(bio, format="JPEG", quality=90, **save)
        out[name] = bio.getvalue()
    from imageprocessor_tpu.runtime import nativecodec
    planes, qt, (w, h), samp = nativecodec.scan_jpeg_coefficients(out["baseline"])
    out["restart"] = nativecodec.emit_jpeg_from_coefficients(
        planes, qt, w, h, samp[0], restart_interval=6)
    bio = io.BytesIO()
    PILImage.fromarray(arr[:, :, 0], mode="L").save(bio, format="JPEG", quality=88)
    out["grayscale"] = bio.getvalue()
    return out


SPLICE_SOURCES = _splice_sources()


@pytest.mark.parametrize("kind", sorted(SPLICE_SOURCES))
def test_splice_sources_match_reference(engines, kind):
    """Progressive (coefficient re-encode), restart-marked, grayscale
    (promoted in the coefficient domain) and two-watermark renditions:
    byte-identical to the reference's, the bits outside the band kept."""
    (ref, _), (port, s_port) = engines
    blob = SPLICE_SOURCES[kind]
    task = _wm_task()
    if kind == "baseline":   # two watermark ops: independent renditions
        task.operations.append(OperationParams(OperationType.WATERMARK, {
            "text": "second", "opacity": 0.5, "position": "top-left"}))
    a = ref.process_tasks([(task, blob)])[0]
    b = port.process_tasks([(to_port(task), blob)])[0]
    _compare_artifacts(engines, a, b, exact_ops=("watermark",))
    got = np.asarray(PILImage.open(io.BytesIO(
        s_port.get_object(b.result.processed_paths["watermark"]))).convert("RGB"))
    src = np.asarray(PILImage.open(io.BytesIO(blob)).convert("RGB"))
    rows = slice(96, None) if kind == "baseline" else slice(0, 256)
    np.testing.assert_array_equal(got[rows], src[rows])


def test_png_output_and_png_source_never_splice(engines):
    """format=png forces the PNG encoder after the device blend; a PNG
    source takes the pixel path (device blend, then B3 for its JPEG
    rendition) beside a spliced JPEG in the same call."""
    (ref, _), (port, _) = engines
    arr = photo(200, 264)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="PNG")
    png = bio.getvalue()
    jpg = jpeg_bytes(200, 264)
    tasks = [_wm_task(fmt="png"), _wm_task(), _wm_task(fmt="png")]
    blobs = [jpg, png, png]
    r_ref = ref.process_tasks(list(zip(tasks, blobs)))
    r_port = port.process_tasks([(to_port(t), b) for t, b in zip(tasks, blobs)])
    for a, b in zip(r_ref, r_port):
        _compare_artifacts(engines, a, b)
    assert r_port[0].result.processed_paths["watermark"].endswith(".png")
    assert r_port[1].result.processed_paths["watermark"].endswith(".jpeg")


def test_gif_source_outputs_match_reference(engines):
    """GIF outputs go through the same native Plan9 quantizer as the
    reference's, so they decode to the same pixels; a GIF source's
    watermark is re-encoded as JPEG (watermark.go)."""
    (ref, s_ref), (port, s_port) = engines
    bio = io.BytesIO()
    PILImage.fromarray(photo(150, 210)).save(bio, format="GIF")
    blob = bio.getvalue()
    task = make_task([DOWNSCALE[0], WATERMARK], fmt="gif")
    a = ref.process_tasks([(task, blob)])[0]
    b = port.process_tasks([(to_port(task), blob)])[0]
    _compare_artifacts(engines, a, b)
    path = b.result.processed_paths["thumbnail"]
    assert path.endswith(".gif")
    x, _ = decode_image(s_ref.get_object(path))
    y, _ = decode_image(s_port.get_object(path))
    np.testing.assert_array_equal(x, y)
    assert b.result.processed_paths["watermark"].endswith(".jpeg")


def test_watermark_only_splice_group_skips_the_device(engines, monkeypatch):
    """A splice-served watermark-only group never packs (its placeholder
    has no pixels) and launches nothing."""
    _, (port, _) = engines
    calls = []
    monkeypatch.setattr(port, "_upload", lambda *a: calls.append(a))
    res = port.process_tasks([(to_port(_wm_task()), b) for b in BLOBS])
    assert all(r.result.status is port_domain.ImageStatus.COMPLETED for r in res)
    assert calls == []
