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
    """Every declared op type is served, so the crop task completes; an
    op whose parameters the plan refuses (a crop without a size, a
    rotate without an angle) and an undecodable upload fail PERMANENTLY,
    each alone beside batchmates that complete."""
    _, (port, s_port) = engines
    crop = make_task([OperationParams(OperationType.CROP,
                                      {"x": 0, "y": 0, "width": 8, "height": 8})])
    no_size = make_task([OperationParams(OperationType.CROP, {"x": 0, "y": 0})])
    no_angle = make_task([OperationParams(OperationType.ROTATE, {})])
    bad = make_task(DEFAULT)
    ok = make_task(DEFAULT)
    res = port.process_tasks([(to_port(crop), BLOBS[0]),
                              (to_port(bad), BLOBS[0][:400]),
                              (to_port(ok), BLOBS[0]),
                              (to_port(no_size), BLOBS[0]),
                              (to_port(no_angle), BLOBS[0])])
    status = port_domain.ImageStatus
    assert res[0].result.status is status.COMPLETED, res[0].result.error
    out, _ = decode_image(s_port.get_object(res[0].result.processed_paths["crop"]))
    assert out.shape == (8, 8, 3)
    assert res[1].result.status is status.FAILED
    assert res[1].error_kind == PERMANENT
    assert res[2].result.status is status.COMPLETED
    for r, word in ((res[3], "width and height"), (res[4], "angle")):
        assert r.result.status is status.FAILED
        assert r.error_kind == PERMANENT
        assert word in r.result.error
        assert r.artifacts == []


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


# --- crop, flip, rotate, grayscale -------------------------------------------

def _op(kind, **params):
    return OperationParams(OperationType(kind), params)


TRANSFORMS = {
    "crop_aligned": _op("crop", x=16, y=32, width=120, height=90),
    "crop_unaligned": _op("crop", x=21, y=13, width=150, height=100),
    "crop_past": _op("crop", x=200, y=200, width=2000, height=2000),
    "crop_clamped": _op("crop", x=32, y=16, width=2000, height=2000),
    "flip_h": _op("flip", direction="horizontal"),
    "flip_v": _op("flip", direction="vertical"),
    "rot90": _op("rotate", angle=90),
    "rot180": _op("rotate", angle=180),
    "rot270": _op("rotate", angle=270),
    "rot30": _op("rotate", angle=30),
    "grayscale": _op("grayscale"),
}
# served from the scanned coefficients when source and renditions are JPEGs.
# crop_past is planned for the coefficients too, but its luma origin is
# block-aligned and its MCU-rounded extent passes the bottom of the scanned
# plane, which the shared coeftx code slices short: the emitter refuses, and
# both engines fall back to the single-image op on the decoded coefficients.
COEF_SERVED = sorted(set(TRANSFORMS) - {"rot30", "grayscale", "crop_past"})


def _counter(name):
    from imageprocessor_tpu_torch.utils.metrics import METRICS
    return METRICS.snapshot()["counters"].get(name, 0)


@pytest.mark.parametrize("splice_on", [True, False], ids=["splice", "nosplice"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_plans_match_reference(engines, monkeypatch, name, splice_on):
    """One op over three JPEGs of mixed dims. With the splice on, crop,
    flip and the rotations by 90s come from the coefficients: the
    artifacts are the reference's byte for byte. Everything else runs on
    the device (B1's plain version, the op, the host or B3 encode):
    PSNR > 45 dB against the reference's artifacts, equal dims."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "1" if splice_on else "0")
    (ref, _), (port, _) = engines
    tasks = [make_task([TRANSFORMS[name]]) for _ in BLOBS]
    coef = splice_on and name in COEF_SERVED
    n0 = _counter("engine_coeftx_images")
    r_ref = ref.process_tasks(list(zip(tasks, BLOBS)))
    r_port = port.process_tasks([(to_port(t), b) for t, b in zip(tasks, BLOBS)])
    assert _counter("engine_coeftx_images") - n0 == (len(BLOBS) if coef else 0)
    kind = TRANSFORMS[name].type.value
    for a, b in zip(r_ref, r_port):
        _compare_artifacts(engines, a, b, exact_ops=(kind,) if coef else ())


@pytest.mark.parametrize("name", COEF_SERVED)
def test_coefficient_plans_skip_the_device(engines, monkeypatch, name):
    """A JPEG -> JPEG plan of coefficient-domain ops and a watermark has
    the "splice" layout: no pixels are decoded, nothing is uploaded and
    the device stage records 0 ms. Both renditions are the reference's
    bytes."""
    from imageprocessor_tpu_torch.utils.metrics import METRICS
    (ref, _), (port, _) = engines
    ops = [TRANSFORMS[name], WATERMARK]
    task = make_task(ops)
    arr, det, layout, hw, sctx = port.decode_for_plan_ex(
        BLOBS[0], port_plan(ops), "jpeg")
    assert (layout, det, hw, arr.size) == ("splice", "jpeg", (300, 400), 0)
    assert sctx is not None
    calls = []
    monkeypatch.setattr(port, "_upload", lambda *a: calls.append(a))
    METRICS.reset()
    b = port.process_tasks([(to_port(task), BLOBS[0])])[0]
    assert calls == []
    assert METRICS.snapshot()["timings"]["engine_device_ms"]["max"] == 0.0
    assert _counter("engine_coeftx_images") == 1
    assert _counter("engine_splice_images") == 1
    a = ref.process_tasks([(task, BLOBS[0])])[0]
    _compare_artifacts(engines, a, b,
                       exact_ops=(TRANSFORMS[name].type.value, "watermark"))


@pytest.mark.parametrize("why", ["format_png", "mixed_with_resize", "rot30",
                                 "splice_off", "png_source"])
def test_plans_the_coefficients_cannot_serve_take_the_device(engines, monkeypatch,
                                                            why):
    """coef_only needs every op to be a coefficient-domain type and every
    rendition to negotiate to JPEG."""
    _, (port, _) = engines
    ops, fmt, blob = [TRANSFORMS["flip_h"]], "jpeg", BLOBS[0]
    if why == "format_png":
        fmt = "png"
    elif why == "mixed_with_resize":
        ops = ops + [DEFAULT[1]]
    elif why == "rot30":
        ops = [TRANSFORMS["rot30"], TRANSFORMS["flip_v"]]
    elif why == "splice_off":
        monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    else:
        bio = io.BytesIO()
        PILImage.fromarray(photo(64, 80)).save(bio, format="PNG")
        blob = bio.getvalue()
    layout = port.decode_for_plan_ex(blob, port_plan(ops), fmt)[2]
    assert layout == ("hwc" if why == "png_source" else "coef:22")
    res = port.process_tasks([(to_port(make_task(ops, fmt=fmt)), blob)])[0]
    assert res.result.status is port_domain.ImageStatus.COMPLETED, res.result.error
    ext = ".png" if fmt == "png" else ".jpeg"
    assert all(p.endswith(ext) for p in res.result.processed_paths.values())


@pytest.mark.parametrize("kind", ["progressive", "grayscale", "restart"])
def test_transform_sources_match_reference(engines, kind):
    """Progressive, grayscale (promoted in the coefficient domain) and
    restart-marked sources through the coefficient route: the
    reference's bytes."""
    (ref, _), (port, _) = engines
    task = make_task([TRANSFORMS["rot90"], TRANSFORMS["flip_h"],
                      TRANSFORMS["crop_unaligned"]])
    blob = SPLICE_SOURCES[kind]
    assert port.decode_for_plan_ex(
        blob, normalize_operations(to_port(task).operations), "jpeg")[2] == "splice"
    a = ref.process_tasks([(task, blob)])[0]
    b = port.process_tasks([(to_port(task), blob)])[0]
    _compare_artifacts(engines, a, b, exact_ops=("rotate", "flip", "crop"))


def _png(arr):
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="PNG")
    return bio.getvalue()


def _go_gray(arr):
    x = arr.astype(np.int64) * 257
    y = ((299 * x[..., 0] + 587 * x[..., 1] + 114 * x[..., 2] + 500) // 1000) >> 8
    return np.repeat(y[..., None], 3, axis=-1).astype(np.uint8)


def _near_boundary(h, w, angle, eps=1e-3):
    """Pixels whose float64 source coordinate lies within eps of the
    validity boundary (-0.5 or dim - 0.5) of an (h, w) image rotated about
    its centre."""
    th = np.deg2rad(np.float64(angle))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy = np.arange(h, dtype=np.float64)[:, None] - cy
    dx = np.arange(w, dtype=np.float64)[None, :] - cx
    sx = np.cos(th) * dx - np.sin(th) * dy + cx
    sy = np.sin(th) * dx + np.cos(th) * dy + cy
    return ((np.abs(sx + 0.5) < eps) | (np.abs(sx - (w - 0.5)) < eps)
            | (np.abs(sy + 0.5) < eps) | (np.abs(sy - (h - 0.5)) < eps))


def _crop(arr, x, y, w, h):
    x, y = min(x, arr.shape[1] - 1), min(y, arr.shape[0] - 1)
    return arr[y:y + h, x:x + w]


PNG_EXPECT = {
    "crop_aligned": lambda a: _crop(a, 16, 32, 120, 90),
    "crop_unaligned": lambda a: _crop(a, 21, 13, 150, 100),
    "crop_past": lambda a: _crop(a, 200, 200, 2000, 2000),
    "crop_clamped": lambda a: _crop(a, 32, 16, 2000, 2000),
    "flip_h": lambda a: a[:, ::-1], "flip_v": lambda a: a[::-1],
    "rot90": lambda a: np.rot90(a, 1), "rot180": lambda a: np.rot90(a, 2),
    "rot270": lambda a: np.rot90(a, 3),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_png_device_outputs_equal_numpy(engines, name):
    """PNG in, PNG out: nothing is lossy, so the batched device route is
    held to numpy exactly on a group of mixed dims (an odd-sized image, a
    pad row: three items in a batch of four) — crop, flip and the
    rotations by 90s at 0 LSB, grayscale at 0 LSB of the reference and
    <= 1 of Go's integer formula, rotate 30 at <= 1 LSB of the reference
    off the pixels at the validity boundary."""
    (ref, s_ref), (port, s_port) = engines
    arrs = [photo(230, 310), photo(256, 320), photo(199, 257)]
    tasks = [make_task([TRANSFORMS[name]], fmt="png") for _ in arrs]
    blobs = [_png(a) for a in arrs]
    r_ref = ref.process_tasks(list(zip(tasks, blobs)))
    r_port = port.process_tasks([(to_port(t), b) for t, b in zip(tasks, blobs)])
    kind = TRANSFORMS[name].type.value
    for arr, a, b in zip(arrs, r_ref, r_port):
        assert b.result.status is port_domain.ImageStatus.COMPLETED, b.result.error
        assert a.result.processed_paths == b.result.processed_paths
        path = b.result.processed_paths[kind]
        assert path.endswith(".png")
        got, _ = decode_image(s_port.get_object(path))
        want, _ = decode_image(s_ref.get_object(path))
        assert got.shape == want.shape
        if name in PNG_EXPECT:
            np.testing.assert_array_equal(got, PNG_EXPECT[name](arr))
            np.testing.assert_array_equal(got, want)
        elif name == "grayscale":
            np.testing.assert_array_equal(got, want)
            assert np.abs(got.astype(int) - _go_gray(arr).astype(int)).max() <= 1
        else:
            mask = _near_boundary(*arr.shape[:2], 30.0)
            diff = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
            assert diff[~mask].max() <= 1
            assert mask.sum() <= 4 + mask.size // 100


ALL_SEVEN = [DEFAULT[0], DEFAULT[1], WATERMARK, TRANSFORMS["crop_unaligned"],
             TRANSFORMS["rot90"], TRANSFORMS["flip_v"], TRANSFORMS["grayscale"]]


@pytest.mark.parametrize("splice_on", [True, False], ids=["splice", "nosplice"])
def test_all_seven_ops_in_one_plan_match_reference(engines, monkeypatch, splice_on):
    """One plan with every op type on JPEGs: the resample pair through
    B2's plain version, the rest as above; with the splice on only the
    watermark leaves the device plan (the plan is not all-coefficient)."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "1" if splice_on else "0")
    (ref, _), (port, _) = engines
    tasks = [make_task(ALL_SEVEN) for _ in BLOBS]
    r_ref = ref.process_tasks(list(zip(tasks, BLOBS)))
    r_port = port.process_tasks([(to_port(t), b) for t, b in zip(tasks, BLOBS)])
    for a, b in zip(r_ref, r_port):
        assert len(b.artifacts) == 7
        _compare_artifacts(engines, a, b,
                           exact_ops=("watermark",) if splice_on else ())


def test_full_bucket_jpeg_outputs_go_through_the_encoder_kernel(engines, monkeypatch):
    """Flip and grayscale fill the bucket canvas: renditions that every
    item wants as a JPEG are encoded by kernel B3 (here its plain
    version) and emitted on the host; crop and rotate outputs have
    per-image dims and leave as pixels."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    _, (port, _) = engines
    seen = []
    inner = port._encode_coefs
    monkeypatch.setattr(port, "_encode_coefs",
                        lambda canvas, *a: seen.append(tuple(canvas.shape))
                        or inner(canvas, *a))
    ops = [TRANSFORMS["flip_h"], TRANSFORMS["grayscale"], TRANSFORMS["rot90"],
           TRANSFORMS["crop_aligned"]]
    res = port.process_tasks([(to_port(make_task(ops)), BLOBS[0])])[0]
    assert res.result.status is port_domain.ImageStatus.COMPLETED, res.result.error
    assert len(seen) == 2
    seen.clear()
    res = port.process_tasks([(to_port(make_task(ops, fmt="png")), BLOBS[0])])[0]
    assert res.result.status is port_domain.ImageStatus.COMPLETED, res.result.error
    assert seen == []


@pytest.mark.parametrize("source", ["jpeg", "png"])
def test_process_single_matches_the_batched_path(engines, source):
    """The single-image path (decode once, each op in turn; resize and
    thumbnail as one-image calls of B4's plain version) against the
    batched path on the same task, PNG renditions so nothing is lossy:
    crop, flip, rotate by 90 and grayscale equal, the resamples and the
    watermark within 1 LSB (for a JPEG source the two paths decode with
    different IDCTs, <= 1 LSB apart, before any op: every output within
    2 LSB). And against the reference's single-image path."""
    (ref, s_ref), (port, s_port) = engines
    blob = BLOBS[0] if source == "jpeg" else _png(photo(300, 400))
    t1, t2 = make_task(ALL_SEVEN, fmt="png"), make_task(ALL_SEVEN, fmt="png")
    one = port.process_single(to_port(t1), blob)
    many = port.process_tasks([(to_port(t2), blob)])[0]
    ref_one = ref.process_single(t1, blob)
    status = port_domain.ImageStatus
    assert one.result.status is status.COMPLETED, one.result.error
    assert many.result.status is status.COMPLETED, many.result.error
    assert sorted(one.result.processed_paths) == sorted(many.result.processed_paths)
    assert one.result.processed_paths == ref_one.result.processed_paths
    for kind, path in one.result.processed_paths.items():
        a, _ = decode_image(s_port.get_object(path))
        b, _ = decode_image(s_port.get_object(many.result.processed_paths[kind]))
        c, _ = decode_image(s_ref.get_object(path))
        assert a.shape == b.shape == c.shape, kind
        exact = kind in ("crop", "flip", "rotate", "grayscale")
        limit = (0 if exact else 1) if source == "png" else 2
        assert np.abs(a.astype(int) - b.astype(int)).max() <= limit, kind
        assert np.abs(a.astype(int) - c.astype(int)).max() <= max(limit, 1), kind


def test_process_single_failures(engines):
    _, (port, _) = engines
    status = port_domain.ImageStatus
    r = port.process_single(to_port(make_task(DEFAULT)), b"not an image")
    assert r.result.status is status.FAILED and r.error_kind == PERMANENT
    assert "Failed to decode image" in r.result.error
    r = port.process_single(
        to_port(make_task([_op("crop", x=1, y=1)])), BLOBS[0])
    assert r.result.status is status.FAILED and r.error_kind == PERMANENT
    assert "Operation failed" in r.result.error


def test_coefficient_route_falls_back_to_the_single_image_op(engines, monkeypatch):
    """When the coefficient transform refuses at finish time, the item is
    decoded from its scanned coefficients on the host and goes through
    the single-image op: same dims, close pixels."""
    from imageprocessor_tpu_torch.runtime import coeftx, hostcodec
    _, (port, s_port) = engines
    task = make_task([TRANSFORMS["rot90"]])
    good = port.process_tasks([(to_port(task), BLOBS[0])])[0]

    def refuse(ctx, prims):
        raise hostcodec.HostCodecError("forced")

    monkeypatch.setattr(coeftx, "apply", refuse)
    n0 = _counter("engine_coeftx_images")
    task2 = make_task([TRANSFORMS["rot90"]])
    back = port.process_tasks([(to_port(task2), BLOBS[0])])[0]
    assert back.result.status is port_domain.ImageStatus.COMPLETED, back.result.error
    assert _counter("engine_coeftx_images") == n0
    x, _ = decode_image(s_port.get_object(good.result.processed_paths["rotate"]))
    y, _ = decode_image(s_port.get_object(back.result.processed_paths["rotate"]))
    assert x.shape == y.shape == (400, 300, 3)
    assert psnr(x, y) > 40.0
