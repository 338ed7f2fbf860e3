"""The port's queue workers (service/worker.py, service/pipelined.py on
TorchProcessingEngine, device="cpu") against the reference's on the same
seeded uploads.

One scenario — the seven plans of the upload form on a 300x400 JPEG, the
default plan on a 97x131 PNG, a truncated JPEG and an upload whose blob
is deleted before the worker sees it — goes through
``ImageUsecase.upload_image`` -> MemoryBroker -> worker in each package,
once under the batch ``Worker`` and once under ``PipelinedWorker``. The
reference engine runs as in tests/test_torch_engine.py (device JPEG,
interpret-mode Pallas, float32). Contracts:

* image statuses, processed rows (operation, path, mime, format), the
  results-topic JSON (apart from ids and timestamps), the ``worker_*``
  counters and the queue depth left behind: equal;
* artifacts: a spliced watermark is byte-identical (the same native
  splice code on both sides); a PNG artifact decodes to within 1 LSB; any
  other JPEG artifact decodes to PSNR > 45 dB (the port encodes through
  OpenCV, the reference through its libjpeg shim).

The rest holds the port's workers to the failure policy that
tests/test_usecase_worker.py, tests/test_pipelined_worker.py and
tests/test_service_extras.py hold the reference's to: permanent failures
acked, transient ones nacked and redelivered, a device error never a
permanent failure, every inflight permit released on every failure
branch, a lone item flushed by the batcher's deadline.
"""

import io
import json
import threading
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

import imageprocessor_tpu.broker.memory as ref_memory
import imageprocessor_tpu.config as ref_config
import imageprocessor_tpu.domain as ref_domain
import imageprocessor_tpu.service.pipelined as ref_pipelined
import imageprocessor_tpu.service.usecase as ref_usecase
import imageprocessor_tpu.service.worker as ref_worker
import imageprocessor_tpu.storage as ref_storage
import imageprocessor_tpu.utils as ref_utils
import imageprocessor_tpu.utils.metrics as ref_metrics
import imageprocessor_tpu_torch.broker.memory as port_memory
import imageprocessor_tpu_torch.config as port_config
import imageprocessor_tpu_torch.domain as port_domain
import imageprocessor_tpu_torch.service.pipelined as port_pipelined
import imageprocessor_tpu_torch.service.usecase as port_usecase
import imageprocessor_tpu_torch.service.worker as port_worker
import imageprocessor_tpu_torch.storage as port_storage
import imageprocessor_tpu_torch.utils as port_utils
import imageprocessor_tpu_torch.utils.metrics as port_metrics
from imageprocessor_tpu.runtime.codecs import decode_image
from imageprocessor_tpu.runtime.engine import ProcessingEngine
from tests.oracle import psnr

REF = types.SimpleNamespace(
    name="ref", memory=ref_memory, config=ref_config, domain=ref_domain,
    pipelined=ref_pipelined, usecase=ref_usecase, worker=ref_worker,
    storage=ref_storage, utils=ref_utils, metrics=ref_metrics.METRICS)
PORT = types.SimpleNamespace(
    name="port", memory=port_memory, config=port_config, domain=port_domain,
    pipelined=port_pipelined, usecase=port_usecase, worker=port_worker,
    storage=port_storage, utils=port_utils, metrics=port_metrics.METRICS)

WORKERS = ["batch", "pipelined"]
JOIN_S = 30          # every wait on a worker thread is bounded
WAIT_S = 90


def worker_class(pkg, kind):
    return pkg.worker.Worker if kind == "batch" else pkg.pipelined.PipelinedWorker


def photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 150, h)[:, None, None]
    xx = np.linspace(0, 70, w)[None, :, None]
    return np.clip(yy + xx + rng.integers(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def encoded(h, w, seed, fmt, **save):
    bio = io.BytesIO()
    PILImage.fromarray(photo(h, w, seed)).save(bio, format=fmt, **save)
    return bio.getvalue()


JPEG = encoded(300, 400, 5, "JPEG", quality=90)
PNG = encoded(97, 131, 6, "PNG")
SMALL_PNG = encoded(64, 80, 7, "PNG")


def form_ops(domain, flags):
    """The upload form's plans (service/handlers.py): t, r, w flags."""
    P, T = domain.OperationParams, domain.OperationType
    ops = {"t": P(T.THUMBNAIL, {"size": 200, "crop_to_fit": True}),
           "r": P(T.RESIZE, {"width": 1024, "height": 768, "keep_aspect": True}),
           "w": P(T.WATERMARK, {"text": "© ImageProcessor", "opacity": 0.5,
                                "position": "bottom-right"})}
    return [ops[f] for f in flags]


def thumb_ops(domain, size=32):
    return [domain.OperationParams(domain.OperationType.THUMBNAIL,
                                   {"size": size, "crop_to_fit": True})]


# name -> (blob, filename, content type, form flags, what happens to the blob)
UPLOADS = {
    **{f"jpeg-{flags}": (JPEG, f"{flags}.jpg", "image/jpeg", flags, None)
       for flags in ("t", "r", "w", "tr", "tw", "rw", "trw")},
    "png": (PNG, "p.png", "image/png", "tr", None),
    "truncated": (JPEG[:600], "cut.jpg", "image/jpeg", "tr", None),
    "deleted": (JPEG, "gone.jpg", "image/jpeg", "tr", "delete"),
}


class Stack:
    """One package's usecase, stores, broker and worker."""

    def __init__(self, pkg, kind, root, engine=None, env=None, **worker_cfg):
        self.pkg = pkg
        self.cfg = pkg.config.load({"DEVICE_PLATFORM": "cpu", **(env or {})})
        self.cfg.worker.batch_size = 4
        self.cfg.worker.batch_deadline_ms = 30
        self.cfg.retries_attempts = 1
        for key, value in worker_cfg.items():
            setattr(self.cfg.worker, key, value)
        self.meta = pkg.storage.SQLiteMetadataStore(":memory:")
        self.store = pkg.storage.LocalFSObjectStore(str(root / "objects"))
        self.broker = pkg.memory.MemoryBroker()
        self.uc = pkg.usecase.ImageUsecase(
            self.meta, self.store, self.broker,
            retries=pkg.utils.RetryStrategy(attempts=1, delay_ms=1))
        self.kind = kind
        self.worker = worker_class(pkg, kind)(
            self.cfg, meta=self.meta, store=self.store, broker=self.broker,
            **({"engine": engine(self.store)} if engine else {}))
        self.worker._idle_sleep = 0.01
        self.group = self.cfg.broker.group_id
        self.topic = self.cfg.broker.processing_topic
        self._thread = None

    def depth(self):
        return self.broker.depth(self.topic, self.group)

    def status(self, image_id):
        return self.meta.get_image(image_id).status.value

    def start(self):
        """The pipelined worker streams on its own thread."""
        if self.kind == "pipelined" and self._thread is None:
            self._thread = threading.Thread(target=self.worker.run, daemon=True)
            self._thread.start()

    def until(self, done, why):
        """The batch worker polls here; the pipelined one streams on its
        thread. Either way the wait is bounded."""
        self.start()

        def step():
            if self.kind == "batch" and not done():
                self.worker.run_once()
            return done()

        wait_for(step, f"{self.pkg.name}/{self.kind}: {why}")

    def drive(self, ids, settled=("completed", "failed")):
        """Run the worker until every image has settled."""
        self.until(lambda: all(self.status(i) in settled for i in ids),
                    "images never settled")

    def drain(self):
        """Run the worker until nothing is left unacked."""
        self.until(lambda: self.depth() == 0, "messages left unacked")

    def stop(self):
        self.worker.stop()
        if self._thread is not None:
            self._thread.join(timeout=JOIN_S)
            assert not self._thread.is_alive(), "worker thread did not stop"
            self._thread = None

    def close(self):
        self.stop()
        self.worker.engine.close()


def wait_for(fn, why="condition never held", timeout=WAIT_S, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(interval)
    raise AssertionError(why)


def ref_engine(store):
    return ProcessingEngine(store, device_jpeg=True, use_pallas=True,
                            pallas_interpret=True, compute_dtype="float32",
                            codec_threads=2)


def run_scenario(pkg, kind, root, engine=None):
    """Upload everything, run the worker dry, and collect what it left."""
    pkg.metrics.reset()
    stack = Stack(pkg, kind, root, engine=engine)
    ids = {}
    for name, (blob, filename, ctype, flags, fate) in UPLOADS.items():
        img = stack.uc.upload_image(blob, filename, ctype,
                                    form_ops(pkg.domain, flags))
        if fate == "delete":
            stack.store.delete_object(img.original_path)
        ids[name] = img.id
    stack.drive(ids.values())
    stack.drain()
    stack.stop()
    names = {image_id: name for name, image_id in ids.items()}

    def anon(text):
        for image_id, name in names.items():
            text = text.replace(image_id, f"<{name}>")
        return text

    results = {}
    while True:
        msgs = stack.broker.poll(stack.cfg.broker.results_topic, "observer",
                                 max_n=64)
        if not msgs:
            break
        for m in msgs:
            body = json.loads(anon(m.value.decode()
                                   if isinstance(m.value, bytes) else m.value))
            name = body.pop("ImageID").strip("<>")
            body.pop("ID")
            body.pop("ProcessedAt", None)
            results[name] = body
    out = types.SimpleNamespace(
        stack=stack,
        statuses={name: stack.status(i) for name, i in ids.items()},
        rows={name: sorted((r.operation.value, anon(r.path), r.mime_type, r.format)
                           for r in stack.meta.list_processed(i))
              for name, i in ids.items()},
        blobs={name: {r.operation.value: stack.store.get_object(r.path)
                      for r in stack.meta.list_processed(i)}
               for name, i in ids.items()},
        results=results,
        counters={k: v for k, v in pkg.metrics.snapshot()["counters"].items()
                  if k.startswith("worker_")},
        depth=stack.depth())
    stack.worker.engine.close()
    return out


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_worker")
    out = {}
    for kind in WORKERS:
        for pkg in (REF, PORT):
            d = root / f"{pkg.name}-{kind}"
            d.mkdir()
            out[pkg.name, kind] = run_scenario(
                pkg, kind, d, engine=ref_engine if pkg is REF else None)
    return out


@pytest.mark.parametrize("kind", WORKERS)
def test_statuses_rows_and_counters_match_reference(scenarios, kind):
    ref, port = scenarios["ref", kind], scenarios["port", kind]
    want = {name: "completed" for name in UPLOADS}
    want.update(truncated="failed", deleted="failed")
    assert port.statuses == ref.statuses == want
    assert port.rows == ref.rows
    assert [(op, mime, fmt) for op, _path, mime, fmt in port.rows["jpeg-trw"]] \
        == [(op, "image/jpeg", "jpeg") for op in ("resize", "thumbnail", "watermark")]
    assert port.rows["jpeg-trw"][0][1] == "processed/resize/<jpeg-trw>/1024x768.jpeg"
    assert [fmt for *_, fmt in port.rows["png"]] == ["png", "png"]
    assert port.rows["truncated"] == port.rows["deleted"] == []
    assert port.counters == ref.counters
    assert port.counters["worker_completed"] == 8
    assert port.counters["worker_failed_permanent"] == 1
    assert port.counters["worker_fetch_missing"] == 1
    assert port.depth == ref.depth == 0


@pytest.mark.parametrize("kind", WORKERS)
def test_results_topic_json_matches_reference(scenarios, kind):
    ref, port = scenarios["ref", kind], scenarios["port", kind]
    # the deleted blob fails before the engine: status only, no result
    assert sorted(port.results) == sorted(ref.results) \
        == sorted(set(UPLOADS) - {"deleted"})
    assert port.results == ref.results
    assert port.results["jpeg-t"]["Status"] == "completed"
    assert port.results["truncated"]["Status"] == "failed"
    assert port.results["truncated"]["Error"].startswith("Failed to decode image")


@pytest.mark.parametrize("kind", WORKERS)
@pytest.mark.parametrize("name", [n for n in UPLOADS
                                  if n not in ("truncated", "deleted")])
def test_artifacts_match_reference(scenarios, kind, name):
    ref, port = scenarios["ref", kind].blobs[name], scenarios["port", kind].blobs[name]
    assert sorted(port) == sorted(ref) and port
    for op in ref:
        if op == "watermark":        # spliced: shared native code
            assert port[op] == ref[op]
            continue
        a, fa = decode_image(ref[op])
        b, fb = decode_image(port[op])
        assert fa == fb and a.shape == b.shape
        if fa == "png":
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            assert psnr(a, b) > 45.0


@pytest.mark.parametrize("name", [n for n in UPLOADS
                                  if n not in ("truncated", "deleted")])
def test_both_port_workers_write_the_same_bytes(scenarios, name):
    """On the CPU the two workers run the same plain versions and the same
    host code on each image, so their artifacts are byte-identical."""
    assert scenarios["port", "batch"].blobs[name] \
        == scenarios["port", "pipelined"].blobs[name]


# ------------------------------------------------ the failure policy (port)

@pytest.fixture(params=WORKERS)
def stack(request, tmp_path):
    PORT.metrics.reset()
    s = Stack(PORT, request.param, tmp_path)
    yield s
    s.close()


def upload(stack, blob=SMALL_PNG, name="a.png", ops=None):
    return stack.uc.upload_image(blob, name, "image/png",
                                 ops or thumb_ops(stack.pkg.domain))


def counters():
    return PORT.metrics.snapshot()["counters"]


def permits_restored(worker):
    """Every inflight permit of a pipelined worker is back."""
    if not hasattr(worker, "_inflight"):
        return True
    depth = max(worker.cfg.worker.max_queue_depth, 8)
    n = 0
    while worker._inflight.acquire(blocking=False):
        n += 1
    for _ in range(n):
        worker._inflight.release()
    return n == depth


def test_upload_completes_and_is_acked(stack):
    img = upload(stack)
    stack.drive([img.id])
    assert stack.status(img.id) == "completed"
    rows = stack.meta.list_processed(img.id)
    assert [r.operation for r in rows] == [port_domain.OperationType.THUMBNAIL]
    assert stack.store.get_object(rows[0].path)
    stack.drain()
    res = stack.broker.poll("image-processed", "observer", max_n=4)
    assert len(res) == 1
    result = port_domain.ProcessingResult.from_json(res[0].value)
    assert result.image_id == img.id
    assert result.status is port_domain.ImageStatus.COMPLETED
    wait_for(lambda: permits_restored(stack.worker))


def test_malformed_and_good_interleaved(stack):
    stack.broker.produce(stack.topic, b"x", b"{not json")
    good = upload(stack)
    stack.broker.produce(stack.topic, b"y", b'{"ID": "t", "ImageID": ""}')
    stack.drive([good.id])
    assert stack.status(good.id) == "completed"
    stack.drain()
    assert counters()["worker_malformed_tasks"] == 2
    wait_for(lambda: permits_restored(stack.worker))


def test_undecodable_blob_fails_permanently(stack):
    img = upload(stack)
    stack.store.save_processed(img.original_path, b"corrupted not an image")
    stack.drive([img.id])
    assert stack.status(img.id) == "failed"
    stack.drain()        # acked
    assert counters()["worker_failed_permanent"] == 1
    wait_for(lambda: permits_restored(stack.worker))


def test_missing_blob_fails_permanently(stack):
    img = upload(stack)
    stack.store.delete_object(img.original_path)
    stack.drive([img.id])
    assert stack.status(img.id) == "failed"
    stack.drain()        # acked: can never succeed
    assert counters()["worker_fetch_missing"] == 1
    wait_for(lambda: permits_restored(stack.worker))


def test_transient_fetch_failure_nacks(stack):
    img = upload(stack)
    orig = stack.store.get_object

    def unreachable(path):
        raise OSError("storage unreachable")

    stack.store.get_object = unreachable
    stack.drive([img.id], settled=("failed",))
    wait_for(lambda: counters().get("worker_fetch_failures", 0) >= 1)
    stack.stop()
    stack.store.get_object = orig
    assert stack.depth() == 1                   # nacked: still deliverable
    assert permits_restored(stack.worker)


def test_invalid_params_fail_permanently(stack):
    d = port_domain
    img = upload(stack, ops=[d.OperationParams(d.OperationType.ROTATE, {})])
    stack.drive([img.id])
    assert stack.status(img.id) == "failed"
    stack.drain()
    assert counters()["worker_failed_permanent"] == 1
    wait_for(lambda: permits_restored(stack.worker))


def test_non_string_format_fails_without_permit_leak(stack):
    img = upload(stack)
    stack.drive([img.id])
    raw = {"ID": "t-badfmt", "ImageID": img.id,
           "OriginalPath": img.original_path, "Bucket": "images",
           "Operations": [{"Type": "thumbnail", "Parameters": {"size": 32}}],
           "Format": 5}
    stack.broker.produce(stack.topic, img.id.encode(), json.dumps(raw).encode())
    stack.drive([img.id], settled=("failed",))
    stack.drain()        # permanent: acked
    wait_for(lambda: permits_restored(stack.worker))


def test_device_error_is_transient_and_redelivered(stack):
    """A CUDA fault surfaces as a torch RuntimeError out of device_group:
    the micro-batch is nacked and the redelivery completes."""
    engine = stack.worker.engine
    real = engine.device_group
    calls = []

    def boom(group):
        calls.append(len(group.items))
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    engine.device_group = boom
    img = upload(stack)
    stack.drive([img.id], settled=("failed",))
    wait_for(lambda: counters().get("worker_failed_transient", 0) >= 1)
    engine.device_group = real
    assert calls
    assert "worker_failed_permanent" not in counters()
    stack.drive([img.id], settled=("completed",))   # the redelivery
    stack.drain()
    assert stack.status(img.id) == "completed"
    wait_for(lambda: permits_restored(stack.worker))


def test_storage_save_failure_is_transient_then_recovers(stack):
    real = stack.store.save_processed
    state = {"fail": True}

    def flaky(*a, **kw):
        if state["fail"]:
            state["fail"] = False
            raise IOError("injected storage failure")
        return real(*a, **kw)

    stack.store.save_processed = flaky
    img = upload(stack)
    stack.drive([img.id], settled=("completed",))   # the redelivery saves
    assert counters()["worker_failed_transient"] == 1
    stack.drain()
    wait_for(lambda: permits_restored(stack.worker))


def test_broken_metadata_write_nacks(stack):
    """Commit after the metadata writes: with the DB down nothing is
    acked, and the replay lands the status."""
    img = upload(stack)
    real = stack.meta.save_processed_image
    state = {"fail": True}

    def down(row):
        if state["fail"]:
            state["fail"] = False
            raise RuntimeError("db down")
        return real(row)

    stack.meta.save_processed_image = down
    stack.drive([img.id], settled=("completed",))
    stack.drain()
    assert counters()["worker_record_failures"] == 1
    assert len(stack.meta.list_processed(img.id)) == 1
    wait_for(lambda: permits_restored(stack.worker))


def test_delete_mid_processing_drops_orphans(stack):
    """Deletion wins: the worker undoes its own artifacts and acks."""
    import os

    img = upload(stack)
    real = stack.meta.update_status
    state = {"deleted": False}

    def deleting_update(image_id, status):
        if not state["deleted"]:
            state["deleted"] = True
            stack.meta.update_status = real
            stack.uc.delete_image(image_id)
        return real(image_id, status)

    stack.meta.update_status = deleting_update
    stack.until(lambda: state["deleted"] and stack.depth() == 0,
                 "the deleted image's task was never acked")
    wait_for(lambda: permits_restored(stack.worker))
    stack.stop()
    assert stack.meta.list_processed(img.id) == []
    leftovers = [f for _dp, _dn, fn in os.walk(
        os.path.join(stack.store.root, "processed")) for f in fn]
    assert leftovers == []


def test_gif_thumbnail_stays_gif_watermark_becomes_jpeg(stack):
    d = port_domain
    bio = io.BytesIO()
    PILImage.fromarray(photo(80, 100, 8)).convert("P").save(bio, format="GIF")
    img = stack.uc.upload_image(bio.getvalue(), "a.gif", "image/gif", [
        *thumb_ops(d), d.OperationParams(d.OperationType.WATERMARK, {"text": "g"})])
    stack.drive([img.id])
    assert stack.status(img.id) == "completed"
    rows = {r.operation.value: r for r in stack.meta.list_processed(img.id)}
    assert rows["thumbnail"].path.endswith("32.gif")
    assert stack.store.get_object(rows["thumbnail"].path)[:6] in (b"GIF87a", b"GIF89a")
    assert rows["watermark"].path.endswith("watermarked.jpeg")


def test_watermark_only_jpeg_splices(stack):
    """The splice context rides through both workers' staging: rows the
    text does not touch stay byte-identical to the source's."""
    d = port_domain
    blob = encoded(320, 448, 9, "JPEG", quality=90)
    img = stack.uc.upload_image(blob, "w.jpg", "image/jpeg", [
        d.OperationParams(d.OperationType.WATERMARK, {
            "text": "pipelined", "opacity": 0.5, "position": "bottom-right"})])
    stack.drive([img.id])
    assert stack.status(img.id) == "completed"
    rows = stack.meta.list_processed(img.id)
    src = np.asarray(PILImage.open(io.BytesIO(blob)))
    got = np.asarray(PILImage.open(io.BytesIO(stack.store.get_object(rows[0].path))))
    assert got.shape == src.shape
    assert np.array_equal(src[:256], got[:256])
    assert (src[288:] != got[288:]).any()
    assert counters()["engine_splice_images"] == 1


def test_burst_of_mixed_sizes(stack):
    ids = [upload(stack, encoded(40 + 7 * i, 90 - 3 * i, 20 + i, "PNG"),
                  f"b{i}.png").id for i in range(10)]
    stack.drive(ids)
    assert all(stack.status(i) == "completed" for i in ids)
    stack.drain()
    wait_for(lambda: permits_restored(stack.worker))


def test_webhook_completion_push(tmp_path):
    import http.server

    received = []

    class Hook(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), Hook)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        s = Stack(PORT, "batch", tmp_path, env={
            "WEBHOOK_URL": f"http://127.0.0.1:{srv.server_port}/cb"})
        img = upload(s)
        s.drive([img.id])
        wait_for(lambda: received, "webhook never delivered", timeout=10)
        assert received[0]["ImageID"] == img.id
        assert received[0]["Status"] == "completed"
        s.worker.close()
        assert port_worker.post_webhook(
            "http://127.0.0.1:1/none", "{}",
            port_utils.RetryStrategy(attempts=1, delay_ms=1)) is False
    finally:
        srv.shutdown()


# ------------------------------------------------- pipelined worker alone

def test_deadline_bounds_batcher_wait(tmp_path):
    """A lone item flushes on the deadline, not on the 64-item batch."""
    deadline_ms = 120.0
    s = Stack(PORT, "pipelined", tmp_path, batch_size=64,
              batch_deadline_ms=deadline_ms)
    try:
        warm = upload(s)
        s.drive([warm.id])
        PORT.metrics.reset()
        img = upload(s)
        s.drive([img.id])
    finally:
        s.close()
    snap = PORT.metrics.snapshot()["timings"]
    wait = snap["batcher_wait_ms"]["max"]
    assert deadline_ms * 0.9 <= wait <= deadline_ms + 1500.0, wait
    for key in ("queue_wait_ms", "span_decode_ms", "span_device_ms",
                "span_encode_ms", "span_pack_ms"):
        assert key in snap, sorted(snap)


def test_permit_exhaustion_by_distinct_buckets_does_not_deadlock(tmp_path):
    s = Stack(PORT, "pipelined", tmp_path, batch_size=32, batch_deadline_ms=40,
              max_queue_depth=8)
    try:
        ids = [upload(s, encoded(64 + 64 * (k % 6), 80 + 128 * (k // 6), 40 + k,
                                 "PNG"), f"b{k}.png").id for k in range(12)]
        s.drive(ids, settled=("completed",))
        s.drain()
        wait_for(lambda: permits_restored(s.worker))
    finally:
        s.close()


def test_finish_stage_failure_is_transient(tmp_path):
    """An exception out of finish_item nacks the item and frees its
    permit; the stage thread lives on and the redelivery completes."""
    PORT.metrics.reset()
    s = Stack(PORT, "pipelined", tmp_path)
    try:
        real = s.worker.engine.finish_item
        state = {"fail": True}

        def flaky(*a, **kw):
            if state["fail"]:
                state["fail"] = False
                raise RuntimeError("finish blew up")
            return real(*a, **kw)

        s.worker.engine.finish_item = flaky
        img = upload(s)
        s.drive([img.id], settled=("completed",))
        s.drain()
        assert counters()["worker_failed_transient"] == 1
        wait_for(lambda: permits_restored(s.worker))
    finally:
        s.close()
