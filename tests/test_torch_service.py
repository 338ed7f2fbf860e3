"""The port's HTTP service (service/app.py, handlers.py, usecase.py,
client.py and the ``python -m imageprocessor_tpu_torch.service`` entry
points) on the CPU (DEVICE_PLATFORM=cpu: every kernel's plain version).

The in-process tests mirror tests/test_service_e2e.py,
tests/test_service_extras.py and tests/test_client.py: ``build_app`` and
a worker thread on shared MemoryBroker / localfs / SQLite, driven over
real HTTP — under the batch ``Worker`` and under ``PipelinedWorker``. The
subprocess tests start the entry points as a user would: ``standalone``;
``api`` and ``worker`` as two processes that share one data directory
through the SQLite broker; and ``worker`` / ``standalone`` without
DEVICE_PLATFORM on a host with no card, which must refuse to start.
Every wait on a thread or a subprocess has its own timeout.
"""

import asyncio
import io
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import httpx
import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from imageprocessor_tpu_torch.broker.memory import MemoryBroker
from imageprocessor_tpu_torch.client import ClientError, ImageProcessorClient
from imageprocessor_tpu_torch.config import load as load_config
from imageprocessor_tpu_torch.service.app import build_app
from imageprocessor_tpu_torch.service.pipelined import PipelinedWorker
from imageprocessor_tpu_torch.service.worker import Worker
from imageprocessor_tpu_torch.storage import LocalFSObjectStore, SQLiteMetadataStore

REPO = Path(__file__).resolve().parent.parent
RNG = np.random.default_rng(33)
WORKERS = {"batch": Worker, "pipelined": PipelinedWorker}


class ServerHarness:
    """The aiohttp app on its own loop thread plus a worker thread."""

    def __init__(self, tmp_path, worker_cls=Worker):
        self.cfg = load_config({"DEVICE_PLATFORM": "cpu"})
        self.cfg.worker.batch_size = 4
        self.cfg.worker.batch_deadline_ms = 20
        self.meta = SQLiteMetadataStore(str(tmp_path / "meta.db"))
        self.store = LocalFSObjectStore(str(tmp_path / "objects"))
        self.broker = MemoryBroker()
        self.worker = worker_cls(self.cfg, meta=self.meta, store=self.store,
                                 broker=self.broker)
        self.worker._idle_sleep = 0.01
        self._loop = asyncio.new_event_loop()
        self.port = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run_server, daemon=True)
        self._worker_thread = threading.Thread(target=self.worker.run, daemon=True)

    def _run_server(self):
        asyncio.set_event_loop(self._loop)

        async def start():
            from aiohttp import web
            app = build_app(self.cfg, meta=self.meta, store=self.store,
                            broker=self.broker)
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            self.port = runner.addresses[0][1]
            self._started.set()

        self._loop.run_until_complete(start())
        self._loop.run_forever()

    def start(self):
        self._thread.start()
        assert self._started.wait(10), "server failed to start"
        self._worker_thread.start()
        return f"http://127.0.0.1:{self.port}"

    def stop(self):
        self.worker.stop()
        self._worker_thread.join(timeout=30)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
        assert not self._worker_thread.is_alive()
        self.worker.engine.close()


@pytest.fixture(scope="module", params=sorted(WORKERS))
def server(request, tmp_path_factory):
    h = ServerHarness(tmp_path_factory.mktemp(f"svc-{request.param}"),
                      WORKERS[request.param])
    url = h.start()
    yield url
    h.stop()


def png_upload(h=300, w=400, name="test.png"):
    arr = RNG.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="PNG")
    return {"file": (name, bio.getvalue(), "image/png")}


def jpeg_upload(h=300, w=400, name="photo.jpg"):
    yy = np.linspace(0, 150, h)[:, None, None]
    xx = np.linspace(0, 70, w)[None, :, None]
    arr = np.clip(yy + xx + RNG.integers(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(arr).save(bio, format="JPEG", quality=90)
    return {"file": (name, bio.getvalue(), "image/jpeg")}


def wait_status(client, url, image_id, want="completed", timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r = client.get(f"{url}/api/images/{image_id}/status")
        assert r.status_code == 200, r.text
        status = r.json()["status"]
        if status == want:
            return status
        if status == "failed" and want != "failed":
            raise AssertionError(f"processing failed: {r.text}")
        time.sleep(0.02)
    raise TimeoutError(f"status never became {want}")


def test_upload_process_fetch_delete_flow(server):
    with httpx.Client(timeout=30) as c:
        r = c.get(f"{server}/api/health")
        assert r.status_code == 200 and r.json() == {"status": "ok"}

        r = c.post(f"{server}/api/images/upload", files=png_upload())
        assert r.status_code == 202, r.text
        body = r.json()
        assert set(body) == {"id", "filename", "status", "size", "created_at"}
        assert body["filename"] == "test.png"
        assert body["status"] in ("uploaded", "processing")
        image_id = body["id"]
        wait_status(c, server, image_id)

        r = c.get(f"{server}/api/images/{image_id}")
        assert r.status_code == 200
        assert r.headers["Content-Type"] == "image/png"
        assert r.headers["Cache-Control"] == "public, max-age=3600"
        assert 'filename="test.png"' in r.headers["Content-Disposition"]

        r = c.get(f"{server}/api/images/{image_id}", params={"operation": "thumbnail"})
        assert r.status_code == 200
        assert PILImage.open(io.BytesIO(r.content)).size == (200, 200)
        assert 'filename="test_thumbnail.png"' in r.headers["Content-Disposition"]
        r = c.get(f"{server}/api/images/{image_id}", params={"operation": "resize"})
        assert r.status_code == 200
        assert PILImage.open(io.BytesIO(r.content)).size == (1024, 768)

        r = c.get(f"{server}/api/images")
        assert r.status_code == 200
        assert any(i["id"] == image_id for i in r.json())

        r = c.delete(f"{server}/api/images/{image_id}")
        assert r.status_code == 204
        r = c.get(f"{server}/api/images/{image_id}/status")
        assert r.status_code == 404
        assert r.json()["message"] == "Image not found"
        assert c.delete(f"{server}/api/images/{image_id}").status_code == 404
        r = c.get(f"{server}/api/images")
        assert all(i["id"] != image_id for i in r.json())


def test_jpeg_upload_with_all_flags(server):
    """The coefficient path (kernel B1's plain version), the fused pair and
    the spliced watermark, over HTTP."""
    with httpx.Client(timeout=30) as c:
        r = c.post(f"{server}/api/images/upload", files=jpeg_upload(),
                   data={"thumbnail": "true", "resize": "true",
                         "watermark": "true", "watermark_text": "COPYRIGHT"})
        assert r.status_code == 202, r.text
        image_id = r.json()["id"]
        wait_status(c, server, image_id)
        sizes = {}
        for op in ("thumbnail", "resize", "watermark"):
            r = c.get(f"{server}/api/images/{image_id}", params={"operation": op})
            assert r.status_code == 200, op
            assert r.headers["Content-Type"] == "image/jpeg"
            sizes[op] = PILImage.open(io.BytesIO(r.content)).size
        assert sizes == {"thumbnail": (200, 200), "resize": (1024, 768),
                         "watermark": (400, 300)}


def test_query_string_operation_flags(server):
    with httpx.Client(timeout=30) as c:
        r = c.post(f"{server}/api/images/upload"
                   "?watermark=true&watermark_text=QUERYTEXT", files=png_upload())
        assert r.status_code == 202
        image_id = r.json()["id"]
        wait_status(c, server, image_id)
        r = c.get(f"{server}/api/images/{image_id}", params={"operation": "watermark"})
        assert r.status_code == 200
        assert PILImage.open(io.BytesIO(r.content)).size == (400, 300)
        r = c.get(f"{server}/api/images/{image_id}", params={"operation": "resize"})
        assert r.status_code == 404
        assert r.json()["message"] == "Processed version not found"
        # the query value beats the body value: no explicit op -> both defaults
        r = c.post(f"{server}/api/images/upload?thumbnail=false",
                   files=png_upload(), data={"thumbnail": "true"})
        assert r.status_code == 202
        image_id = r.json()["id"]
        wait_status(c, server, image_id)
        for op in ("thumbnail", "resize"):
            r = c.get(f"{server}/api/images/{image_id}", params={"operation": op})
            assert r.status_code == 200, op


def test_truncated_jpeg_reports_failed(server):
    blob = jpeg_upload()["file"][1][:600]
    with httpx.Client(timeout=30) as c:
        r = c.post(f"{server}/api/images/upload",
                   files={"file": ("cut.jpg", blob, "image/jpeg")})
        assert r.status_code == 202
        assert wait_status(c, server, r.json()["id"], want="failed") == "failed"


def test_upload_validation_errors(server):
    with httpx.Client(timeout=30) as c:
        r = c.post(f"{server}/api/images/upload", data={"thumbnail": "true"})
        assert r.status_code == 400
        r = c.post(f"{server}/api/images/upload",
                   files={"file": ("evil.exe", b"MZ", "image/png")})
        assert r.status_code == 400
        assert "Unsupported file format" in r.json()["message"]
        r = c.post(f"{server}/api/images/upload",
                   files={"file": ("fake.png", b"not a png", "image/png")})
        assert r.status_code == 400
        assert r.json()["message"] == "Unsupported file format"
        r = c.post(f"{server}/api/images/upload",
                   files={"file": ("a.png", b"x", "text/plain")})
        assert r.status_code == 400
        assert r.json()["message"] == "File must be an image"
        r = c.post(f"{server}/api/images/upload", files=png_upload(),
                   data={"watermark_text": "x" * (1 << 20)})
        assert r.status_code == 400
        assert "Form field too large" in r.json()["message"]


def test_unknown_image_404s(server):
    with httpx.Client(timeout=10) as c:
        assert c.get(f"{server}/api/images/nope/status").status_code == 404
        assert c.get(f"{server}/api/images/nope").status_code == 404
        assert c.delete(f"{server}/api/images/nope").status_code == 404


def test_list_pagination_rules(server):
    with httpx.Client(timeout=30) as c:
        for _ in range(3):
            c.post(f"{server}/api/images/upload", files=png_upload(h=64, w=64))
        assert len(c.get(f"{server}/api/images", params={"limit": "2"}).json()) == 2
        assert len(c.get(f"{server}/api/images", params={"limit": "0"}).json()) >= 3
        r = c.get(f"{server}/api/images", params={"limit": "abc", "offset": "-5"})
        assert len(r.json()) >= 3


def test_duplicate_file_parts_first_wins(server):
    first = png_upload(h=40, w=52, name="first.png")["file"]
    second = png_upload(h=40, w=52, name="second.png")["file"]
    with httpx.Client(timeout=30) as c:
        r = c.post(f"{server}/api/images/upload?thumbnail=false",
                   files=[("file", first), ("file", second)])
        assert r.status_code == 202, r.text
        assert r.json()["filename"] == "first.png"
        image_id = r.json()["id"]
        wait_status(c, server, image_id)
        assert c.get(f"{server}/api/images/{image_id}").content == first[1]


def test_static_ui_served(server):
    with httpx.Client(timeout=10) as c:
        r = c.get(f"{server}/")
        assert r.status_code == 200
        assert "ImageProcessor" in r.text
        assert 'src="/static/app.js"' in r.text
        r = c.get(f"{server}/static/app.js")
        assert r.status_code == 200
        assert "POLL_INTERVAL_MS = 5000" in r.text
        assert c.get(f"{server}/static/style.css").status_code == 200


def test_metrics_in_both_formats(server):
    with httpx.Client(timeout=30) as c:
        r = c.post(f"{server}/api/images/upload", files=png_upload(h=64, w=64))
        wait_status(c, server, r.json()["id"])
        r = c.get(f"{server}/api/metrics")
        assert r.headers["content-type"].startswith("application/json")
        m = r.json()
        assert m["counters"]["engine_device_images"] >= 1
        assert m["counters"]["worker_completed"] >= 1
        assert "span_device_ms" in m["timings"]
        r = c.get(f"{server}/api/metrics", params={"format": "prometheus"})
        assert r.status_code == 200
        assert r.headers["content-type"].startswith("text/plain")
        assert "# TYPE imageprocessor_" in r.text
        r = c.get(f"{server}/api/metrics", headers={
            "Accept": "application/openmetrics-text;version=1.0.0,"
                      "text/plain;version=0.0.4;q=0.5,*/*;q=0.1"})
        assert r.headers["content-type"].startswith("text/plain")
        assert "# TYPE imageprocessor_" in r.text


def test_client_full_flow_and_error_mapping(server, tmp_path):
    arr = RNG.integers(0, 256, size=(120, 160, 3), dtype=np.uint8)
    png = tmp_path / "img.png"
    PILImage.fromarray(arr).save(png)
    bad = tmp_path / "bad.exe"
    bad.write_bytes(b"MZ")
    with ImageProcessorClient(server) as c:
        assert c.health()
        up = c.upload(png, thumbnail=True, watermark=True, watermark_text="SDK")
        assert up["filename"] == "img.png"
        assert c.wait(up["id"], timeout=60) == "completed"
        thumb = c.fetch(up["id"], operation="thumbnail")
        assert PILImage.open(io.BytesIO(thumb)).size == (200, 200)
        dest = c.download(up["id"], tmp_path / "out.png", operation="watermark")
        assert dest.exists() and dest.stat().st_size > 0
        assert any(i["id"] == up["id"] for i in c.list_images())
        assert "counters" in c.metrics()
        c.delete(up["id"])
        with pytest.raises(ClientError) as err:
            c.status(up["id"])
        assert err.value.status == 404
        with pytest.raises(ClientError) as err:
            c.upload(bad)
        assert err.value.status == 400


def test_request_deadline_enforced(tmp_path):
    """A handler stalled past SERVER_READ/WRITE_TIMEOUT answers 408; a
    backend's socket.timeout inside a handler is a 500, not a 408."""
    from aiohttp import web
    from aiohttp.test_utils import TestClient, TestServer

    cfg = load_config({"DEVICE_PLATFORM": "cpu"})
    cfg.server.read_timeout_s = 0.15
    cfg.server.write_timeout_s = 0.15
    app = build_app(cfg, meta=SQLiteMetadataStore(":memory:"),
                    store=LocalFSObjectStore(str(tmp_path / "obj")),
                    broker=MemoryBroker())

    async def stalled(_request):
        await asyncio.sleep(5)
        return web.json_response({})

    async def backend_timeout(_request):
        raise socket.timeout("backend socket timed out")

    app.router.add_get("/stalled", stalled)
    app.router.add_get("/backend-timeout", backend_timeout)

    async def drive():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            assert (await client.get("/api/health")).status == 200
            assert (await client.get("/stalled")).status == 408
            assert (await client.get("/backend-timeout")).status == 500
        finally:
            await client.close()

    asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(drive(), timeout=30))


# ------------------------------------------------------ the entry points

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def service(tmp_path, *args, platform="cpu", **env):
    """``python -m imageprocessor_tpu_torch.service ...`` as a child; its
    output goes to a file so a full pipe can never stall it."""
    child_env = {**os.environ, "PYTHONPATH": str(REPO), **env}
    child_env.pop("DEVICE_PLATFORM", None)
    if platform is not None:
        child_env["DEVICE_PLATFORM"] = platform
    log = open(tmp_path / f"{args[0]}.log", "wb")
    return subprocess.Popen(
        [sys.executable, "-m", "imageprocessor_tpu_torch.service", *args],
        cwd=str(tmp_path), env=child_env, stdout=log, stderr=subprocess.STDOUT), log


def wait_health(url, proc, timeout=90):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, "the service exited before it answered"
        try:
            if httpx.get(f"{url}/api/health", timeout=2).status_code == 200:
                return
        except httpx.TransportError:
            time.sleep(0.1)
    raise TimeoutError("the service never answered /api/health")


def stop(proc, log, timeout=60):
    """SIGTERM, bounded wait, kill as the last resort; returns the code."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        raise
    finally:
        log.close()


def upload_fetch_delete(url, tmp_path):
    src = tmp_path / "src.jpg"
    src.write_bytes(jpeg_upload()["file"][1])
    with ImageProcessorClient(url) as c:
        assert c.health()
        up = c.upload(src)                      # no flags: the default pair
        assert c.wait(up["id"], timeout=90) == "completed"
        assert c.fetch(up["id"]) == src.read_bytes()
        assert PILImage.open(io.BytesIO(
            c.fetch(up["id"], operation="thumbnail"))).size == (200, 200)
        assert PILImage.open(io.BytesIO(
            c.fetch(up["id"], operation="resize"))).size == (1024, 768)
        c.delete(up["id"])
        with pytest.raises(ClientError) as err:
            c.status(up["id"])
        assert err.value.status == 404
        return c.metrics()


def test_standalone_entry_point_serves_and_exits_cleanly(tmp_path):
    port = free_port()
    proc, log = service(tmp_path, "standalone", "--data", str(tmp_path / "data"),
                        "--port", str(port))
    try:
        url = f"http://127.0.0.1:{port}"
        wait_health(url, proc)
        metrics = upload_fetch_delete(url, tmp_path)
        assert metrics["counters"]["engine_device_images"] >= 1
    finally:
        code = stop(proc, log)
    assert code == 0, (tmp_path / "standalone.log").read_text()[-2000:]
    assert (tmp_path / "data" / "metadata.db").exists()


@pytest.mark.parametrize("pipelined", [False, True], ids=["batch", "pipelined"])
def test_api_and_worker_as_two_processes_over_sqlite(tmp_path, pipelined):
    port = free_port()
    data = str(tmp_path / "data")
    api, api_log = service(tmp_path, "api", "--data", data, "--port", str(port),
                           BROKER_BACKEND="sqlite")
    worker, worker_log = service(
        tmp_path, "worker", "--data", data, *(["--pipelined"] if pipelined else []),
        BROKER_BACKEND="sqlite", WORKER_BATCH_DEADLINE_MS="20")
    try:
        url = f"http://127.0.0.1:{port}"
        wait_health(url, api)
        upload_fetch_delete(url, tmp_path)
        assert worker.poll() is None
    finally:
        codes = (stop(worker, worker_log), stop(api, api_log))
    assert codes == (0, 0)


@pytest.mark.parametrize("mode", ["worker", "standalone"])
def test_entry_point_without_a_card_refuses_to_start(tmp_path, mode):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    proc, log = service(tmp_path, mode, "--data", str(tmp_path / "data"),
                        "--port", str(free_port()), platform=None)
    try:
        code = proc.wait(timeout=120)
    finally:
        stop(proc, log)
    assert code not in (0, None)
    text = (tmp_path / f"{mode}.log").read_text()
    assert "torch.cuda.is_available() is False" in text
    assert not (tmp_path / "data").exists()      # refused before any backend


def test_entry_point_help_lists_the_ported_modes():
    out = subprocess.run(
        [sys.executable, "-m", "imageprocessor_tpu_torch.service", "--help"],
        cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert "{api,worker,standalone,kafkaserver}" in out.stdout
    assert "--pipelined" in out.stdout
