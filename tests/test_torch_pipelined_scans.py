"""The port's ``PipelinedWorker`` scan pool (service/pipelined.py).

Stage 1 polls on one thread and hands each message, its inflight permit
held, to a pool of WORKER_CONCURRENCY ``scan`` threads that fetch it, scan
it (``engine.decode_for_plan_ex``) and stage it in the batcher. Held here
on the CPU, with the port's MemoryBroker, SQLite metadata and localfs:

* the scans of one worker run at once (a stub decode that waits on a
  3-party barrier completes only then), and ``pipelined_scans`` counts
  each, ``pipelined_scans_overlapped`` each that started beside another;
* every upload is completed exactly once and every permit comes back,
  with the threads switching often;
* a failure on a scan thread completes its upload as failed and releases
  its permit: a decode error, an error the decode's catch-all classifies,
  and one that escapes ``_handle_message`` altogether;
* a stop with scans in flight leaves every polled message completed or
  nacked, and no group reaches the device stage after the sentinel;
* at most 2 x WORKER_CONCURRENCY messages wait for or occupy a scan
  thread, and a slow scan fills exactly that many.
"""

import io
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image as PILImage

from imageprocessor_tpu_torch import config
from imageprocessor_tpu_torch.broker.memory import MemoryBroker
from imageprocessor_tpu_torch.domain import OperationParams, OperationType, ProcessingTask
from imageprocessor_tpu_torch.errors import DecodeError
from imageprocessor_tpu_torch.service import pipelined
from imageprocessor_tpu_torch.service.pipelined import PipelinedWorker
from imageprocessor_tpu_torch.service.usecase import ImageUsecase
from imageprocessor_tpu_torch.storage import LocalFSObjectStore, SQLiteMetadataStore
from imageprocessor_tpu_torch.utils import RetryStrategy
from imageprocessor_tpu_torch.utils.metrics import METRICS

CONCURRENCY = 3
WAIT_S = 120         # every wait on a worker thread is bounded
OPS = [OperationParams(OperationType.THUMBNAIL, {"size": 16, "crop_to_fit": True})]


def jpeg(seed):
    rng = np.random.default_rng(seed)
    img = np.clip(np.linspace(0, 200, 24)[:, None, None] + rng.integers(0, 40, (24, 32, 3)),
                  0, 255).astype(np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(img).save(bio, format="JPEG", quality=90)
    return bio.getvalue()


def image_id(msg):
    return ProcessingTask.from_json(msg.value).image_id


class Stack:
    """A PipelinedWorker of CONCURRENCY scan threads over n uploads, with
    every completion, ack, nack, poll and device-stage hand-off logged."""

    def __init__(self, root, n, batch_size=4):
        cfg = config.load({"DEVICE_PLATFORM": "cpu"})
        cfg.worker.concurrency = CONCURRENCY
        cfg.worker.batch_size = batch_size
        cfg.worker.batch_deadline_ms = 30
        cfg.retries_attempts = 1
        self.meta = SQLiteMetadataStore(":memory:")
        self.store = LocalFSObjectStore(str(root / "objects"))
        self.broker = MemoryBroker()
        uc = ImageUsecase(self.meta, self.store, self.broker,
                          retries=RetryStrategy(attempts=1, delay_ms=1))
        self.worker = PipelinedWorker(cfg, meta=self.meta, store=self.store,
                                      broker=self.broker)
        self.worker._idle_sleep = 0.01
        self.depth = max(cfg.worker.max_queue_depth, 8)
        self.ids = [uc.upload_image(jpeg(k), f"u{k}.jpg", "image/jpeg", OPS).id
                    for k in range(n)]
        self.lock = threading.Lock()
        self.completed, self.acked, self.nacked, self.polled = [], [], [], []
        self.handoffs = []   # groups and the sentinel, in their order
        w, b = self.worker, self.broker
        self._wrap(w, "_complete", lambda msg, *_: self.completed.append(image_id(msg)))
        self._wrap(b, "ack", lambda msg: self.acked.append(image_id(msg)))
        self._wrap(b, "nack", lambda msg: self.nacked.append(image_id(msg)))
        poll = b.poll

        def logged_poll(*a, **kw):
            msgs = poll(*a, **kw)
            with self.lock:
                self.polled += [image_id(m) for m in msgs]
            return msgs

        b.poll = logged_poll
        self._wrap(w._group_q, "put", lambda item: self.handoffs.append(item))
        self.thread = threading.Thread(target=w.run, daemon=True)

    def _wrap(self, obj, name, log):
        real = getattr(obj, name)

        def logged(*a, **kw):
            with self.lock:
                log(*a, **kw)
            return real(*a, **kw)

        setattr(obj, name, logged)

    def status(self, i):
        return self.meta.get_image(i).status.value

    def run_until_done(self):
        self.thread.start()
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and not all(
                self.status(i) in ("completed", "failed") for i in self.ids):
            time.sleep(0.02)
        self.stop()

    def stop(self):
        self.worker.stop()
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive()

    def permits_back(self):
        """Every inflight permit is free: depth of them and no more."""
        sem = self.worker._inflight
        got = 0
        while got <= self.depth and sem.acquire(blocking=False):
            got += 1
        for _ in range(got):
            sem.release()
        return got == self.depth

    def close(self):
        if self.thread.is_alive():
            self.stop()
        self.worker.close()


@pytest.fixture
def stack_of(tmp_path):
    made = []

    def make(n, **kw):
        made.append(Stack(tmp_path, n, **kw))
        return made[-1]

    yield make
    for s in made:
        s.close()


def stub_decode(worker, before):
    """Run ``before(image_id)`` on the scan thread ahead of the real decode."""
    real = worker.engine.decode_for_plan_ex

    def decode(*a, image_id=None, **kw):
        before(image_id)
        return real(*a, image_id=image_id, **kw)

    worker.engine.decode_for_plan_ex = decode


def test_scans_overlap_and_are_counted(stack_of):
    s = stack_of(6)
    barrier = threading.Barrier(CONCURRENCY)
    threads = set()

    def meet(_image_id):
        threads.add(threading.current_thread().name)
        barrier.wait(timeout=20)   # breaks unless three scans run at once

    stub_decode(s.worker, meet)
    METRICS.reset()
    s.run_until_done()
    assert [s.status(i) for i in s.ids] == ["completed"] * len(s.ids)
    assert len(threads) == CONCURRENCY
    assert all(t.startswith("scan") for t in threads)
    counters = METRICS.snapshot()["counters"]
    assert counters["pipelined_scans"] == len(s.ids)
    # the second and third scan of each barrier round start beside the first
    assert counters["pipelined_scans_overlapped"] >= 2 * len(s.ids) // CONCURRENCY


def test_each_upload_completed_exactly_once(stack_of):
    s = stack_of(100)
    METRICS.reset()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # threads interleave often: a lost update shows
    try:
        s.run_until_done()
    finally:
        sys.setswitchinterval(switch)
    assert [s.status(i) for i in s.ids] == ["completed"] * len(s.ids)
    assert sorted(s.completed) == sorted(s.ids)
    assert sorted(s.acked) == sorted(s.ids)
    assert s.nacked == []
    assert METRICS.snapshot()["counters"]["pipelined_scans"] == len(s.ids)
    assert s.worker._scans_queued == s.worker._scans_running == 0
    assert s.permits_back()


def _decode_error(_image_id):
    raise DecodeError("not a picture")


def _unclassified(_image_id):
    raise RuntimeError("scanner fell over")


@pytest.mark.parametrize("where", ["decode_error", "decode_unclassified",
                                   "escapes_handle_message"])
def test_scan_failure_completes_failed_and_releases(stack_of, where):
    s = stack_of(5)
    bad = s.ids[2]
    if where == "escapes_handle_message":
        real = s.worker._parse_and_fetch

        def fetch(msg):
            if image_id(msg) == bad:
                raise RuntimeError("escaped the handler")
            return real(msg)

        s.worker._parse_and_fetch = fetch
    else:
        fail = _decode_error if where == "decode_error" else _unclassified
        stub_decode(s.worker, lambda i: fail(i) if i == bad else None)
    s.run_until_done()
    assert {i: s.status(i) for i in s.ids} == {
        i: "failed" if i == bad else "completed" for i in s.ids}
    # a permanent failure: completed once and acked, never redelivered
    assert sorted(s.completed) == sorted(s.ids)
    assert sorted(s.acked) == sorted(s.ids)
    assert s.permits_back()


def test_stop_with_scans_in_flight(stack_of):
    s = stack_of(12)
    go = threading.Event()
    entered = threading.Semaphore(0)

    def held(_image_id):
        entered.release()
        assert go.wait(WAIT_S)

    stub_decode(s.worker, held)
    s.thread.start()
    for _ in range(CONCURRENCY):   # every scan thread busy
        assert entered.acquire(timeout=WAIT_S)
    deadline = time.monotonic() + WAIT_S
    while s.worker._scans_queued < s.worker._scan_cap and time.monotonic() < deadline:
        time.sleep(0.005)
    s.worker.stop()
    time.sleep(0.1)   # the poll thread sees the stop while the scans hold
    go.set()
    s.stop()
    polled = set(s.polled)
    assert len(polled) == len(s.polled) > s.worker._scan_cap
    # every polled message completed (and acked) or nacked, once
    done = set(s.completed)
    assert done | set(s.nacked) == polled
    assert not done & set(s.nacked)
    assert sorted(s.completed) == sorted(done) == sorted(s.acked)
    assert all(s.status(i) == "completed" for i in done)
    assert len(done) == s.worker._scan_cap
    # the sentinel is the last hand-off to the device stage
    assert s.handoffs[-1] is pipelined._SENTINEL
    assert pipelined._SENTINEL not in s.handoffs[:-1]
    assert sum(len(g.items) for g in s.handoffs[:-1]) == len(done)
    assert s.permits_back()


def test_queued_scans_bounded_by_twice_the_threads(stack_of):
    s = stack_of(30)
    w = s.worker
    lock = threading.Lock()
    now, peak = [0], [0]
    submit, handle = w._scan_pool.submit, w._handle_message

    def counted_submit(*a, **kw):
        with lock:
            now[0] += 1
            peak[0] = max(peak[0], now[0])
        return submit(*a, **kw)

    def counted_handle(msg):
        try:
            return handle(msg)
        finally:
            with lock:
                now[0] -= 1

    w._scan_pool.submit = counted_submit
    w._handle_message = counted_handle
    stub_decode(w, lambda _i: time.sleep(0.02))   # slower than the poll
    s.run_until_done()
    assert [s.status(i) for i in s.ids] == ["completed"] * len(s.ids)
    assert now[0] == 0
    assert peak[0] == w._scan_cap == 2 * CONCURRENCY
    assert s.permits_back()
