"""The port's spans (utils/tracing.py) inside its workers and engine.

* recording: ``record()`` to ``stop_recording()`` keeps one SpanRecord
  per span, with its parent on the same thread, its thread, start and end
  on ``time.time_ns()`` and its attributes; with recording off nothing is
  kept and, with no profiler running, ``record_function`` is never called;
* the span tree of the batch ``Worker.run_once`` and of the
  ``PipelinedWorker`` over a few JPEG uploads on the CPU: poll, fetch,
  decode, device (pack, h2d, launch, d2h inside), encode (save inside)
  and record (ack and publish inside), with each upload's id and the
  bytes copied, every span inside the call's own clock bounds;
* ``ack`` and ``publish`` inside ``record``, once per upload, on the
  memory, SQLite and Kafka brokers (the Kafka client against the port's
  in-process ``KafkaServer``), and the Kafka client's ``group_join``
  span and ``kafka_group_joins`` counter, one of each per round;
* the metrics the spans feed: ``span_<name>_ms`` once per span (the
  pipelined worker does not wrap the engine's spans a second time), the
  running ``sum`` beside each reservoir, ``engine_h2d_bytes`` and
  ``engine_d2h_bytes``.
"""

import io
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from imageprocessor_tpu_torch import config
from imageprocessor_tpu_torch.broker.kafka import KafkaBroker
from imageprocessor_tpu_torch.broker.kafkaserver import KafkaServer
from imageprocessor_tpu_torch.broker.memory import MemoryBroker
from imageprocessor_tpu_torch.broker.sqlitebroker import SQLiteBroker
from imageprocessor_tpu_torch.domain import OperationParams, OperationType
from imageprocessor_tpu_torch.service.pipelined import PipelinedWorker
from imageprocessor_tpu_torch.service.usecase import ImageUsecase
from imageprocessor_tpu_torch.service.worker import Worker
from imageprocessor_tpu_torch.storage import LocalFSObjectStore, SQLiteMetadataStore
from imageprocessor_tpu_torch.utils import RetryStrategy, tracing
from imageprocessor_tpu_torch.utils.metrics import METRICS
from imageprocessor_tpu_torch.utils.tracing import record, span, stop_recording

N_UPLOADS = 3
WAIT_S = 90
DEVICE_CHILDREN = {"pack", "h2d", "launch", "d2h"}
RECORD_CHILDREN = {"ack", "publish"}


def jpeg(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.clip(np.linspace(0, 200, h)[:, None, None] + rng.integers(0, 40, (h, w, 3)),
                  0, 255).astype(np.uint8)
    bio = io.BytesIO()
    PILImage.fromarray(img).save(bio, format="JPEG", quality=90)
    return bio.getvalue()


OPS = [OperationParams(OperationType.THUMBNAIL, {"size": 32, "crop_to_fit": True}),
       OperationParams(OperationType.RESIZE, {"width": 48, "height": 40,
                                              "keep_aspect": True})]


@pytest.fixture(autouse=True)
def recording_off():
    stop_recording()
    yield
    stop_recording()


class Stack:
    def __init__(self, cls, root, broker=None):
        cfg = config.load({"DEVICE_PLATFORM": "cpu"})
        cfg.worker.batch_size = 4
        cfg.worker.batch_deadline_ms = 30
        cfg.retries_attempts = 1
        self.meta = SQLiteMetadataStore(":memory:")
        self.store = LocalFSObjectStore(str(root / "objects"))
        self.broker = broker if broker is not None else MemoryBroker()
        self.uc = ImageUsecase(self.meta, self.store, self.broker,
                               retries=RetryStrategy(attempts=1, delay_ms=1))
        self.worker = cls(cfg, meta=self.meta, store=self.store, broker=self.broker)
        self.worker._idle_sleep = 0.01
        self.blobs = {}
        self.ids = []
        for k in range(N_UPLOADS):
            blob = jpeg(64, 80, k)
            img = self.uc.upload_image(blob, f"u{k}.jpg", "image/jpeg", OPS)
            self.ids.append(img.id)
            self.blobs[img.id] = blob

    def done(self):
        return all(self.meta.get_image(i).status.value in ("completed", "failed")
                   for i in self.ids)

    def close(self):
        self.worker.stop()
        self.worker.close()

    def until_done(self):
        """The batch worker's calls until every upload is answered: a
        Kafka member's first call may fetch only part of the backlog."""
        deadline = time.monotonic() + WAIT_S
        while not self.done() and time.monotonic() < deadline:
            self.worker.run_once()
        assert self.done()


def by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def check_tree(recs, stack, lo, hi):
    """What both workers record for N_UPLOADS JPEG uploads of OPS."""
    names = by_name(recs)
    ids = {r.id: r for r in recs}
    assert len(ids) == len(recs)
    for r in recs:
        assert lo <= r.start_ns <= r.end_ns <= hi, r
        if r.parent is not None:   # a child lies inside its parent, same thread
            p = ids[r.parent]
            assert p.thread == r.thread
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    want = set(stack.ids)
    # one fetch, decode, encode and record per upload, each with its id
    for name in ("fetch", "decode", "encode", "record"):
        assert sorted(r.attrs["image_id"] for r in names[name]) == sorted(want), name
        assert all(r.parent is None for r in names[name]), name
    for r in names["fetch"]:
        assert r.attrs["bytes"] == len(stack.blobs[r.attrs["image_id"]])
    assert {r.attrs["layout"] for r in names["decode"]} == {"coef:22"}
    assert sum(r.attrs["n"] for r in names["poll"]) == N_UPLOADS
    # every upload in exactly one device group; its children inside it
    devices = names["device"]
    assert sum(r.attrs["images"] for r in devices) == N_UPLOADS
    assert all(r.attrs["layout"] == "coef:22" for r in devices)
    assert sorted(hw for r in devices for hw in r.attrs["hw"]) == [(64, 80)] * N_UPLOADS
    for name in DEVICE_CHILDREN:
        assert all(ids[r.parent].name == "device" for r in names[name]), name
    check_record_children(recs, want)
    for d in devices:
        kids = by_name(r for r in recs if r.parent == d.id)
        assert set(kids) == DEVICE_CHILDREN
        assert [r.attrs["images"] for r in kids["pack"]] == [d.attrs["images"]]
        assert len(kids["h2d"]) == 1                  # the staged planes, tables, valid dims
        assert len(kids["d2h"]) == len(OPS)           # one output per operation
        assert all(r.attrs["bytes"] > 0 for r in kids["h2d"] + kids["d2h"])
    # two renditions saved per upload, inside its encode
    saves = names["save"]
    assert len(saves) == len(OPS) * N_UPLOADS
    assert all(ids[r.parent].name == "encode" for r in saves)
    assert set(names) == {"poll", "fetch", "decode", "device", "encode", "save",
                          "record"} | DEVICE_CHILDREN | RECORD_CHILDREN
    # the counters: every byte copied, each way
    counters = METRICS.snapshot()["counters"]
    assert counters["engine_h2d_bytes"] == sum(r.attrs["bytes"] for r in names["h2d"])
    assert counters["engine_d2h_bytes"] == sum(r.attrs["bytes"] for r in names["d2h"])
    assert counters["engine_pack_images"] == N_UPLOADS


def check_record_children(recs, want):
    """One ack and one publish per upload, each inside that upload's
    record on its thread, the publish after the ack."""
    names, ids = by_name(recs), {r.id: r for r in recs}
    for name in RECORD_CHILDREN:
        assert sorted(r.attrs["image_id"] for r in names[name]) == sorted(want), name
        for r in names[name]:
            parent = ids[r.parent]
            assert parent.name == "record", name
            assert parent.attrs["image_id"] == r.attrs["image_id"], name
    acks = {r.attrs["image_id"]: r for r in names["ack"]}
    for r in names["publish"]:
        assert r.attrs["bytes"] > 0
        assert acks[r.attrs["image_id"]].end_ns <= r.start_ns


def test_batch_worker_run_once_span_tree(tmp_path):
    s = Stack(Worker, tmp_path)
    try:
        METRICS.reset()
        lo = time.time_ns()
        recs = record()
        assert s.worker.run_once() == N_UPLOADS
        got = stop_recording()
        hi = time.time_ns()
        assert got is recs
        assert s.done()
        check_tree(recs, s, lo, hi)
        names = by_name(recs)
        me = threading.get_ident()
        assert [r.attrs["n"] for r in names["poll"] if r.thread == me] == [N_UPLOADS]
        assert len(names["device"]) == 1
        # the worker's thread polls, fetches, runs the group and records;
        # the codec threads decode and encode
        for name in ("poll", "fetch", "device", "record"):
            assert {r.thread for r in names[name]} == {me}, name
        for name in ("decode", "encode"):
            assert me not in {r.thread for r in names[name]}, name
        # each stage's histogram counts each span once
        t = METRICS.snapshot()["timings"]
        for name, recs_of in names.items():
            assert t[f"span_{name}_ms"]["count"] == len(recs_of), name
    finally:
        s.close()


def test_pipelined_worker_span_tree(tmp_path):
    s = Stack(PipelinedWorker, tmp_path)
    thread = threading.Thread(target=s.worker.run, daemon=True)
    try:
        METRICS.reset()
        lo = time.time_ns()
        recs = record()
        thread.start()
        deadline = time.monotonic() + WAIT_S
        while not s.done() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert s.done()
        # the last record ends after the status is written
        while len([r for r in recs if r.name == "record"]) < N_UPLOADS \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        s.worker.stop()
        thread.join(30)
        assert not thread.is_alive()
        stop_recording()
        hi = time.time_ns()
        check_tree(recs, s, lo, hi)
        names = by_name(recs)
        # the poll thread polls; a scan thread fetches and decodes each
        # upload; the engine's decode, device and encode spans are each
        # counted once, with no wrapper around them
        fetchers = {r.attrs["image_id"]: r.thread for r in names["fetch"]}
        assert fetchers == {r.attrs["image_id"]: r.thread for r in names["decode"]}
        assert set(fetchers.values()).isdisjoint(r.thread for r in names["poll"])
        t = METRICS.snapshot()["timings"]
        for name in ("decode", "encode", "record", "fetch", "ack", "publish"):
            assert t[f"span_{name}_ms"]["count"] == N_UPLOADS, name
        assert t["span_device_ms"]["count"] == len(names["device"])
    finally:
        if thread.is_alive():
            s.worker.stop()
            thread.join(30)
        s.close()


def test_recording_off_keeps_nothing_and_calls_no_record_function(tmp_path, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    s = Stack(Worker, tmp_path)
    try:
        METRICS.reset()
        assert s.worker.run_once() == N_UPLOADS
        assert tracing._records is None
        assert stop_recording() == []
        assert calls == []
        # the histograms are fed all the same
        t = METRICS.snapshot()["timings"]
        assert t["span_record_ms"]["count"] == N_UPLOADS
        assert t["span_device_ms"]["count"] == 1
    finally:
        s.close()


def test_record_function_only_under_a_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with span("outside"):
        pass
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with span("inside"):
            with span("nested"):
                pass
    finally:
        prof.stop()
    with span("after"):
        pass
    assert calls == ["inside", "nested"]


def test_records_nest_per_thread_and_keep_attrs():
    recs = record()
    barrier = threading.Barrier(2)

    def work(tag):
        with span("outer", tag=tag) as attrs:
            barrier.wait(5)
            with span("inner"):
                barrier.wait(5)
            attrs["seen"] = True

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    with pytest.raises(KeyError):
        with span("raised"):
            raise KeyError("kept all the same")
    stop_recording()
    with span("after_stop"):
        pass
    names = by_name(recs)
    assert sorted(names) == ["inner", "outer", "raised"]
    outers = {r.thread: r for r in names["outer"]}
    assert len(outers) == 2
    assert sorted(r.attrs["tag"] for r in outers.values()) == [0, 1]
    assert all(r.attrs["seen"] for r in outers.values())
    for r in names["inner"]:   # the parent is the outer span of its own thread
        assert r.parent == outers[r.thread].id
        assert outers[r.thread].start_ns <= r.start_ns <= r.end_ns <= outers[r.thread].end_ns
    assert names["raised"][0].parent is None


def test_span_started_while_recording_is_kept_whole():
    recs = record()
    with span("straddles"):
        assert stop_recording() is recs
        with span("after"):
            pass
    assert [r.name for r in recs] == ["straddles"]


def test_metrics_keep_a_running_sum():
    METRICS.reset()
    values = [float(v) for v in range(1, 5001)]
    for v in values:
        METRICS.observe("unit_ms", v)
    t = METRICS.snapshot()["timings"]["unit_ms"]
    assert t["count"] == len(values)
    assert t["sum"] == sum(values)   # past the reservoir's 2048 samples too
    METRICS.reset()
    assert "unit_ms" not in METRICS.snapshot()["timings"]


@pytest.fixture
def kafka_server():
    server = KafkaServer(default_partitions=3, rebalance_timeout_s=1.0)
    yield server
    server.close()


@pytest.mark.parametrize("backend", ["memory", "sqlite", "kafka"])
def test_ack_and_publish_nest_in_record_on_each_broker(tmp_path, request, backend):
    if backend == "kafka":
        broker = KafkaBroker(brokers=[request.getfixturevalue("kafka_server").address])
    elif backend == "sqlite":
        broker = SQLiteBroker(str(tmp_path / "broker.db"))
    else:
        broker = MemoryBroker()
    s = Stack(Worker, tmp_path, broker=broker)
    try:
        METRICS.reset()
        recs = record()
        s.until_done()
        stop_recording()
        check_record_children(recs, set(s.ids))
        names = by_name(recs)
        assert len(names["record"]) == N_UPLOADS
        t = METRICS.snapshot()["timings"]
        for name in ("record", "ack", "publish"):
            assert t[f"span_{name}_ms"]["count"] == N_UPLOADS, name
        # the record holds its ack and its publish
        assert t["span_record_ms"]["sum"] >= t["span_ack_ms"]["sum"] + t["span_publish_ms"]["sum"]
        # a group round only where the broker is a Kafka client
        assert ("group_join" in names) == (backend == "kafka")
    finally:
        s.close()


def test_group_join_is_one_span_and_one_count_per_round(kafka_server):
    topic, group = "spans-join", "spans-group"
    member = KafkaBroker(brokers=[kafka_server.address])
    try:
        member.create_topic(topic, 3)
        METRICS.reset()
        recs = record()
        member.poll(topic, group)
        c = member._consumers[(topic, group)]
        first = c.generation
        member.poll(topic, group)             # joined: no second round
        c.joined = False                      # as a failed heartbeat leaves it
        member.poll(topic, group)
        stop_recording()
        joins = by_name(recs)["group_join"]
        assert [r.attrs["group"] for r in joins] == [group, group]
        assert [r.attrs["generation"] for r in joins] == [first, c.generation]
        assert c.generation > first
        assert all(r.parent is None for r in joins)
        snap = METRICS.snapshot()
        assert snap["counters"]["kafka_group_joins"] == 2
        assert snap["timings"]["span_group_join_ms"]["count"] == 2
    finally:
        member.close()
