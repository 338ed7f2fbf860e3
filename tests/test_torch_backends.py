"""The port's reference-topology backends against the reference's, over
the wire, on the CPU (DEVICE_PLATFORM=cpu).

* Kafka: the reference's KafkaBroker produces to the port's KafkaServer
  and the port's KafkaBroker consumes, and the reverse; the consumer group
  mixes one member of each package. Two members split three partitions
  and the survivor takes all three after the other leaves; the commit
  watermark survives a restart; the hand-assembled frames of
  tests/test_kafka_goldens.py are encoded byte for byte by the port's
  kafkawire and decoded back; the same seeded fuzz gives the same outcome
  in both packages' decoders and raises nothing but WireError.
* CRC-32C: the port's host library (csrc/crc32c.cpp) equals the Python
  table and the check value.
* Postgres: each package's PostgresMetadataStore on its own
  tests/pg_stub.py server (through chip_smoke.pg_stub) in each auth mode; one sequence of calls leaves
  the same rows and returns the same values.
* S3: ``sign_v4`` equals the reference's on seeded inputs and the AWS
  vector; each package's S3ObjectStore runs CRUD, list-and-delete and the
  create-bucket location constraint against chip_smoke.py's S3 stub, whose
  every request must be SigV4-signed.
* The service end to end: ImageUsecase -> Kafka -> Worker and
  PipelinedWorker -> S3 -> Postgres in each package, on the seven plans of
  the upload form (the reference's batch worker on its engine as
  tests/test_torch_worker.py runs it): statuses, processed rows and the
  results-topic JSON are equal, the artifacts are held to that file's
  contracts.
* The entry points as a deployment runs them: ``kafkaserver`` (no card,
  exit 0 on SIGTERM), ``api`` and ``worker`` with
  deploy/docker-compose.kafka.yaml's backend environment; a worker
  without DEVICE_PLATFORM on a host with no card, and a worker asked for
  the space axis, are refused before any backend is opened; a CPU worker
  asked for a data axis above 1 serves through that many replicas.
"""

import datetime as dt
import hashlib
import json
import random
import struct
import subprocess
import threading
import time
import types
import uuid

import numpy as np
import pytest
import torch

import imageprocessor_tpu.broker as ref_broker
import imageprocessor_tpu.broker.kafka as ref_kafka
import imageprocessor_tpu.broker.kafkaserver as ref_kafkaserver
import imageprocessor_tpu.broker.kafkawire as ref_kw
import imageprocessor_tpu.config as ref_config
import imageprocessor_tpu.domain as ref_domain
import imageprocessor_tpu.service.usecase as ref_usecase
import imageprocessor_tpu.service.worker as ref_worker
import imageprocessor_tpu.storage as ref_storage
import imageprocessor_tpu.storage.postgres_meta as ref_pg
import imageprocessor_tpu.storage.s3 as ref_s3
import imageprocessor_tpu.utils as ref_utils
import imageprocessor_tpu_torch.broker as port_broker
import imageprocessor_tpu_torch.broker.kafka as port_kafka
import imageprocessor_tpu_torch.broker.kafkaserver as port_kafkaserver
import imageprocessor_tpu_torch.broker.kafkawire as port_kw
import imageprocessor_tpu_torch.config as port_config
import imageprocessor_tpu_torch.domain as port_domain
import imageprocessor_tpu_torch.service.pipelined as port_pipelined
import imageprocessor_tpu_torch.service.usecase as port_usecase
import imageprocessor_tpu_torch.service.worker as port_worker
import imageprocessor_tpu_torch.storage as port_storage
import imageprocessor_tpu_torch.storage.postgres_meta as port_pg
import imageprocessor_tpu_torch.storage.s3 as port_s3
import imageprocessor_tpu_torch.utils as port_utils
from chip_smoke import S3Stub, pg_stub, topology_env
from imageprocessor_tpu.runtime.codecs import decode_image
from imageprocessor_tpu_torch.runtime import hostcodec
from tests.oracle import psnr
from tests.pg_stub import PgStubServer
from tests.test_kafka_goldens import (
    _TS0,
    _golden_batch_v2,
    _golden_message_set_m0,
    _seed_corpus,
    _spec_string,
)
from tests.test_torch_service import free_port, service, stop, wait_health
from tests.test_torch_worker import JPEG, form_ops, ref_engine

REF = types.SimpleNamespace(
    name="ref", kafka=ref_kafka, server=ref_kafkaserver.KafkaServer, kw=ref_kw,
    pg=ref_pg, s3=ref_s3, broker=ref_broker, config=ref_config,
    domain=ref_domain, usecase=ref_usecase, storage=ref_storage,
    utils=ref_utils, workers={"batch": ref_worker.Worker})
PORT = types.SimpleNamespace(
    name="port", kafka=port_kafka, server=port_kafkaserver.KafkaServer,
    kw=port_kw, pg=port_pg, s3=port_s3, broker=port_broker, config=port_config,
    domain=port_domain, usecase=port_usecase, storage=port_storage,
    utils=port_utils, workers={"batch": port_worker.Worker,
                               "pipelined": port_pipelined.PipelinedWorker})
# producer package -> the package of the server and of the first consumer
WIRES = {"ref-to-port": (REF, PORT), "port-to-ref": (PORT, REF)}
AUTHS = ["trust", "cleartext", "md5", "scram"]
FLAGS = ("t", "r", "w", "tr", "tw", "rw", "trw")     # the upload form's plans
WAIT_S = 60


def wait_for(fn, why, timeout=WAIT_S, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(interval)
    raise AssertionError(why)


# ------------------------------------------------------------------ kafka

@pytest.fixture(params=list(WIRES))
def wire(request):
    producer, consumer = WIRES[request.param]
    server = consumer.server(default_partitions=3, rebalance_timeout_s=2.0)
    clients = []

    def client(pkg):
        c = pkg.kafka.KafkaBroker(brokers=[server.address])
        clients.append(c)
        return c

    yield types.SimpleNamespace(producer=producer, consumer=consumer,
                                server=server, client=client)
    for c in clients:
        c.close()
    server.close()


def test_kafka_members_of_both_packages_split_and_rebalance(wire):
    """A consumer-group member of each package on one server: range
    assignment splits three partitions between them, each message reaches
    exactly one, and the survivor owns all three after the other leaves."""
    topic, group = "image-processing", "image-processor-group"
    prod = wire.client(wire.producer)
    a = wire.client(wire.consumer)
    b = wire.client(wire.producer)
    prod.create_topic(topic, 3)
    assert a.poll(topic, group, max_n=10) == []      # a joins alone
    seen_a, seen_b = [], []
    halt = threading.Event()

    def pump_a():
        while not halt.is_set():
            for m in a.poll(topic, group, max_n=10):
                seen_a.append(m.value)
                a.ack(m)
            time.sleep(0.02)

    t = threading.Thread(target=pump_a, daemon=True)
    t.start()
    try:
        def split():
            b.poll(topic, group, max_n=10)
            ca, cb = a._consumers[(topic, group)], b._consumers[(topic, group)]
            return (sorted(ca.partitions + cb.partitions) == [0, 1, 2]
                    and ca.generation == cb.generation and ca.partitions
                    and cb.partitions)

        wait_for(split, "the group never split between the packages", interval=0)
        payloads = {f"img-{i}".encode() for i in range(30)}
        for p in sorted(payloads):
            prod.produce(topic, p, p)

        def drained():
            for m in b.poll(topic, group, max_n=10):
                seen_b.append(m.value)
                b.ack(m)
            return len(seen_a) + len(seen_b) >= 30

        wait_for(drained, "the 30 messages never arrived")
        assert sorted(seen_a + seen_b) == sorted(payloads)   # exactly once
        assert seen_a and seen_b
        b.close()                                            # LeaveGroup
        wait_for(lambda: len(a._consumers[(topic, group)].partitions) == 3,
                 "the survivor never took all three partitions")
        for i in range(9):
            prod.produce(topic, f"k{i}".encode(), f"v{i}".encode())
        wait_for(lambda: len(seen_a) + len(seen_b) >= 39, "after the rebalance")
        assert sorted(seen_a[-9:]) == sorted(f"v{i}".encode() for i in range(9))
    finally:
        halt.set()
        t.join(timeout=10)
    assert prod.depth(topic, group) == 0


def test_kafka_commit_watermark_survives_restart_across_packages(wire):
    topic, group = "wm", "g"
    prod = wire.client(wire.producer)
    prod.create_topic(topic, 1)
    for i in range(4):
        prod.produce(topic, b"k", f"m{i}".encode())
    c1 = wire.client(wire.consumer)
    got = c1.poll(topic, group, max_n=2, lease_s=60)
    assert [m.value for m in got] == [b"m0", b"m1"]
    assert all(c1.ack(m) for m in got)
    c1.close()                           # m2, m3 never delivered nor committed
    c2 = wire.client(wire.producer)
    assert prod.depth(topic, group) == 2
    got2 = c2.poll(topic, group, max_n=10, lease_s=60)
    assert [m.value for m in got2] == [b"m2", b"m3"]
    assert all(c2.ack(m) for m in got2)
    assert wire.client(wire.consumer).depth(topic, group) == 0


def _golden_frames():
    """name -> (the port's bytes, the spec's bytes), the goldens of
    tests/test_kafka_goldens.py assembled there from the protocol spec."""
    kw, kf = port_kw, port_kafka
    sub = (struct.pack(">h", 0) + struct.pack(">i", 1)
           + _spec_string("image-processing") + struct.pack(">i", 0))
    assign = (struct.pack(">h", 0) + struct.pack(">i", 1)
              + _spec_string("image-processing") + struct.pack(">i", 2)
              + struct.pack(">ii", 0, 2) + struct.pack(">i", 0))
    rset = _golden_batch_v2()
    produce = (_spec_string(None) + struct.pack(">hi", -1, 10000)
               + struct.pack(">i", 1) + _spec_string("image-processing")
               + struct.pack(">i", 1) + struct.pack(">ii", 2, len(rset)) + rset)
    frame = struct.pack(">hhi", 0, 3, 77) + _spec_string("ip-client") + produce
    join = (_spec_string("image-processor-group") + struct.pack(">i", 30000)
            + struct.pack(">i", 30000) + _spec_string("") + _spec_string("consumer")
            + struct.pack(">i", 1) + _spec_string("range")
            + struct.pack(">i", len(sub)) + sub)
    sync = (_spec_string("image-processor-group") + struct.pack(">i", 3)
            + _spec_string("m-1") + struct.pack(">i", 1) + _spec_string("m-1")
            + struct.pack(">i", len(assign)) + assign)
    return {
        "record_batch_v2": (kw.encode_record_batch(
            [(5, b"k1", b"v-one", _TS0), (6, None, b"v-two", _TS0 + 2)],
            base_offset=5), rset),
        "message_set_m0": (kw.encode_message_set([(3, b"k", b"hello")]),
                           _golden_message_set_m0()),
        "produce_v3_body": (kf.produce_body("image-processing", 2, rset, ver=3),
                            produce),
        "produce_v3_frame": (kw.encode_request(0, 3, 77, "ip-client", produce),
                             struct.pack(">i", len(frame)) + frame),
        "subscription": (kw.encode_subscription(["image-processing"]), sub),
        "join_group_v2": (kf.join_group_body("image-processor-group", "", 30000,
                                             sub, jver=2), join),
        "assignment": (kw.encode_assignment({"image-processing": [0, 2]}), assign),
        "sync_group": (kf.sync_group_body("image-processor-group", 3, "m-1",
                                          [("m-1", assign)]), sync),
    }


@pytest.mark.parametrize("name", sorted(_golden_frames()))
def test_port_kafkawire_encodes_the_spec_goldens(name):
    ours, golden = _golden_frames()[name]
    assert ours == golden


def test_port_kafkawire_decodes_the_spec_goldens():
    kw = port_kw
    msgs = kw.decode_records(_golden_batch_v2())
    assert [(m.offset, m.key, m.value, m.timestamp_ms) for m in msgs] \
        == [(5, b"k1", b"v-one", _TS0), (6, None, b"v-two", _TS0 + 2)]
    assert kw.records_next_offset(_golden_batch_v2()) == 7
    assert [(m.offset, m.key, m.value, m.timestamp_ms)
            for m in kw.decode_message_set(_golden_message_set_m0())] \
        == [(3, b"k", b"hello", -1)]
    frames = _golden_frames()
    assert kw.decode_subscription(frames["subscription"][1]) == ["image-processing"]
    assert kw.decode_assignment(frames["assignment"][1]) == {"image-processing": [0, 2]}
    for tamper in (_golden_batch_v2(), _golden_message_set_m0()):
        bad = bytearray(tamper)
        bad[-1] ^= 0x01
        with pytest.raises(kw.WireError, match="CRC"):
            kw.decode_records(bytes(bad))


PARSE_PATHS = ("decode_records", "decode_message_set", "records_next_offset",
               "decode_subscription", "decode_assignment")


def _outcome(kw, name, blob):
    try:
        return "ok", repr(getattr(kw, name)(blob))
    except kw.WireError:
        return "WireError", None


@pytest.mark.parametrize("mode,seed", [("truncate", 1), ("mutate", 2)])
def test_port_kafkawire_fuzz_matches_the_reference(mode, seed):
    """test_kafka_goldens.py's seeded fuzz through both packages' decoders:
    every outcome is a result or a WireError, and the two agree."""
    rng = random.Random(seed)
    for frame in _seed_corpus():
        for _ in range(60 if mode == "truncate" else 120):
            if mode == "truncate":
                blob = frame[:rng.randrange(0, len(frame) + 1) if frame else 0]
            else:
                if not frame:
                    break
                buf = bytearray(frame)
                for _ in range(rng.randrange(1, 4)):
                    buf[rng.randrange(len(buf))] = rng.randrange(256)
                blob = bytes(buf)
            for name in PARSE_PATHS:
                assert _outcome(port_kw, name, blob) == _outcome(ref_kw, name, blob), \
                    (name, blob.hex())


# ----------------------------------------------------------------- crc32c

def _host_library():
    try:
        hostcodec.library()
    except hostcodec.HostCodecError as exc:
        pytest.skip(f"the host library cannot be built here: {exc}")


@pytest.mark.parametrize("seed", range(4))
def test_hostcodec_crc32c_equals_the_python_table(seed):
    _host_library()
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, int(rng.integers(0, 5000)), dtype=np.uint8).tobytes()
    table = port_kw._CRC32C_TABLE

    def python(b, crc=0):
        crc ^= 0xFFFFFFFF
        for x in b:
            crc = table[(crc ^ x) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF

    assert hostcodec.crc32c(b"123456789") == 0xE3069283
    assert hostcodec.crc32c(data) == python(data)
    cut = len(data) // 3                  # continued from a running value
    assert hostcodec.crc32c(data[cut:], hostcodec.crc32c(data[:cut])) == python(data)
    assert port_kw.crc32c(data) == python(data)
    assert port_kw._native_crc32c is hostcodec.crc32c


# --------------------------------------------------------------- postgres

def _pg_sequence(pkg, store):
    """One sequence of store calls; returns what the calls gave back."""
    d = pkg.domain
    t0 = dt.datetime(2026, 10, 1, 12, 0, tzinfo=dt.timezone.utc)
    images = [d.Image(id=f"img-{i}", original_filename=name, original_size=10 + i,
                      mime_type="image/jpeg", status=d.ImageStatus.UPLOADED,
                      original_path=f"original/2026/10/01/{i}.jpg", bucket="images",
                      created_at=t0 + dt.timedelta(minutes=i),
                      updated_at=t0 + dt.timedelta(minutes=i))
              for i, name in enumerate(["a.jpg", "it's now().jpg", "c d.jpg"])]
    for img in images:
        store.save_image(img)
    store.update_status("img-0", d.ImageStatus.PROCESSING)
    store.update_status("img-0", d.ImageStatus.COMPLETED)
    for n, (op, path) in enumerate([("thumbnail", "processed/thumbnails/img-0/200.jpeg"),
                                    ("resize", "processed/resize/img-0/1024x768.jpeg"),
                                    ("thumbnail", "processed/thumbnails/img-0/200.jpeg")]):
        store.save_processed_image(d.ProcessedImage(
            id=f"p-{n}" if n < 2 else "", image_id="img-0",
            operation=d.OperationType(op), parameters=json.dumps({"n": n}),
            path=path, size=100 + n, mime_type="image/jpeg", format="jpeg",
            status="completed", created_at=t0 + dt.timedelta(seconds=n)))
    store.save_processed_image(d.ProcessedImage(
        id="p-9", image_id="img-2", operation=d.OperationType.RESIZE,
        path="processed/resize/img-2/1.jpeg", size=5, mime_type="image/jpeg",
        format="jpeg", status="completed", created_at=t0))
    store.delete_processed_images("img-2")
    store.update_status("img-1", d.ImageStatus.DELETED)
    with pytest.raises(Exception) as gone:
        store.get_image("img-1")
    got = store.get_image("img-0")
    return {"listed": [(i.id, i.original_filename, i.status.value)
                       for i in store.list_images()],
            "page": [i.id for i in store.list_images(limit=1, offset=1)],
            "got": (got.id, got.status.value, got.original_filename, got.created_at),
            "processed": [(p.operation.value, p.path, p.size, p.parameters)
                          for p in store.list_processed("img-0")],
            "latest": store.get_processed_by_operation("img-0", "thumbnail").size,
            "none": store.get_processed_by_operation("img-2", "resize"),
            "gone": type(gone.value).__name__}


def _pg_rows(stub):
    with stub._db_lock:
        cur = stub._db.cursor()
        images = cur.execute(
            "SELECT id, original_filename, original_size, mime_type, status,"
            " original_path, bucket, created_at FROM images ORDER BY id").fetchall()
        processed = cur.execute(
            "SELECT image_id, operation, parameters, path, size, mime_type, format,"
            " status, created_at FROM processed_images ORDER BY image_id, operation,"
            " path").fetchall()
    return images, processed


@pytest.mark.parametrize("auth", AUTHS)
def test_postgres_stores_leave_the_same_rows(auth):
    out = {}
    for pkg in (REF, PORT):
        stub = pg_stub(auth)
        try:
            store = pkg.pg.PostgresMetadataStore(types.SimpleNamespace(dsn=stub.dsn))
            returned = _pg_sequence(pkg, store)
            store.close()
            out[pkg.name] = (returned, _pg_rows(stub))
        finally:
            stub.close()
    assert out["port"] == out["ref"]
    returned, (images, processed) = out["port"]
    assert returned["listed"] == [("img-2", "c d.jpg", "uploaded"),
                                  ("img-0", "a.jpg", "completed")]
    assert returned["latest"] == 102 and returned["gone"] == "NotFound"
    assert len(images) == 3 and len(processed) == 2      # the upsert replaced


def test_postgres_store_refuses_a_wrong_password():
    stub = PgStubServer(auth="scram", password="right")
    try:
        dsn = stub.dsn().replace(":right@", ":wrong@")
        with pytest.raises(Exception, match="password"):
            port_pg.PostgresMetadataStore(types.SimpleNamespace(dsn=lambda: dsn))
    finally:
        stub.close()


# --------------------------------------------------------------------- s3

def test_sign_v4_official_test_vector():
    headers = port_s3.sign_v4(
        method="GET", host="iam.amazonaws.com", path="/",
        query={"Action": "ListUsers", "Version": "2010-05-08"},
        headers={"content-type": "application/x-www-form-urlencoded; charset=utf-8"},
        payload_sha256=hashlib.sha256(b"").hexdigest(),
        access_key="AKIDEXAMPLE", secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
        region="us-east-1", service="iam",
        now=dt.datetime(2015, 8, 30, 12, 36, 0, tzinfo=dt.timezone.utc))
    assert headers["Authorization"] == (
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/us-east-1/iam/"
        "aws4_request, SignedHeaders=content-type;host;x-amz-date, "
        "Signature=5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")


@pytest.mark.parametrize("seed", range(8))
def test_sign_v4_matches_the_reference(seed):
    rng = random.Random(seed)
    alphabet = "abcXYZ019 -_.~/é+=&%"

    def text(n):
        return "".join(rng.choice(alphabet) for _ in range(rng.randrange(1, n)))

    kwargs = dict(
        method=rng.choice(["GET", "PUT", "HEAD", "DELETE"]),
        host=f"minio-{seed}:9000", path="/images/" + text(30),
        query={text(8): text(12) for _ in range(rng.randrange(0, 4))},
        headers={"Content-Type": "image/jpeg",
                 "x-amz-meta-original-filename": "  " + text(20) + "   x  "},
        payload_sha256=hashlib.sha256(text(50).encode()).hexdigest(),
        access_key=text(12), secret_key=text(30),
        region=rng.choice(["us-east-1", "eu-west-1", "ap-south-1"]),
        now=dt.datetime(2020 + seed, 1 + seed, 3, 4, 5, 6, tzinfo=dt.timezone.utc),
        service=rng.choice(["s3", "iam"]))
    assert port_s3.sign_v4(**kwargs) == ref_s3.sign_v4(**kwargs)


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
@pytest.mark.parametrize("region", ["us-east-1", "eu-west-1"])
def test_s3_store_crud_list_and_bucket_location(pkg, region):
    stub = S3Stub()
    try:
        store = pkg.s3.S3ObjectStore(endpoint=stub.endpoint, region=region,
                                     access_key="minioadmin", secret_key="minioadmin",
                                     bucket="images", use_ssl=False)
        body = stub.buckets["images"]
        if region == "us-east-1":
            assert body == b""
        else:
            assert f"<LocationConstraint>{region}</LocationConstraint>".encode() in body
        path = store.save_original("my  photo é.jpeg", b"JPEGDATA", "image/jpeg")
        assert store.get_object(path) == b"JPEGDATA"
        assert store.stat_object(path).content_type == "image/jpeg"
        for p, data in (("processed/resize/i1/64x64.jpeg", b"OUT1"),
                        ("processed/resize/i1/32x32.jpeg", b"OUT2"),
                        ("processed/resize/i10/32x32.jpeg", b"OUT4"),
                        ("processed/thumbnails/i1/200.jpeg", b"OUT3")):
            store.save_processed(p, data, "image/jpeg")
        assert store.stat_object("processed/resize/i1/64x64.jpeg").size == 4
        assert store.delete_objects_with_prefix("processed/resize/i1/") == 2
        with pytest.raises(pkg.storage.object_store.ObjectNotFound):
            store.get_object("processed/resize/i1/64x64.jpeg")
        with pytest.raises(pkg.storage.object_store.ObjectNotFound):
            store.stat_object("processed/resize/i1/32x32.jpeg")
        assert store.get_object("processed/resize/i10/32x32.jpeg") == b"OUT4"
        store.delete_object(path)
        assert sorted(stub.objects) == ["images/processed/resize/i10/32x32.jpeg",
                                        "images/processed/thumbnails/i1/200.jpeg"]
        assert stub.requests > 10 and stub.unsigned == 0
        store.close()
    finally:
        stub.close()


def test_s3_stub_refuses_unsigned_requests():
    import httpx

    stub = S3Stub()
    try:
        assert httpx.put(f"http://{stub.endpoint}/images", content=b"").status_code == 403
        assert stub.unsigned == 1 and not stub.buckets
    finally:
        stub.close()


# ----------------------------------------------- the service end to end

class Topology:
    """One package's Kafka server, S3 stub and Postgres stub, with the
    usecase and a worker built from deploy/docker-compose.kafka.yaml's
    backend environment by the package's own factories."""

    def __init__(self, pkg, kind):
        self.pkg, self.kind = pkg, kind
        self.kafka = pkg.server(default_partitions=3, rebalance_timeout_s=2.0)
        self.s3 = S3Stub()
        self.pg = pg_stub("scram")
        env = topology_env(self.kafka.address, self.s3.endpoint, self.pg)
        self.cfg = pkg.config.load({**env, "DEVICE_PLATFORM": "cpu"})
        self.cfg.worker.batch_size = 4
        self.cfg.worker.batch_deadline_ms = 30
        c = self.cfg
        self.meta = pkg.storage.build_metadata_store(c.db)
        self.store = pkg.storage.build_object_store(c.storage)
        self.broker = pkg.broker.build_broker(c.broker)
        assert isinstance(self.meta, pkg.pg.PostgresMetadataStore)
        assert isinstance(self.store, pkg.s3.S3ObjectStore)
        assert isinstance(self.broker, pkg.kafka.KafkaBroker)
        self.uc = pkg.usecase.ImageUsecase(
            self.meta, self.store, self.broker,
            retries=pkg.utils.RetryStrategy(attempts=1, delay_ms=1))
        self.worker = pkg.workers[kind](
            c, meta=self.meta, store=self.store, broker=self.broker,
            **({"engine": ref_engine(self.store)} if pkg is REF else {}))
        self.worker._idle_sleep = 0.01
        self.observer = pkg.kafka.KafkaBroker(brokers=[self.kafka.address])

    def run(self, ids):
        """Drive the worker until every image is completed and nothing is
        left unacked; bounded."""
        t = None
        if self.kind == "pipelined":
            t = threading.Thread(target=self.worker.run, daemon=True)
            t.start()

        def done():
            if t is None:
                self.worker.run_once()
            return (all(self.meta.get_image(i).status.value == "completed" for i in ids)
                    and self.broker.depth(self.cfg.broker.processing_topic,
                                          self.cfg.broker.group_id) == 0)

        try:
            wait_for(done, f"{self.pkg.name}/{self.kind}: the uploads never settled",
                     timeout=120)
        finally:
            self.worker.stop()
            if t is not None:
                t.join(timeout=30)
                assert not t.is_alive()

    def results(self, n):
        out = []
        wait_for(lambda: out.extend(self.observer.poll(
            self.cfg.broker.results_topic, "observer", max_n=64)) or len(out) >= n,
            "the results topic", interval=0)
        return out

    def close(self):
        self.worker.close()        # closes meta, store and broker
        self.worker.engine.close()
        self.observer.close()
        self.kafka.close()
        self.s3.close()
        self.pg.close()


def run_topology(pkg, kind):
    top = Topology(pkg, kind)
    try:
        ids = {flags: top.uc.upload_image(JPEG, f"{flags}.jpg", "image/jpeg",
                                          form_ops(pkg.domain, flags)).id
               for flags in FLAGS}
        top.run(ids.values())
        names = {i: f"<{flags}>" for flags, i in ids.items()}

        def anon(text):
            for i, name in names.items():
                text = text.replace(i, name)
            return text

        results = {}
        for m in top.results(len(ids)):
            body = json.loads(anon(m.value.decode()))
            body.pop("ID")
            body.pop("ProcessedAt", None)
            results.setdefault(body.pop("ImageID").strip("<>"), []).append(body)
        rows = {flags: sorted((r.operation.value, anon(r.path), r.mime_type, r.format)
                              for r in top.meta.list_processed(i))
                for flags, i in ids.items()}
        return types.SimpleNamespace(
            statuses={flags: top.meta.get_image(i).status.value
                      for flags, i in ids.items()},
            rows=rows, results=results,
            blobs={flags: {r.operation.value: top.store.get_object(r.path)
                           for r in top.meta.list_processed(i)}
                   for flags, i in ids.items()},
            objects=sorted(anon(k) for k in top.s3.objects if "/processed/" in k),
            unsigned=top.s3.unsigned)
    finally:
        top.close()


@pytest.fixture(scope="module")
def topologies():
    return {("ref", "batch"): run_topology(REF, "batch"),
            **{("port", k): run_topology(PORT, k) for k in ("batch", "pipelined")}}


@pytest.mark.parametrize("kind", ["batch", "pipelined"])
def test_topology_statuses_rows_and_results_match_reference(topologies, kind):
    ref, port = topologies["ref", "batch"], topologies["port", kind]
    assert port.statuses == ref.statuses == dict.fromkeys(FLAGS,
                                                          "completed")
    assert port.rows == ref.rows
    assert port.objects == ref.objects and port.objects
    assert port.results == ref.results
    assert all(len(v) == 1 and v[0]["Status"] == "completed"
               for v in port.results.values())
    assert port.unsigned == ref.unsigned == 0


@pytest.mark.parametrize("kind", ["batch", "pipelined"])
@pytest.mark.parametrize("flags", FLAGS)
def test_topology_artifacts_match_reference(topologies, kind, flags):
    ref, port = topologies["ref", "batch"].blobs[flags], topologies["port", kind].blobs[flags]
    assert sorted(port) == sorted(ref) and port
    for op in ref:
        if op == "watermark":           # spliced: shared native code
            assert port[op] == ref[op]
            continue
        a, fa = decode_image(ref[op])
        b, fb = decode_image(port[op])
        assert fa == fb == "jpeg" and a.shape == b.shape
        assert psnr(a, b) > 45.0


# --------------------------------------------------------- entry points

@pytest.fixture()
def stubs():
    s3, pg = S3Stub(), pg_stub("scram")
    yield s3, pg
    s3.close()
    pg.close()


@pytest.mark.parametrize("mode", ["worker", "worker --pipelined"])
def test_entry_points_on_the_compose_backends(tmp_path, stubs, mode):
    """kafkaserver (no DEVICE_PLATFORM: it needs no card), api and a
    worker as three processes with the compose file's backend environment
    pointed at the stubs; an upload completes and SIGTERM exits 0."""
    from imageprocessor_tpu_torch.client import ImageProcessorClient

    s3, pg = stubs
    kport, aport = free_port(), free_port()
    env = topology_env(f"127.0.0.1:{kport}", s3.endpoint, pg)
    kafka, kafka_log = service(tmp_path, "kafkaserver", "--port", str(kport),
                               platform=None, **env)
    api, api_log = service(tmp_path, "api", "--port", str(aport), platform=None, **env)
    worker, worker_log = service(tmp_path, *mode.split(), **env,
                                 WORKER_BATCH_DEADLINE_MS="20")
    try:
        url = f"http://127.0.0.1:{aport}"
        wait_health(url, api)
        src = tmp_path / "src.jpg"
        src.write_bytes(JPEG)
        with ImageProcessorClient(url) as c:
            up = c.upload(src)
            assert c.wait(up["id"], timeout=90) == "completed"
            assert c.fetch(up["id"]) == JPEG
            assert c.fetch(up["id"], operation="resize")[:2] == b"\xff\xd8"
        assert worker.poll() is None and kafka.poll() is None
        assert any(k.startswith("images/processed/resize/") for k in s3.objects)
    finally:
        codes = []
        for proc, log in ((worker, worker_log), (api, api_log), (kafka, kafka_log)):
            try:                  # every child is stopped, whatever one does
                codes.append(stop(proc, log))
            except subprocess.TimeoutExpired:
                codes.append(None)
    assert codes == [0, 0, 0], (tmp_path / "worker.log").read_text()[-2000:]
    assert s3.unsigned == 0


def test_worker_without_a_card_is_refused_before_any_backend(tmp_path, stubs):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    s3, pg = stubs
    env = topology_env(f"127.0.0.1:{free_port()}", s3.endpoint, pg)
    proc, log = service(tmp_path, "worker", platform=None, **env)
    try:
        code = proc.wait(timeout=120)
    finally:
        stop(proc, log)
    assert code not in (0, None)
    assert "torch.cuda.is_available() is False" in (tmp_path / "worker.log").read_text()
    assert s3.requests == 0


@pytest.mark.parametrize("kind", ["batch", "pipelined"])
@pytest.mark.parametrize("axis", ["DEVICE_DATA_AXIS", "DEVICE_SPACE_AXIS"])
@pytest.mark.parametrize("size", [0, 1, 2, 4])
def test_worker_refuses_a_multi_gpu_mesh_by_name(stubs, kind, axis, size):
    s3, pg = stubs
    kafka = port_kafkaserver.KafkaServer(default_partitions=3)
    try:
        env = topology_env(kafka.address, s3.endpoint, pg)
        cfg = port_config.load({**env, "DEVICE_PLATFORM": "cpu", axis: str(size)})
        cls = PORT.workers[kind]
        if size > 1 and axis == "DEVICE_SPACE_AXIS":
            with pytest.raises(ValueError,
                               match="DEVICE_SPACE_AXIS=.*space axis is not served"):
                cls(cfg)
            assert s3.requests == 0                  # refused before any backend
        else:
            # a data axis above 1 on the CPU: that many replicas
            w = cls(cfg)
            replicas = size if axis == "DEVICE_DATA_AXIS" and size > 1 else 1
            assert w.engine.devices == [torch.device("cpu")] * replicas
            assert w.engine.device == torch.device("cpu")
            assert isinstance(w.broker, port_kafka.KafkaBroker)
            w.close()
            w.engine.close()
    finally:
        kafka.close()


def test_uuid_keys_spread_over_the_three_partitions():
    """The usecase keys each task by its image id; both packages map a key
    to the same partition, so a mixed group agrees on ownership."""
    keys = [str(uuid.UUID(int=i * 7919)).encode() for i in range(60)]
    ref_p = [ref_broker.base.partition_for_key(k, 3) for k in keys]
    port_p = [port_broker.base.partition_for_key(k, 3) for k in keys]
    assert ref_p == port_p and set(port_p) == {0, 1, 2}


def test_worker_entry_point_stops_on_sigterm_off_the_main_thread(monkeypatch):
    """The ``worker`` mode runs the worker on a thread of its own: the
    SIGTERM handler runs on the main thread, and a worker waiting there on
    its stop Event could be deadlocked by the handler's ``stop()`` (seen
    under load: the handler entered Event.set while the main thread held
    that Event's lock inside Event.wait)."""
    import os
    import signal

    import imageprocessor_tpu_torch.service.worker as worker_mod
    from imageprocessor_tpu_torch.service.__main__ import main

    seen = {}

    class StopOnSignal:
        def __init__(self, cfg):
            self._stop = threading.Event()

        def run(self):
            seen["on_main_thread"] = threading.current_thread() is threading.main_thread()
            os.kill(os.getpid(), signal.SIGTERM)
            while not self._stop.is_set():
                self._stop.wait(0.001)

        def stop(self):
            self._stop.set()

        def close(self):
            seen["closed"] = True

    monkeypatch.setattr(worker_mod, "Worker", StopOnSignal)
    monkeypatch.setenv("DEVICE_PLATFORM", "cpu")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        assert main(["worker"]) == 0
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    assert seen == {"on_main_thread": False, "closed": True}
