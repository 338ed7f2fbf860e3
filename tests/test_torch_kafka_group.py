"""The port's Kafka consumer group held to perfbench/group_reference.py,
the plain reference of the group's semantics, on seeded data at a small
size against the port's in-process ``KafkaServer``:

* the client's partition of a key (the partition its produce lands in)
  is ``partition``'s, over 1, 3 and 7 partitions;
* two and three ``KafkaBroker`` members of one group, once their round
  has settled, hold exactly ``range_assign``'s partitions for their ids;
* after each ack, in a seeded random order, the group's committed offsets
  as OffsetFetch reads them are ``watermark``'s, from a fresh topic and
  again after a member resumes from the commits another left;
* a two-member ``PipelinedWorker`` run of the benchmark's
  ``kafka-topology`` cell on the CPU (the ``kafkaserver`` child, at the
  deployment tests' small size) is correct and completes every upload
  once, by the member ``owner`` names for its key.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from chip_smoke import group_check
from imageprocessor_tpu_torch.broker.kafka import KafkaBroker
from imageprocessor_tpu_torch.broker.kafkaserver import KafkaServer
from perfbench import common, group_reference, harness

SEED = 2**31 + 2020
SETTLE_S = 60.0
CELL = "kafka-topology.camera12mp-backlog"
BACKLOG = {"pools": {"camera": {"h": 720, "w": 960, "count": 4}}, "depth": 8,
           "drain_s": 8, "warm": [["camera", 4, []]], "sample": 6}


@pytest.fixture
def server():
    s = KafkaServer(default_partitions=3, rebalance_timeout_s=1.0)
    yield s
    s.close()


def client(server) -> KafkaBroker:
    return KafkaBroker(brokers=[server.address])


def seeded_keys(n: int, seed: int) -> list[bytes]:
    """Image ids as the API keys its produce, and raw keys of 1-40 bytes."""
    rng = np.random.default_rng(seed)
    ids = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)).hex() for _ in range(n // 2)]
    keys = [f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}".encode() for h in ids]
    keys += [bytes(rng.integers(0, 256, int(rng.integers(1, 41)), dtype=np.uint8))
             for _ in range(n - len(keys))]
    return keys


@pytest.mark.parametrize("partitions", [1, 3, 7])
def test_the_clients_partition_is_the_references(server, partitions):
    topic = f"keys-{partitions}"
    producer = client(server)
    try:
        producer.create_topic(topic, partitions)
        for key in seeded_keys(256, SEED + partitions):
            got = producer.produce(topic, key, b"v").partition
            assert got == group_reference.partition(key, partitions), key
    finally:
        producer.close()


def settled(members, topic, group, partitions):
    """Each member's consumer once all hold one round's assignment."""
    views = [m._consumers.get((topic, group)) for m in members]
    if all(c is not None and c.joined for c in views) \
            and len({c.generation for c in views}) == 1 \
            and sorted(p for c in views for p in c.partitions) == list(range(partitions)):
        return views
    return None


@pytest.mark.parametrize("n_members", [2, 3])
def test_members_hold_the_range_assignment(server, n_members):
    topic, group = "assign", "image-processor-group"
    members = [client(server) for _ in range(n_members)]
    members[0].create_topic(topic, 3)
    stop = threading.Event()

    def poll(m):
        while not stop.is_set():
            m.poll(topic, group, max_n=1)
            stop.wait(0.02)

    threads = [threading.Thread(target=poll, args=(m,)) for m in members]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + SETTLE_S
        while (views := settled(members, topic, group, 3)) is None:
            assert time.monotonic() < deadline, "the group never settled"
            time.sleep(0.05)
        ids = [c.member_id for c in views]
        want = group_reference.range_assign(ids, range(3))
        assert [sorted(c.partitions) for c in views] == [want[m] for m in ids]
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        for m in members:
            m.close()


def committed(observer, group, topic) -> dict[int, int]:
    return observer._offset_fetch(group, topic, [0, 1, 2])


def ack_in_random_order(member, observer, topic, group, n, rng):
    """Polls ``n`` messages, acks them in a random order and, after each
    ack, holds every partition's committed offset to ``watermark``."""
    msgs = []
    deadline = time.monotonic() + SETTLE_S
    while len(msgs) < n:
        assert time.monotonic() < deadline, f"polled {len(msgs)} of {n}"
        msgs += member.poll(topic, group, max_n=n - len(msgs))
    start = {p: min(m.offset for m in msgs if m.partition == p)
             for p in {m.partition for m in msgs}}
    acked: dict[int, set[int]] = {p: set() for p in start}
    for k in rng.permutation(len(msgs)):
        m = msgs[k]
        assert member.ack(m)
        acked[m.partition].add(m.offset)
        got = committed(observer, group, topic)
        for p in start:
            assert got.get(p, start[p]) == group_reference.watermark(acked[p], start[p]), \
                (p, sorted(acked[p]))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_commits_follow_the_watermark(server, seed):
    topic, group = f"commits-{seed}", "image-processor-group"
    rng = np.random.default_rng(SEED + seed)
    producer, observer = client(server), client(server)
    try:
        producer.create_topic(topic, 3)
        for key in seeded_keys(24, SEED + seed):
            producer.produce(topic, key, b"v")
        first = client(server)
        ack_in_random_order(first, observer, topic, group, 24, rng)
        first.close()
        # a member that resumes from the commits the first one left
        for key in seeded_keys(12, SEED + seed + 100):
            producer.produce(topic, key, b"v")
        resumed = client(server)
        try:
            ack_in_random_order(resumed, observer, topic, group, 12, rng)
        finally:
            resumed.close()
    finally:
        producer.close()
        observer.close()


def test_a_two_member_pipelined_run_completes_each_upload_once_by_its_owner(monkeypatch):
    monkeypatch.setenv("IMAGEPROCESSOR_FONT", common.ensure_font())
    line, run = harness.run_cell(CELL, SEED, 2.0, False, "cpu", traffic_overrides=BACKLOG)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert run.extra["service_exit"] == {"kafkaserver": 0}
    got = group_check(run)
    assert got["judged"] == len(run.judged) > 0
    assert got["member_partitions"] == got["range_assign"]
    assert sorted(map(len, got["range_assign"])) == [1, 2]
    assert got["not_once"] == 0 and got["misrouted"] == 0, got
    assert sum(got["member_completed"]) == len(run.judged)
