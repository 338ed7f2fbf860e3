# Copy of imageprocessor_tpu/broker/kafka.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Kafka broker backend: a pure-Python wire-protocol client.

The deployment-scale backend, speaking the Kafka binary protocol directly
(broker/kafkawire.py) — no client library needed. Topology matches the
reference exactly: a consumer group over the 3-partition
"image-processing" topic, one group member per worker host (reference:
internal/broker/kafka/consumer.go:21-56, producer.go:19-33), keyed
produce so one image's tasks stay ordered within a partition
(usecase/image/image.go:93-98).

Versions are negotiated per connection via ApiVersions (KIP-35): modern
brokers get Produce v3 / Fetch v4 with RecordBatch v2 framing (the only
format Kafka 4.x accepts; timestamps ride natively so queue_wait_ms
works), brokers without ApiVersions fall back to v0 APIs with magic-0
message sets, and a broker whose advertised range excludes both raises a
clear MessageQueueError naming the ranges.

Mapping the framework's lease-based Broker contract onto Kafka:

* produce  -> Produce v3 (acks=-1, record batch) to the key's partition,
              v0 legacy fallback
* poll     -> JoinGroup/SyncGroup membership (range assignment), then
              Fetch v4/v0 from owned partitions; each delivered message
              gets a client-side lease token
* ack      -> mark done; the per-partition commit watermark (lowest
              offset with any un-done message below it) advances and is
              OffsetCommit'ed — commit-after-success with per-message
              granularity (reference commits per message, worker.go:132)
* nack     -> mark for immediate client-side redelivery (the reference's
              leave-uncommitted semantics; on process death the
              uncommitted watermark replays the same messages)
* depth    -> sum over partitions of log-end (ListOffsets) minus the
              committed watermark

Leases are a client-side refinement: Kafka itself redelivers only from
the committed watermark after a rebalance/restart, which this client
preserves — the in-process lease bookkeeping adds per-message retry
inside a live worker without poisoning the commit order.
"""

from __future__ import annotations

import os
import socket
import threading
import time
import uuid

from imageprocessor_tpu_torch.broker import kafkawire as kw
from imageprocessor_tpu_torch.broker.base import Broker, BrokerMessage, partition_for_key
from imageprocessor_tpu_torch.errors import MessageQueueError
from imageprocessor_tpu_torch.utils import get_logger
from imageprocessor_tpu_torch.utils.metrics import METRICS

log = get_logger("kafka")

# Consumer-group session timeout: the broker evicts a member (and
# rebalances its partitions to survivors) after this long without a
# heartbeat/commit/join. 30 s matches the reference client's default
# (segmentio/kafka-go); the env knob exists for fast-failover
# deployments and the rebalance chaos tests.
_SESSION_TIMEOUT_MS = int(os.environ.get(
    "KAFKA_SESSION_TIMEOUT_MS", "30000"))
# Heartbeat pacing: NOT per poll (the worker polls every few ms when idle
# and each heartbeat is a synchronous coordinator RTT), but well under any
# rebalance window so a member never misses a join round — the in-process
# kafkaserver closes rounds after 1 s; real brokers allow far longer.
_HEARTBEAT_INTERVAL_MS = 500
_RETRIABLE = (kw.ILLEGAL_GENERATION, kw.REBALANCE_IN_PROGRESS,
              kw.UNKNOWN_MEMBER_ID, kw.NOT_COORDINATOR)


def join_group_body(group: str, member_id: str, session_ms: int,
                    subscription: bytes, jver: int) -> bytes:
    """JoinGroup request body (KIP-62 layout; v1+ adds
    rebalance_timeout). Exposed as a pure function so the wire-golden
    suite can compare these exact bytes against spec-assembled frames
    (tests/test_kafka_goldens.py)."""
    w = kw.Writer().string(group).i32(session_ms)
    if jver >= 1:
        w.i32(session_ms)  # rebalance_timeout
    return (w.string(member_id).string("consumer")
            .array([("range", subscription)],
                   lambda ww, pr: ww.string(pr[0]).bytes_(pr[1]))
            ).done()


def sync_group_body(group: str, generation: int, member_id: str,
                    assignments: list) -> bytes:
    """SyncGroup request body; assignments = [(member_id, blob)] (empty
    for followers). Pure for the wire-golden suite, like
    join_group_body."""
    return (kw.Writer().string(group).i32(generation).string(member_id)
            .array(assignments,
                   lambda w, a: w.string(a[0]).bytes_(a[1]))).done()


def produce_body(topic: str, pid: int, rset: bytes, ver: int,
                 acks: int = -1, timeout_ms: int = 10000) -> bytes:
    """Produce request body (v3+ prefixes a nullable transactional_id).
    Pure for the wire-golden suite, like join_group_body."""
    w = kw.Writer()
    if ver >= 3:
        w.string(None)  # transactional_id
    return (w.i16(acks).i32(timeout_ms)
            .array([topic], lambda ww, t: (
                ww.string(t)
                .array([pid], lambda w2, p: (
                    w2.i32(p).i32(len(rset)).raw(rset))))).done())


class _Conn:
    """One broker connection: framed request/response with correlation,
    plus the broker's advertised API version ranges (ApiVersions v0,
    negotiated once per connection; empty dict = legacy broker that
    closed the connection or errored on the request)."""

    def __init__(self, host: str, port: int, client_id: str,
                 timeout: float = 15.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.client_id = client_id
        self._corr = 0
        self.api_versions: dict[int, tuple[int, int]] | None = None

    def request(self, api_key: int, api_version: int, body: bytes
                ) -> kw.Reader:
        self._corr += 1
        corr = self._corr
        self.sock.sendall(kw.encode_request(api_key, api_version, corr,
                                            self.client_id, body))
        frame = kw.read_frame(self.sock)
        r = kw.Reader(frame)
        got = r.i32()
        if got != corr:
            raise kw.WireError(f"correlation mismatch {got} != {corr}")
        return r

    def negotiate(self) -> dict[int, tuple[int, int]]:
        """ApiVersions v0 handshake, once per connection. A broker that
        does not speak it (pre-0.10, or the bundled server in legacy
        mode) drops the connection or answers garbage — treated as
        'everything at v0 only'."""
        if self.api_versions is not None:
            return self.api_versions
        try:
            r = self.request(kw.API_VERSIONS, 0, b"")
            err = r.i16()
            vers: dict[int, tuple[int, int]] = {}
            for _ in range(r.i32()):
                key = r.i16()
                vers[key] = (r.i16(), r.i16())
            # UNSUPPORTED_VERSION still carries the ranges per KIP-35.
            self.api_versions = (vers if err in (kw.NONE,
                                                 kw.UNSUPPORTED_VERSION)
                                 else {})
        except (OSError, kw.WireError):
            self.api_versions = {}
            # The failed exchange may have desynced the stream; callers
            # reconnect on the next request error. Re-open eagerly so the
            # first real request after negotiation doesn't pay a retry.
            try:
                peer = self.sock.getpeername()
                self.sock.close()
                self.sock = socket.create_connection(peer, timeout=15.0)
                self.sock.setsockopt(socket.IPPROTO_TCP,
                                     socket.TCP_NODELAY, 1)
            except OSError:
                pass
        return self.api_versions

    def pick(self, api_key: int, preferred: int) -> int:
        """Highest usable version <= preferred; -1 if the broker's range
        excludes everything we can speak.

        Empty vers = legacy broker with no ApiVersions at all -> v0
        fallback by design. A broker that DOES advertise versions but
        omits this API has removed it (the KIP-896 pattern): sending v0
        would just get the connection dropped as an opaque WireError, so
        report no-common-version instead."""
        vers = self.negotiate()
        if not vers:
            return min(0, preferred)
        vrange = vers.get(api_key)
        if vrange is None:
            return -1
        vmin, vmax = vrange
        if vmin > preferred:
            return -1
        return min(vmax, preferred)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class _InFlight:
    __slots__ = ("msg", "token", "deadline", "done", "redeliver")

    def __init__(self, msg: BrokerMessage, token: str, deadline: float):
        self.msg = msg
        self.token = token
        self.deadline = deadline
        self.done = False
        self.redeliver = False


class _Consumer:
    """Group-membership + fetch state for one (topic, group)."""

    def __init__(self, topic: str, group: str):
        self.topic = topic
        self.group = group
        self.member_id = ""
        self.generation = -1
        self.partitions: list[int] = []
        self.positions: dict[int, int] = {}
        self.committed: dict[int, int] = {}
        self.dirty: dict[int, int] = {}   # pid -> uncommitted watermark
        # window starts at consumer creation (0.0 would make the first
        # ack flush immediately — monotonic() is far past any interval)
        self.last_commit = time.monotonic()
        # (partition, offset) -> _InFlight, insertion-ordered per partition
        self.inflight: dict[tuple[int, int], _InFlight] = {}
        self.joined = False
        self.next_fetch_idx = 0
        self.last_heartbeat = 0.0


class KafkaBroker(Broker):
    def __init__(self, cfg=None, *, brokers: list[str] | None = None,
                 client_id: str = "imageprocessor-tpu",
                 default_partitions: int = 3,
                 commit_interval_ms: int = 0):
        if brokers is None:
            if cfg is None or not getattr(cfg, "brokers", None):
                raise MessageQueueError("KAFKA_BROKERS not configured")
            brokers = list(cfg.brokers)
            default_partitions = getattr(cfg, "partitions",
                                         default_partitions)
            commit_interval_ms = getattr(cfg, "commit_interval_ms",
                                         commit_interval_ms)
        # Commit coalescing (KAFKA_COMMIT_INTERVAL): 0 = every ack
        # commits synchronously (strongest restart semantics, right for
        # the in-process/dev brokers where the RTT is ~0). >0 = batch
        # watermark commits, flushing at most every interval (plus on
        # rebalance and close): against a remote broker each ack's
        # OffsetCommit RTT under the client-wide lock otherwise caps
        # pipelined completions at ~1/RTT and serializes stage 3 against
        # stage 1's polls. At-least-once is unaffected — a crash before
        # a flush only REDELIVERS already-acked messages, never loses
        # one (processing is idempotent; deterministic output paths).
        self._commit_interval_s = max(0.0, commit_interval_ms / 1000.0)
        self._bootstrap = [self._parse_addr(b) for b in brokers]
        self._client_id = client_id
        self._default_partitions = default_partitions
        self._lock = threading.RLock()
        self._conns: dict[tuple[str, int], _Conn] = {}
        self._meta: dict[str, list[tuple[int, tuple[str, int]]]] = {}
        self._consumers: dict[tuple[str, str], _Consumer] = {}
        self._tokens: dict[str, tuple[_Consumer, int, int]] = {}
        self._coord: dict[str, tuple[str, int]] = {}

    @staticmethod
    def _parse_addr(s: str) -> tuple[str, int]:
        host, _, port = s.rpartition(":")
        return host or "localhost", int(port)

    # ------------------------------------------------------------ connections

    def _conn(self, addr: tuple[str, int]) -> _Conn:
        c = self._conns.get(addr)
        if c is None:
            c = _Conn(*addr, client_id=self._client_id)
            self._conns[addr] = c
        return c

    def _drop_conn(self, addr: tuple[str, int]) -> None:
        c = self._conns.pop(addr, None)
        if c is not None:
            c.close()

    def _any_conn(self) -> _Conn:
        last: Exception | None = None
        for addr in self._bootstrap:
            try:
                return self._conn(addr)
            except OSError as exc:
                last = exc
        raise MessageQueueError(f"no kafka broker reachable: {last}")

    def _req(self, addr: tuple[str, int], api: int, ver: int, body: bytes,
             timeout: float | None = None) -> kw.Reader:
        """timeout: per-request socket deadline override. JoinGroup (and
        a follower's SyncGroup) are legitimately PARKED by the
        coordinator for up to the rebalance timeout (30 s) while it
        waits for the rest of the group — the default 15 s socket
        timeout would kill every such join, and each failed retry
        rejoins with member_id="" minting a ghost member that the round
        then also waits on."""
        def go() -> kw.Reader:
            conn = self._conn(addr)
            if timeout is not None:
                conn.sock.settimeout(timeout)
            try:
                return conn.request(api, ver, body)
            finally:
                if timeout is not None:
                    try:
                        conn.sock.settimeout(15.0)
                    except OSError:
                        pass
        try:
            return go()
        except (OSError, kw.WireError):
            # one reconnect attempt per call (broker restarts, idle drops)
            self._drop_conn(addr)
            return go()

    def _pick_version(self, addr: tuple[str, int], api: int,
                      preferred: int) -> int:
        """Negotiated version for an API (ApiVersions handshake, cached
        per connection). Raises a CLEAR MessageQueueError — not an opaque
        WireError — when the broker's advertised range excludes every
        version this client speaks."""
        try:
            conn = self._conn(addr)
        except OSError as exc:
            raise MessageQueueError(f"broker {addr} unreachable: {exc}")
        ver = conn.pick(api, preferred)
        if ver < 0:
            name = {kw.PRODUCE: "Produce", kw.FETCH: "Fetch"}.get(
                api, f"api {api}")
            raise MessageQueueError(
                f"broker {addr[0]}:{addr[1]} advertises {name} versions "
                f"{conn.api_versions.get(api)} but this client speaks "
                f"v0..v{preferred}; no common version")
        return ver

    # -------------------------------------------------------------- metadata

    def _metadata(self, topic: str, force: bool = False
                  ) -> list[tuple[int, tuple[str, int] | None]]:
        """[(partition, leader_addr_or_None)] for a topic; cached.

        Leaderless partitions (mid leader-election) are KEPT with a None
        address: the partition COUNT must stay stable so keyed produce
        maps every key to the same partition across leader changes
        (reference per-image ordering, usecase/image/image.go:93-98).

        Metadata v4 against modern brokers (Kafka 4.x removed v0-v3,
        KIP-896), v0 fallback for ancient ones."""
        if not force and topic in self._meta:
            return self._meta[topic]
        conn = self._any_conn()
        ver = conn.pick(kw.METADATA, 4)
        if ver < 0:
            raise MessageQueueError(
                f"broker advertises Metadata versions "
                f"{conn.api_versions.get(kw.METADATA)} but this client "
                "speaks v0..v4; no common version")
        w = kw.Writer().array([topic], lambda w, t: w.string(t))
        if ver >= 4:
            w.i8(1)  # allow_auto_topic_creation
        r = conn.request(kw.METADATA, ver, w.done())
        if ver >= 3:
            r.i32()  # throttle_time_ms
        nodes: dict[int, tuple[str, int]] = {}
        for _ in range(r.i32()):
            node_id = r.i32()
            host = r.string()
            port = r.i32()
            if ver >= 1:
                r.string()  # rack
            nodes[node_id] = (host, port)
        if ver >= 2:
            r.string()  # cluster_id
        if ver >= 1:
            r.i32()  # controller_id
        parts: list[tuple[int, tuple[str, int] | None]] = []
        for _ in range(r.i32()):
            t_err = r.i16()
            t_name = r.string()
            if ver >= 1:
                r.i8()  # is_internal
            n_parts = r.i32()
            for _ in range(n_parts):
                r.i16()  # partition error
                pid = r.i32()
                leader = r.i32()
                r.array(lambda rr: rr.i32())  # replicas
                r.array(lambda rr: rr.i32())  # isr
                if t_name == topic:
                    parts.append((pid, nodes.get(leader)))
            if t_name == topic and t_err not in (kw.NONE,):
                raise MessageQueueError(
                    f"metadata error {t_err} for topic {topic!r}")
        parts.sort()
        if parts:
            self._meta[topic] = parts
        return parts

    # --------------------------------------------------------------- produce

    def create_topic(self, topic: str, partitions: int = 3) -> None:
        """Best-effort (startup ordering: the worker may come up before
        the broker accepts connections, and compose restarts it anyway —
        crashing out of __init__ here would just crash-loop). Every
        failure, including no-broker-reachable and a leader election
        still in progress on the fresh topic, is logged, never raised."""
        with self._lock:
            try:
                conn = self._any_conn()
                ver = conn.pick(kw.CREATE_TOPICS, 2)
                if ver < 0:
                    # best-effort call: no common version is only logged
                    # (topic may pre-exist / auto-create)
                    raise kw.WireError(
                        f"no common CreateTopics version "
                        f"(broker: {conn.api_versions.get(kw.CREATE_TOPICS)})")
                w = (kw.Writer()
                     .array([topic], lambda w, t: (
                         w.string(t).i32(partitions).i16(1)
                         .array([], lambda *_: None)   # replica assignments
                         .array([], lambda *_: None)))  # configs
                     .i32(10000))
                if ver >= 1:
                    w.i8(0)  # validate_only
                r = conn.request(kw.CREATE_TOPICS, ver, w.done())
                if ver >= 2:
                    r.i32()  # throttle_time_ms
                for _ in range(r.i32()):
                    r.string()
                    err = r.i16()
                    if ver >= 1:
                        r.string()  # error_message
                    if err not in (kw.NONE, kw.TOPIC_ALREADY_EXISTS):
                        log.info("create_topic error", topic=topic, code=err)
            except (OSError, kw.WireError, MessageQueueError) as exc:
                log.info("create_topic failed (topic may auto-create)",
                         topic=topic, error=str(exc))
                return
            try:
                self._metadata(topic, force=True)
            except (OSError, kw.WireError, MessageQueueError) as exc:
                # e.g. LEADER_NOT_AVAILABLE while the fresh topic's
                # election finishes; the next produce/poll re-resolves.
                log.info("create_topic metadata refresh failed",
                         topic=topic, error=str(exc))

    def produce(self, topic: str, key: bytes, value: bytes) -> BrokerMessage:
        with self._lock:
            parts = self._metadata(topic)
            if not parts:
                raise MessageQueueError(f"topic {topic!r} has no partitions")
            # Partition by the TOTAL partition count (leaderless ones
            # included) so the key->partition map never shifts during a
            # leader election.
            pid = partition_for_key(key, len(parts))
            leader = dict(parts).get(pid)
            if leader is None:  # mid-election: refresh once, then fail
                leader = dict(self._metadata(topic, force=True)).get(pid)
            if leader is None:
                raise MessageQueueError(
                    f"partition {topic}/{pid} has no leader (election in "
                    "progress); retry")
            ver = self._pick_version(leader, kw.PRODUCE, 3)
            if ver >= 3:
                # RecordBatch v2 (the only format Kafka 4.x accepts);
                # timestamps ride natively, so queue_wait_ms works on
                # real brokers.
                rset = kw.encode_record_batch(
                    [(0, key, value, int(time.time() * 1000))])
            else:
                # Ancient broker (no ApiVersions): magic-0 message set —
                # the one framing every broker since 0.8 accepts. No
                # timestamp field exists at magic 0, so queue_wait_ms is
                # unavailable there (documented in MULTIHOST.md).
                rset = kw.encode_message_set([(0, key, value)])
            body = produce_body(topic, pid, rset, ver)
            r = self._req(leader, kw.PRODUCE, max(ver, 0), body)
            offset = -1
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()
                    err = r.i16()
                    base = r.i64()
                    if ver >= 2:
                        r.i64()  # log_append_time
                    if err != kw.NONE:
                        if err in (kw.NOT_LEADER_FOR_PARTITION,
                                   kw.LEADER_NOT_AVAILABLE,
                                   kw.UNKNOWN_TOPIC_OR_PARTITION):
                            # stale leader cache: next attempt re-resolves
                            self._meta.pop(topic, None)
                        raise MessageQueueError(
                            f"produce error {err} on {topic}/{pid}")
                    offset = base
            return BrokerMessage(topic=topic, partition=pid, offset=offset,
                                 key=key, value=value)

    # --------------------------------------------------------------- consume

    def _coordinator(self, group: str) -> tuple[str, int]:
        addr = self._coord.get(group)
        if addr is not None:
            return addr
        conn = self._any_conn()
        ver = max(conn.pick(kw.FIND_COORDINATOR, 1), 0)
        w = kw.Writer().string(group)
        if ver >= 1:
            w.i8(0)  # key_type: group coordinator
        r = conn.request(kw.FIND_COORDINATOR, ver, w.done())
        if ver >= 1:
            r.i32()  # throttle_time_ms
        err = r.i16()
        if ver >= 1:
            r.string()  # error_message
        if err != kw.NONE:
            raise MessageQueueError(f"find_coordinator error {err}")
        r.i32()  # node id
        host = r.string()
        port = r.i32()
        addr = (host, port)
        self._coord[group] = addr
        return addr

    def _drop_coordinator(self, group: str) -> None:
        """Invalidate the cached coordinator (it moved, or its connection
        died) so the next call re-resolves via FindCoordinator."""
        self._coord.pop(group, None)

    def _join(self, c: _Consumer) -> None:
        """JoinGroup/SyncGroup until stable; range partition assignment.
        One ``group_join`` span covers the whole round, retries included,
        and ``kafka_group_joins`` counts the rounds that complete: a
        rebalance inside a measured window shows in both."""
        # imported here: a process that only produces (the API) never
        # joins a group and so never loads torch
        from imageprocessor_tpu_torch.utils.tracing import span

        with span("group_join", group=c.group) as attrs:
            sub = kw.encode_subscription([c.topic])
            for _attempt in range(25):
                # Resolve the coordinator PER ATTEMPT: NOT_COORDINATOR and
                # connection errors drop the cache below, and retrying the
                # stale address 25 times can never succeed.
                try:
                    coord = self._coordinator(c.group)
                except (OSError, kw.WireError, MessageQueueError):
                    time.sleep(0.05)
                    continue
                try:
                    jver = self._pick_version(coord, kw.JOIN_GROUP, 2)
                except MessageQueueError:
                    time.sleep(0.05)
                    continue
                body = join_group_body(c.group, c.member_id,
                                       _SESSION_TIMEOUT_MS, sub, jver)
                try:
                    # The coordinator parks joins up to the rebalance
                    # timeout; give the socket that long plus margin.
                    r = self._req(coord, kw.JOIN_GROUP, jver, body,
                                  timeout=_SESSION_TIMEOUT_MS / 1000.0 + 10.0)
                except (OSError, kw.WireError):
                    self._drop_coordinator(c.group)
                    time.sleep(0.05)
                    continue
                if jver >= 2:
                    r.i32()  # throttle_time_ms
                err = r.i16()
                generation = r.i32()
                r.string()  # protocol
                leader = r.string()
                member_id = r.string()
                members = r.array(lambda rr: (rr.string(), rr.bytes_()))
                if err == kw.UNKNOWN_MEMBER_ID:
                    c.member_id = ""
                    continue
                if err in _RETRIABLE:
                    if err == kw.NOT_COORDINATOR:
                        self._drop_coordinator(c.group)
                    time.sleep(0.05)
                    continue
                if err != kw.NONE:
                    raise MessageQueueError(f"join_group error {err}")
                c.member_id = member_id
                c.generation = generation

                assignments: list[tuple[str, bytes]] = []
                if member_id == leader:
                    # Range assignment over every subscribed topic, like the
                    # reference client's default (consumer.go group config).
                    topics: set[str] = set()
                    for _mid, meta in members:
                        topics.update(kw.decode_subscription(meta or b""))
                    mids = sorted(mid for mid, _ in members)
                    per_member: dict[str, dict[str, list[int]]] = {
                        mid: {} for mid in mids}
                    for t in sorted(topics):
                        pids = [p for p, _ in self._metadata(t, force=True)]
                        n, k = len(pids), len(mids)
                        chunk, extra = divmod(n, k)
                        start = 0
                        for i, mid in enumerate(mids):
                            cnt = chunk + (1 if i < extra else 0)
                            if cnt:
                                per_member[mid].setdefault(t, []).extend(
                                    pids[start:start + cnt])
                            start += cnt
                    assignments = [(mid, kw.encode_assignment(tp))
                                   for mid, tp in per_member.items()]
                body = sync_group_body(c.group, generation, member_id,
                                       assignments)
                try:
                    sver = self._pick_version(coord, kw.SYNC_GROUP, 1)
                    # A follower's SyncGroup is parked until the leader
                    # syncs — same extended deadline as JoinGroup.
                    r = self._req(coord, kw.SYNC_GROUP, sver, body,
                                  timeout=_SESSION_TIMEOUT_MS / 1000.0 + 10.0)
                except MessageQueueError:
                    time.sleep(0.05)
                    continue
                except (OSError, kw.WireError):
                    self._drop_coordinator(c.group)
                    time.sleep(0.05)
                    continue
                if sver >= 1:
                    r.i32()  # throttle_time_ms
                err = r.i16()
                blob = r.bytes_()
                if err in _RETRIABLE:
                    if err == kw.NOT_COORDINATOR:
                        self._drop_coordinator(c.group)
                    time.sleep(0.05)
                    continue
                if err != kw.NONE:
                    raise MessageQueueError(f"sync_group error {err}")
                owned = kw.decode_assignment(blob or b"").get(c.topic, [])
                self._apply_assignment(c, owned)
                c.joined = True
                c.last_heartbeat = time.monotonic()
                attrs["generation"] = generation
                METRICS.inc("kafka_group_joins")
                return
            raise MessageQueueError("consumer group never stabilized")

    def _apply_assignment(self, c: _Consumer, owned: list[int]) -> None:
        owned_set = set(owned)
        for key in [k for k in c.inflight if k[0] not in owned_set]:
            ent = c.inflight.pop(key)
            self._tokens.pop(ent.token, None)
        c.positions = {p: v for p, v in c.positions.items()
                       if p in owned_set}
        c.committed = {p: v for p, v in c.committed.items()
                       if p in owned_set}
        new = [p for p in owned if p not in c.positions]
        if new:
            fetched = self._offset_fetch(c.group, c.topic, new)
            for p in new:
                start = max(fetched.get(p, 0), 0)
                c.positions[p] = start
                c.committed[p] = start
        c.partitions = sorted(owned)

    def _offset_fetch(self, group: str, topic: str, pids: list[int]
                      ) -> dict[int, int]:
        coord = self._coordinator(group)
        body = (kw.Writer().string(group)
                .array([topic], lambda w, t: (
                    w.string(t).array(pids, lambda w2, p: w2.i32(p))))).done()
        # v1 reads Kafka-stored offsets (v0 reads ZooKeeper; removed in
        # Kafka 4.x) — identical wire layout.
        ver = self._pick_version(coord, kw.OFFSET_FETCH, 1)
        r = self._req(coord, kw.OFFSET_FETCH, ver, body)
        out: dict[int, int] = {}
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                pid = r.i32()
                off = r.i64()
                r.string()  # metadata
                err = r.i16()
                if err == kw.NONE and off >= 0:
                    out[pid] = off
        return out

    def _offset_commit(self, c: _Consumer, pid: int, offset: int) -> bool:
        """True only when the broker acknowledged the commit."""
        for attempt in (0, 1):  # second attempt after a coordinator move
            coord = self._coordinator(c.group)
            # v2 commits carry the member's generation (fencing) and a
            # retention override (-1 = broker default); v0 removed in 4.x.
            ver = self._pick_version(coord, kw.OFFSET_COMMIT, 2)
            w = kw.Writer().string(c.group)
            if ver >= 1:
                w.i32(c.generation).string(c.member_id)
            if ver >= 2:
                w.i64(-1)  # retention_time_ms: broker default
            if ver == 1:
                # v1 (only) carries a per-partition commit timestamp.
                body = (w.array([c.topic], lambda w, t: (
                    w.string(t).array([pid], lambda w2, p: (
                        w2.i32(p).i64(offset).i64(-1).string(""))))).done())
            else:
                body = (w.array([c.topic], lambda w, t: (
                    w.string(t).array([pid], lambda w2, p: (
                        w2.i32(p).i64(offset).string(""))))).done())
            r = self._req(coord, kw.OFFSET_COMMIT, ver, body)
            moved = False
            ok = True
            for _ in range(r.i32()):
                r.string()
                for _ in range(r.i32()):
                    r.i32()
                    err = r.i16()
                    if err == kw.NOT_COORDINATOR:
                        moved = True
                    elif err != kw.NONE:
                        # e.g. ILLEGAL_GENERATION when fenced mid-
                        # rebalance: the commit did NOT land — callers
                        # coalescing watermarks must keep them dirty
                        # and retry under the new generation.
                        ok = False
                        log.error("offset_commit error", code=err,
                                  topic=c.topic, partition=pid)
            if not moved:
                return ok
            self._drop_coordinator(c.group)
        log.error("offset_commit failed: coordinator unstable",
                  topic=c.topic, partition=pid)
        return False

    def _heartbeat_ok(self, c: _Consumer) -> bool:
        """Heartbeat at most every _HEARTBEAT_INTERVAL_MS (a rebalance is
        noticed within one interval; see the constant's comment)."""
        now = time.monotonic()
        if now - c.last_heartbeat < _HEARTBEAT_INTERVAL_MS / 1000.0:
            return True
        body = (kw.Writer().string(c.group).i32(c.generation)
                .string(c.member_id)).done()
        try:
            coord = self._coordinator(c.group)
            ver = self._pick_version(coord, kw.HEARTBEAT, 1)
            r = self._req(coord, kw.HEARTBEAT, ver, body)
        except (OSError, kw.WireError, MessageQueueError):
            self._drop_coordinator(c.group)
            return False
        if ver >= 1:
            r.i32()  # throttle_time_ms
        err = r.i16()
        if err == kw.NOT_COORDINATOR:
            self._drop_coordinator(c.group)
            return False
        c.last_heartbeat = now
        return err == kw.NONE

    def _list_offset(self, topic: str, pid: int, time_ms: int) -> int:
        """ListOffsets: -2 = log start (earliest), -1 = log end."""
        leader = dict(self._metadata(topic)).get(pid)
        if leader is None:
            return 0
        ver = self._pick_version(leader, kw.LIST_OFFSETS, 1)
        w = kw.Writer().i32(-1)
        if ver >= 1:  # v1 drops max_num_offsets; response adds timestamp
            w.array([topic], lambda w, t: (
                w.string(t).array([pid], lambda w2, p: (
                    w2.i32(p).i64(time_ms)))))
        else:
            w.array([topic], lambda w, t: (
                w.string(t).array([pid], lambda w2, p: (
                    w2.i32(p).i64(time_ms).i32(1)))))
        r = self._req(leader, kw.LIST_OFFSETS, ver, w.done())
        result = 0
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                if ver >= 1:
                    r.i64()  # timestamp
                    off = r.i64()
                    if err == kw.NONE:
                        result = off
                else:
                    offs = r.array(lambda rr: rr.i64())
                    if err == kw.NONE and offs:
                        result = offs[0]
        return result

    def _fetch(self, c: _Consumer, pid: int, max_bytes: int = 1 << 20
               ) -> tuple[list[kw.WireMessage], int | None]:
        """Returns (messages, next_offset) where next_offset is the
        position just past every batch the response spanned — needed to
        advance over compacted batches whose records no longer exist."""
        parts = dict(self._metadata(c.topic))
        leader = parts.get(pid)
        if leader is None:
            # Leaderless in the cached view (mid-election, or the cache
            # predates a leader change): force one refresh now so the
            # partition doesn't stall for the life of the cache. Guarded:
            # poll() has already re-leased redeliveries by this point —
            # an exception escaping here would strand them for a full
            # lease; a failed refresh just skips the partition one round.
            try:
                parts = dict(self._metadata(c.topic, force=True))
            except (OSError, kw.WireError, MessageQueueError) as exc:
                log.warn("metadata refresh failed; skipping partition",
                         topic=c.topic, partition=pid, error=str(exc))
                return [], None
            leader = parts.get(pid)
            if leader is None:
                return [], None
        ver = self._pick_version(leader, kw.FETCH, 4)
        w = kw.Writer().i32(-1).i32(0).i32(0)
        if ver >= 3:
            w.i32(max_bytes)   # request-level max_bytes
        if ver >= 4:
            w.i8(0)            # isolation_level: read_uncommitted
        body = (w.array([c.topic], lambda w, t: (
                    w.string(t).array([pid], lambda w2, p: (
                        w2.i32(p).i64(c.positions[pid]).i32(max_bytes))))
                       )).done()
        r = self._req(leader, kw.FETCH, ver, body)
        if ver >= 1:
            r.i32()  # throttle_time_ms
        msgs: list[kw.WireMessage] = []
        next_off: int | None = None
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                r.i64()  # high watermark
                if ver >= 4:
                    r.i64()  # last_stable_offset
                    r.array(lambda rr: (rr.i64(), rr.i64()))  # aborted txns
                mset = r.bytes_() or b""
                if err == kw.OFFSET_OUT_OF_RANGE:
                    # Retention deleted our position's segment: resume at
                    # the LOG START, not 0 (fetching 0 again would loop
                    # forever), and move the commit floor past the
                    # now-nonexistent offsets.
                    start = self._list_offset(c.topic, pid, -2)
                    end = self._list_offset(c.topic, pid, -1)
                    c.positions[pid] = max(start, 0)
                    if c.committed.get(pid, 0) < start:
                        c.committed[pid] = start
                    if c.committed.get(pid, 0) > end:
                        # The log was truncated below our commit floor
                        # (e.g. an in-memory dev broker restarted). A
                        # stale high floor is poison: ack()'s watermark
                        # clamps up to it and then deletes LIVE inflight
                        # leases below it, silently dropping their
                        # redelivery — clamp the floor to the new start.
                        c.committed[pid] = max(start, 0)
                    continue
                if err != kw.NONE:
                    # Leader moved (NOT_LEADER) or topic state changed:
                    # drop the cached metadata so the next fetch
                    # re-resolves the leader instead of stalling the
                    # partition against the old one forever.
                    self._meta.pop(c.topic, None)
                    log.warn("fetch partition error; metadata invalidated",
                             topic=c.topic, partition=pid, code=err)
                    continue
                msgs.extend(kw.decode_records(mset))
                cand = kw.records_next_offset(mset)
                if cand is not None and (next_off is None
                                         or cand > next_off):
                    next_off = cand
        return msgs, next_off

    def poll(self, topic: str, group: str, max_n: int = 1,
             lease_s: float = 60.0) -> list[BrokerMessage]:
        with self._lock:
            c = self._consumers.get((topic, group))
            if c is None:
                c = _Consumer(topic, group)
                self._consumers[(topic, group)] = c
            if c.joined and not self._heartbeat_ok(c):
                c.joined = False
            if not c.joined:
                # flush BEFORE rejoining: a generation bump fences the
                # old member id, and uncommitted watermarks would
                # redeliver already-acked work to the new assignment
                self._maybe_flush_commits(c, force=True)
                self._join(c)
                # the pre-rejoin flush is rejected when we were FENCED
                # (stale generation); retry immediately with the new one
                self._maybe_flush_commits(c, force=True)
            elif self._commit_interval_s > 0:
                self._maybe_flush_commits(c)

            now = time.monotonic()
            out: list[BrokerMessage] = []

            # 1) redeliveries: nacked or lease-expired, oldest first
            for key in sorted(c.inflight):
                if len(out) >= max_n:
                    break
                ent = c.inflight[key]
                if ent.done or (not ent.redeliver and ent.deadline > now):
                    continue
                self._tokens.pop(ent.token, None)
                ent.token = uuid.uuid4().hex
                ent.deadline = now + lease_s
                ent.redeliver = False
                # fresh message object per delivery: the supersession
                # contract requires stale handles to keep the old token
                old = ent.msg
                ent.msg = BrokerMessage(topic=old.topic,
                                        partition=old.partition,
                                        offset=old.offset, key=old.key,
                                        value=old.value, token=ent.token,
                                        enqueued_at=old.enqueued_at)
                self._tokens[ent.token] = (c, key[0], key[1])
                out.append(ent.msg)

            # 2) new messages, round-robin across owned partitions
            n_parts = len(c.partitions)
            attempts = 0
            while len(out) < max_n and n_parts and attempts < n_parts:
                pid = c.partitions[c.next_fetch_idx % n_parts]
                c.next_fetch_idx += 1
                msgs, next_off = self._fetch(c, pid)
                pos = c.positions[pid]
                if not msgs or all(m.offset < pos for m in msgs):
                    # Nothing deliverable. A log-compacted batch can
                    # span ONLY offsets below/at the position with no
                    # surviving records past it — advance the position
                    # over the compacted span (batch header's
                    # lastOffsetDelta) or this loop would re-fetch the
                    # same batch forever while holding the broker lock.
                    if next_off is not None and next_off > pos:
                        c.positions[pid] = next_off
                        attempts = 0  # real progress: retry this pid
                    else:
                        attempts += 1
                    continue
                attempts = 0
                for m in msgs:
                    # RecordBatch fetches return WHOLE batches: when the
                    # fetch offset lands mid-batch (max_n truncation left
                    # the position there, or a restart resumed from a
                    # mid-batch commit), records below the position are
                    # re-reads of messages already delivered/leased —
                    # consuming them would mint fresh lease tokens and
                    # invalidate the outstanding ones (double delivery +
                    # the first completion's ack returning False).
                    if m.offset < c.positions[pid]:
                        continue
                    if len(out) >= max_n:
                        # not consumed: leave the position at this message
                        c.positions[pid] = m.offset
                        break
                    c.positions[pid] = m.offset + 1
                    token = uuid.uuid4().hex
                    bm = BrokerMessage(
                        topic=topic, partition=pid, offset=m.offset,
                        key=m.key or b"", value=m.value or b"", token=token,
                        enqueued_at=(m.timestamp_ms / 1000.0
                                     if m.timestamp_ms >= 0 else 0.0))
                    ent = _InFlight(bm, token, now + lease_s)
                    c.inflight[(pid, m.offset)] = ent
                    self._tokens[token] = (c, pid, m.offset)
                    out.append(bm)
            return out

    def ack(self, msg: BrokerMessage) -> bool:
        with self._lock:
            hit = self._tokens.pop(msg.token, None)
            if hit is None:
                return False  # lease lost / superseded
            c, pid, offset = hit
            ent = c.inflight.get((pid, offset))
            if ent is None or ent.token != msg.token:
                return False
            ent.done = True
            # Advance the commit watermark to the lowest NOT-done inflight
            # offset (or the fetch position if nothing is pending). Offsets
            # need not be dense — compacted/truncated logs have gaps, and a
            # dense +1 walk would stall the watermark forever at a gap.
            pending = [o for (p, o), e in c.inflight.items()
                       if p == pid and not e.done]
            wm = min(pending) if pending else c.positions.get(pid, offset + 1)
            wm = max(wm, c.committed.get(pid, 0))
            for key2 in [k for k, e in c.inflight.items()
                         if k[0] == pid and k[1] < wm]:
                self._tokens.pop(c.inflight[key2].token, None)
                del c.inflight[key2]
            if wm != c.committed.get(pid, 0):
                c.committed[pid] = wm
                if self._commit_interval_s <= 0:
                    try:
                        self._offset_commit(c, pid, wm)
                    except (OSError, kw.WireError,
                            MessageQueueError) as exc:
                        log.error("offset commit failed", error=str(exc))
                else:
                    c.dirty[pid] = wm
                    self._maybe_flush_commits(c)
            return True

    def _maybe_flush_commits(self, c: _Consumer,
                             force: bool = False) -> None:
        """Coalesced-commit flush (caller holds the lock): push dirty
        watermarks when the interval elapsed, a rebalance is about to
        change the generation, or the client is closing."""
        if not c.dirty:
            return
        now = time.monotonic()
        if not force and now - c.last_commit < self._commit_interval_s:
            return
        for pid, wm in list(c.dirty.items()):
            try:
                if self._offset_commit(c, pid, wm):
                    del c.dirty[pid]
                # else: broker rejected (e.g. fenced generation) — keep
                # the watermark dirty; the post-rejoin flush retries it
                # under the new generation.
            except (OSError, kw.WireError, MessageQueueError) as exc:
                log.error("offset commit failed", error=str(exc))
        c.last_commit = now

    def nack(self, msg: BrokerMessage) -> None:
        with self._lock:
            hit = self._tokens.get(msg.token)
            if hit is None:
                return
            c, pid, offset = hit
            ent = c.inflight.get((pid, offset))
            if ent is not None and ent.token == msg.token:
                ent.redeliver = True

    def depth(self, topic: str, group: str) -> int:
        with self._lock:
            parts = self._metadata(topic)
            if not parts:
                return 0
            c = self._consumers.get((topic, group))
            pids = [p for p, _ in parts]
            committed = dict(c.committed) if c is not None else {}
            missing = [p for p in pids if p not in committed]
            if missing:
                committed.update(self._offset_fetch(group, topic, missing))
            total = 0
            for pid, _leader in parts:
                log_end = self._list_offset(topic, pid, -1)
                total += max(0, log_end - committed.get(pid, 0))
            return total

    def close(self) -> None:
        with self._lock:
            for (topic, group), c in self._consumers.items():
                self._maybe_flush_commits(c, force=True)
                if c.joined:
                    try:
                        coord = self._coordinator(group)
                        lver = self._pick_version(coord, kw.LEAVE_GROUP, 1)
                        self._req(coord, kw.LEAVE_GROUP, lver,
                                  kw.Writer().string(group)
                                  .string(c.member_id).done())
                    except Exception:
                        pass
            for conn in self._conns.values():
                conn.close()
            self._conns.clear()
