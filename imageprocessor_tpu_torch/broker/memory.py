# Copy of imageprocessor_tpu/broker/memory.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""In-process broker — the standalone single-binary mode and test backend."""

from __future__ import annotations

import threading
import time
import uuid
from collections import defaultdict
from dataclasses import dataclass, field

from imageprocessor_tpu_torch.broker.base import Broker, BrokerMessage, partition_for_key


@dataclass
class _Stored:
    msg: BrokerMessage
    # per consumer-group delivery state
    done: set = field(default_factory=set)            # groups that acked
    seen: set = field(default_factory=set)            # groups ever leased
    lease_until: dict = field(default_factory=dict)   # group -> expiry ts
    lease_token: dict = field(default_factory=dict)   # group -> token


class MemoryBroker(Broker):
    def __init__(self, default_partitions: int = 3):
        self._default_partitions = default_partitions
        self._topics: dict[str, int] = {}
        # offset -> _Stored (a dict, not a list: retention deletes acked
        # entries, and offsets must stay monotonic, not index-coupled)
        self._messages: dict[tuple[str, int], dict[int, _Stored]] = \
            defaultdict(dict)
        self._next: dict[tuple[str, int], int] = defaultdict(int)
        # groups that have EVER polled a topic — the purge veto set
        self._topic_groups: dict[str, set] = defaultdict(set)
        self._lock = threading.Condition()

    def create_topic(self, topic: str, partitions: int = 3) -> None:
        with self._lock:
            self._topics.setdefault(topic, partitions)

    def _partitions(self, topic: str) -> int:
        return self._topics.setdefault(topic, self._default_partitions)

    def produce(self, topic: str, key: bytes, value: bytes) -> BrokerMessage:
        with self._lock:
            p = partition_for_key(key, self._partitions(topic))
            offset = self._next[(topic, p)]
            self._next[(topic, p)] = offset + 1
            msg = BrokerMessage(topic=topic, partition=p, offset=offset,
                                key=key, value=value,
                                enqueued_at=time.time())
            self._messages[(topic, p)][offset] = _Stored(msg=msg)
            self._lock.notify_all()
            return msg

    def poll(self, topic: str, group: str, max_n: int = 1,
             lease_s: float = 60.0) -> list[BrokerMessage]:
        now = time.monotonic()
        out: list[BrokerMessage] = []
        with self._lock:
            self._topic_groups[topic].add(group)
            # Oldest-first across partitions (offset interleave) so no
            # partition starves while another drains — Kafka's consumer
            # fairness analog.
            candidates = []
            for p in range(self._partitions(topic)):
                for stored in self._messages.get((topic, p), {}).values():
                    if group in stored.done:
                        continue
                    if stored.lease_until.get(group, 0.0) > now:
                        continue
                    candidates.append(stored)
            candidates.sort(key=lambda s: (s.msg.offset, s.msg.partition))
            for stored in candidates[:max_n]:
                token = uuid.uuid4().hex
                stored.seen.add(group)
                stored.lease_until[group] = now + lease_s
                stored.lease_token[group] = token
                m = BrokerMessage(**{**stored.msg.__dict__})
                m.token = token
                out.append(m)
        return out

    def _find(self, msg: BrokerMessage) -> _Stored | None:
        return self._messages.get((msg.topic, msg.partition), {}).get(
            msg.offset)

    def ack(self, msg: BrokerMessage) -> bool:
        with self._lock:
            stored = self._find(msg)
            if stored is None:
                return False
            for g, token in list(stored.lease_token.items()):
                if token == msg.token:
                    stored.done.add(g)
                    stored.lease_token.pop(g, None)
                    stored.lease_until.pop(g, None)
                    return True
            return False

    def nack(self, msg: BrokerMessage) -> None:
        with self._lock:
            stored = self._find(msg)
            if stored is None:
                return
            for g, token in list(stored.lease_token.items()):
                if token == msg.token:
                    stored.lease_until[g] = 0.0
                    stored.lease_token.pop(g, None)
                    self._lock.notify_all()

    def depth(self, topic: str, group: str) -> int:
        with self._lock:
            total = 0
            for p in range(self._partitions(topic)):
                for stored in self._messages.get((topic, p), {}).values():
                    if group not in stored.done:
                        total += 1
            return total

    def purge_done(self, older_than_s: float = 3600.0,
                   unconsumed_ttl_s: float = 7 * 86400.0) -> int:
        """Retention: drop acked messages past `older_than_s` and ANY
        message past `unconsumed_ttl_s` (same two tiers as the SQLite
        broker) — without it the standalone service's queue grows
        unboundedly and every poll scans the whole history."""
        now = time.time()
        removed = 0
        with self._lock:
            for (topic, _p), q in self._messages.items():
                # Veto is TOPIC-WIDE like SQLiteBroker's DISTINCT-grp
                # subquery: every group that has EVER consumed on this
                # topic must have acked the message — a lagging group
                # that simply hasn't reached this offset yet (so it is
                # in neither seen nor done) must still block the purge,
                # or it silently loses the message.
                consumers = self._topic_groups.get(topic, set())
                for offset in [
                    o for o, s in q.items()
                    if ((s.msg.enqueued_at < now - older_than_s
                         and s.done and s.seen.issubset(s.done)
                         and consumers.issubset(s.done)
                         and not s.lease_token)
                        or s.msg.enqueued_at < now - unconsumed_ttl_s)
                ]:
                    del q[offset]
                    removed += 1
        return removed

    def _deliverable(self, topic: str, group: str, now: float
                     ) -> tuple[int, float | None]:
        """(count deliverable NOW, soonest future lease expiry or None).
        Deliverable = not acked by the group and not under an active
        lease held by it — `depth` alone counts in-flight messages, and
        waking on those busy-spins a full core until the lease expires."""
        n = 0
        next_expiry: float | None = None
        for p in range(self._partitions(topic)):
            for s in self._messages.get((topic, p), {}).values():
                if group in s.done:
                    continue
                until = s.lease_until.get(group, 0.0)
                if until > now:  # same gate poll applies
                    if next_expiry is None or until < next_expiry:
                        next_expiry = until
                    continue
                n += 1
        return n, next_expiry

    def wait_for_messages(self, topic: str, group: str, timeout: float) -> bool:
        """Block until something may be deliverable (poll-free idle wait)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                now = time.monotonic()
                n, next_expiry = self._deliverable(topic, group, now)
                if n:
                    return True
                remaining = deadline - now
                if remaining <= 0:
                    return False
                # No notify fires when a lease merely EXPIRES — bound
                # the wait so expiry-driven redelivery wakes on time.
                if next_expiry is not None:
                    remaining = min(remaining, max(next_expiry - now, 0.01))
                self._lock.wait(remaining)
