# Copy of imageprocessor_tpu/broker/base.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Broker interface and message type."""

from __future__ import annotations

import abc
import zlib
from dataclasses import dataclass, field


@dataclass
class BrokerMessage:
    """One queued message (reference: broker.go:9-13 Message{Key,Value,Offset}
    plus the partition/topic coordinates Kafka tracks internally)."""

    topic: str
    partition: int
    offset: int
    key: bytes
    value: bytes
    # Opaque redelivery token used by lease-based backends.
    token: str = field(default="", compare=False)
    # Producer-side wall-clock stamp (epoch seconds; 0.0 = unknown).
    # Backends fill it from their durable record (sqlite created_at,
    # Kafka message timestamp) so consumers can observe queue wait —
    # the first stage of the p99 queue-to-processed decomposition.
    enqueued_at: float = field(default=0.0, compare=False)


def partition_for_key(key: bytes, num_partitions: int) -> int:
    """Stable key -> partition mapping so one image's messages are ordered
    within a partition (Kafka keyed-message semantics; the reference keys
    every task by image id, usecase/image/image.go:93-98). CRC32 rather
    than Kafka's murmur2 — the mapping only needs to be stable, not
    byte-identical to Kafka's."""
    if not key or num_partitions <= 1:
        return 0 if num_partitions <= 1 else zlib.crc32(key or b"") % num_partitions
    return zlib.crc32(key) % num_partitions


class Broker(abc.ABC):
    """Unified producer/consumer surface.

    Consumption is pull-based and batched: `poll` claims up to `max_n`
    messages for `group` with a visibility lease; `ack` marks one message
    done (never redelivered); an expired lease returns the message to the
    pool — at-least-once, commit-after-success, matching the reference's
    worker contract (worker.go:125-146) but with per-message granularity.
    """

    @abc.abstractmethod
    def create_topic(self, topic: str, partitions: int = 3) -> None: ...

    @abc.abstractmethod
    def produce(self, topic: str, key: bytes, value: bytes) -> BrokerMessage:
        """Append; returns the stored message with partition/offset set."""

    @abc.abstractmethod
    def poll(self, topic: str, group: str, max_n: int = 1,
             lease_s: float = 60.0) -> list[BrokerMessage]:
        """Claim up to max_n deliverable messages (new or lease-expired)."""

    @abc.abstractmethod
    def ack(self, msg: BrokerMessage) -> bool:
        """Mark processed. False if the lease was lost (another consumer
        already claimed it after expiry) — the caller must treat the work
        as possibly duplicated, which is safe because every operation
        writes to a deterministic path (image_processor.go:129-162)."""

    @abc.abstractmethod
    def nack(self, msg: BrokerMessage) -> None:
        """Release immediately for redelivery (processing failed)."""

    @abc.abstractmethod
    def depth(self, topic: str, group: str) -> int:
        """Unacked message count (for health/metrics)."""

    def close(self) -> None:  # noqa: B027
        pass

