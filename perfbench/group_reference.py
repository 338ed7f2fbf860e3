"""The plain reference of a Kafka consumer group's semantics, as the
`kafka-topology` configuration relies on them: which partition a key
goes to, which member owns which partitions, and which offset a
commit-after-success consumer commits.

Written from the published behaviour of Kafka's clients, not from the
program's client; plain Python, importing nothing of the program or of
JAX.

* ``partition``: the key partitioner of librdkafka (``consistent``, and
  the CRC-32 half of its default ``consistent_random``) and of kafka-go's
  ``CRC32Balancer``: the CRC-32 of the key bytes (IEEE 802.3, the
  polynomial of Ethernet and zip: ``zlib.crc32``) modulo the partition
  count. The Java client's default hashes with murmur2 instead; the
  program follows the C and Go clients.
* ``range_assign``: Kafka's ``RangeAssignor`` for one topic: members in
  lexicographic order, partitions in numeric order, each member a
  contiguous run of ``n // m`` partitions and the first ``n % m`` one
  more.
* ``watermark``: a consumer that commits only after success commits, for
  a partition, the lowest offset at or above where it started that it
  has not yet acknowledged: Kafka's committed offset is the next one to
  read, so every offset below it is done.
"""

from __future__ import annotations

import zlib


def partition(key: bytes, n: int) -> int:
    """The partition of ``key`` among ``n``."""
    return zlib.crc32(key) % n if n > 1 else 0


def range_assign(member_ids, partitions) -> dict[str, list[int]]:
    """{member id: its partitions} under range assignment."""
    members, parts = sorted(member_ids), sorted(partitions)
    each, extra = divmod(len(parts), len(members))
    out, at = {}, 0
    for i, m in enumerate(members):
        take = each + (1 if i < extra else 0)
        out[m] = parts[at:at + take]
        at += take
    return out


def owner(key: bytes, member_ids, n: int) -> str:
    """The member that serves ``key`` over ``n`` partitions."""
    p = partition(key, n)
    return next(m for m, ps in range_assign(member_ids, range(n)).items() if p in ps)


def watermark(acked_offsets, start: int) -> int:
    """The offset a commit-after-success consumer commits for a partition
    it read from ``start``, once ``acked_offsets`` are acknowledged."""
    acked, w = set(acked_offsets), start
    while w in acked:
        w += 1
    return w
