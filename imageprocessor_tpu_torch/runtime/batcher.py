# Copy of imageprocessor_tpu/runtime/batcher.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Resolution bucketing and micro-batch grouping.

Mixed-resolution uploads cannot share one XLA program (static shapes), so
decoded images are padded up to a shape bucket from a fixed ladder and
grouped by (bucket, plan). The ladder bounds both the number of compiled
programs (|ladder|^2 x plans worst case, far fewer in practice) and the
padding waste (<= ~33% per dim between rungs). This is the spatial
analogue of sequence-length bucketing in LLM serving (SURVEY.md §5
"long-context" mapping).

Batch sizes are quantized to powers of two so a partially-filled flush
reuses a warm program instead of compiling a fresh (plan, bucket, B).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Hashable

import numpy as np

# Rung ratios ~1.25-1.5x; max rung covers a 32 MiB upload's plausible pixels.
BUCKET_LADDER = (64, 128, 200, 256, 384, 512, 640, 768, 1024, 1280, 1536,
                 2048, 2560, 3072, 4096, 5120, 6144, 8192, 10240, 12288)

MAX_BATCH = 64


def bucket_dim(n: int) -> int:
    for rung in BUCKET_LADDER:
        if n <= rung:
            return rung
    return n  # beyond the ladder: exact size (compiles per shape, rare)


def bucket_for(h: int, w: int) -> tuple[int, int]:
    return bucket_dim(h), bucket_dim(w)


def quantize_batch(n: int, cap: int = MAX_BATCH) -> int:
    """Round up to the next power of two, capped."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


def coef_layout(fh: int, fw: int) -> str:
    """Layout tag for coefficient-plane items: subsampling is part of the
    grouping key (different modes need different canvas shapes)."""
    return f"coef:{fh}{fw}"


def coef_factors(layout: str) -> tuple[int, int]:
    return int(layout[5]), int(layout[6])


def coef_canvas(bucket: tuple[int, int], fh: int, fw: int
                ) -> tuple[int, int]:
    """Luma coefficient canvas for a bucket: padded up to the MCU grid
    (8*fh x 8*fw) so non-MCU-aligned ladder rungs (e.g. 200) still carry
    whole per-image MCU grids; the decoded pixels are cropped back to
    the bucket on device."""
    mh, mw = 8 * fh, 8 * fw
    return -(-bucket[0] // mh) * mh, -(-bucket[1] // mw) * mw


@dataclass
class BatchItem:
    """One decoded image waiting for device processing.

    layout='hwc': image is (h, w, 3). layout='chw': image is (3, hb, wb)
    already zero-padded to its resolution bucket (the native planar
    decoder writes straight into the bucket canvas) and `valid_hw`
    carries the true dims.
    """

    item_id: str               # task / image id, opaque to the batcher
    image: np.ndarray
    plan_key: Hashable
    payload: Any = None        # caller context (task, metadata, ...)
    layout: str = "hwc"
    valid_hw: tuple[int, int] | None = None
    # JpegSpliceContext when the source stream is splice-editable and the
    # plan wants a watermark rendition (runtime/splice.py); the engine's
    # finish stage then emits that rendition by region transcode instead
    # of a full re-encode. None otherwise.
    splice: Any = None
    enqueued_at: float = field(default_factory=time.monotonic)

    @property
    def hw(self) -> tuple[int, int]:
        if self.valid_hw is not None:
            return self.valid_hw
        return int(self.image.shape[0]), int(self.image.shape[1])


@dataclass
class Group:
    bucket: tuple[int, int]
    plan_key: Hashable
    items: list[BatchItem]

    @property
    def layout(self) -> str:
        return self.items[0].layout if self.items else "hwc"

    def pack(self, pad_batch_to: int | None = None
             ) -> tuple[np.ndarray, np.ndarray]:
        """Pad items into a batch canvas + (B, 2) valid dims.

        hwc items -> (B, Hb, Wb, 3); chw items (already bucket-padded by
        the planar decoder) -> (B, 3, Hb, Wb).
        """
        hb, wb = self.bucket
        n = len(self.items)
        b = pad_batch_to or n
        src_hw = np.zeros((b, 2), dtype=np.int32)
        if self.layout.startswith("coef"):
            # items carry (y, cb, cr, qtabs) int16/float32 coefficient
            # planes (each image's own MCU-aligned grid); pack them into
            # MCU-padded bucket canvases for the batched device IDCT.
            # The canvas exceeds the bucket up to one MCU per axis (e.g.
            # the 200 rung packs into 208 for 4:2:0); the device decode
            # crops back to the bucket.
            fh, fw = coef_factors(self.layout)
            ch, cw = coef_canvas((hb, wb), fh, fw)
            yc = np.zeros((b, ch, cw), dtype=np.int16)
            cbc = np.zeros((b, ch // fh, cw // fw), dtype=np.int16)
            crc = np.zeros((b, ch // fh, cw // fw), dtype=np.int16)
            qt = np.zeros((b, 3, 8, 8), dtype=np.float32)
            qt[:, :, 0, 0] = 1.0  # benign tables for pad rows
            cv = np.ones((b, 2), dtype=np.int32)  # chroma plane extents
            for i, it in enumerate(self.items):
                y, cb, cr, q = it.image
                yc[i, :y.shape[0], :y.shape[1]] = y
                cbc[i, :cb.shape[0], :cb.shape[1]] = cb
                crc[i, :cr.shape[0], :cr.shape[1]] = cr
                qt[i] = q
                cv[i] = cb.shape
                src_hw[i] = it.hw
            for i in range(n, b):
                src_hw[i] = src_hw[n - 1] if n else (1, 1)
            return (yc, cbc, crc, qt, cv), src_hw
        if self.layout == "chw":
            imgs = np.zeros((b, 3, hb, wb), dtype=np.uint8)
            for i, it in enumerate(self.items):
                imgs[i] = it.image
                src_hw[i] = it.hw
        else:
            imgs = np.zeros((b, hb, wb, 3), dtype=np.uint8)
            for i, it in enumerate(self.items):
                h, w = it.hw
                imgs[i, :h, :w] = it.image[:, :, :3]
                src_hw[i] = (h, w)
        # Duplicate the last real image into pad rows so the program never
        # sees (0,0) extents (harmless — pad outputs are discarded).
        for i in range(n, b):
            src_hw[i] = src_hw[n - 1] if n else (1, 1)
        return imgs, src_hw


def group_items(items: list[BatchItem],
                max_batch: int = MAX_BATCH) -> list[Group]:
    """Group by (bucket, plan, layout) preserving arrival order; split at
    max_batch."""
    buckets: dict[tuple, list[BatchItem]] = defaultdict(list)
    order: list[tuple] = []
    for it in items:
        key = (bucket_for(*it.hw), it.plan_key, it.layout)
        if key not in buckets:
            order.append(key)
        buckets[key].append(it)
    groups: list[Group] = []
    for key in order:
        chunk = buckets[key]
        for start in range(0, len(chunk), max_batch):
            groups.append(Group(bucket=key[0], plan_key=key[1],
                                items=chunk[start:start + max_batch]))
    return groups


class DeadlineBatcher:
    """Accumulates items and flushes groups on size or deadline.

    The latency lever for the p99 queue-to-processed target: a group
    flushes as soon as it reaches `batch_size` OR its oldest item has
    waited `deadline_ms` (deadline-triggered partial batches,
    SURVEY.md §7 hard part (d)).
    """

    def __init__(self, batch_size: int = 32, deadline_ms: float = 25.0,
                 max_batch: int = MAX_BATCH):
        self.batch_size = min(batch_size, max_batch)
        self.deadline_s = deadline_ms / 1000.0
        self._pending: dict[tuple, list[BatchItem]] = defaultdict(list)

    def add(self, item: BatchItem) -> Group | None:
        key = (bucket_for(*item.hw), item.plan_key, item.layout)
        q = self._pending[key]
        q.append(item)
        if len(q) >= self.batch_size:
            del self._pending[key]
            return Group(bucket=key[0], plan_key=key[1], items=q)
        return None

    def due(self, now: float | None = None) -> list[Group]:
        now = time.monotonic() if now is None else now
        out = []
        for key in list(self._pending):
            q = self._pending[key]
            if q and now - q[0].enqueued_at >= self.deadline_s:
                del self._pending[key]
                out.append(Group(bucket=key[0], plan_key=key[1], items=q))
        return out

    def flush_all(self) -> list[Group]:
        out = [Group(bucket=k[0], plan_key=k[1], items=q)
               for k, q in self._pending.items() if q]
        self._pending.clear()
        return out

    def next_deadline(self, now: float | None = None) -> float | None:
        """Seconds until the earliest pending deadline (None if empty)."""
        now = time.monotonic() if now is None else now
        earliest = None
        for q in self._pending.values():
            if q:
                t = q[0].enqueued_at + self.deadline_s - now
                earliest = t if earliest is None else min(earliest, t)
        return earliest

    def pending_count(self) -> int:
        return sum(len(q) for q in self._pending.values())
