"""Reused host staging for what the device stage copies to the card per
coefficient upload.

On a card the engine stages each baseline JPEG upload's destuffed
entropy-coded bytes in a slab of this pool for kernel B0 (``take_bytes``);
an upload the host scans instead has its quantized coefficients (its own
MCU grid: Y, Cb, Cr) scanned into one (``take``). The device stage copies
from the slab straight into the group's buffer on the card
(runtime/engine.py ``_stage_coefs``). On a card the slabs are
page-locked, so those copies are DMA transfers the host neither stages
nor waits for one by one; on the CPU they are plain numpy memory and the
recycling is the same.

A slab is one flat int16 array; an upload's planes are views of its
start, one after the other, and its stream a byte view of its start.
Slabs are allocated lazily, each once, at a
power of two of bytes (the pinned allocator rounds to one anyway), and
at most ``cap`` are alive. The pool hands a slab out by its planes and
takes it back by the first of them (its address is the slab's). A slab
that is never given back is freed with its last view, and the pool may
allocate another in its place: nothing handed out is ever reused while
it is still out.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch


class SlabPool:
    def __init__(self, cap: int, pinned: bool):
        self.cap = cap
        self.pinned = pinned
        self._lock = threading.Lock()
        self._free: list[np.ndarray] = []
        # a slab's address -> the slab, while it is out
        self._out: weakref.WeakValueDictionary = weakref.WeakValueDictionary()

    def _new(self, n: int) -> np.ndarray:
        size = 1 << (2 * n - 1).bit_length() >> 1   # int16s in 2**k bytes
        if self.pinned:
            return torch.empty(size, dtype=torch.int16, pin_memory=True).numpy()
        return np.empty(size, dtype=np.int16)

    def take(self, shapes) -> list[np.ndarray] | None:
        """Zeroed C-contiguous int16 planes of ``shapes``, views of one
        slab; None when every slab the pool may hold is out."""
        n = sum(h * w for h, w in shapes)
        slab = self._slab(n)
        if slab is None:
            return None
        slab[:n] = 0
        planes, at = [], 0
        for h, w in shapes:
            planes.append(slab[at:at + h * w].reshape(h, w))
            at += h * w
        return planes

    def take_bytes(self, n: int) -> np.ndarray | None:
        """``n`` bytes of one slab, as uint8 and not zeroed; None when
        every slab the pool may hold is out."""
        slab = self._slab((n + 1) // 2)
        return None if slab is None else slab.view(np.uint8)[:n]

    def _slab(self, n: int) -> np.ndarray | None:
        """A slab of at least ``n`` int16s, now out."""
        with self._lock:
            fits = [k for k, s in enumerate(self._free) if s.size >= n]
            if fits:   # the smallest slab that holds the planes
                slab = self._free.pop(min(fits, key=lambda k: self._free[k].size))
            elif len(self._free) + len(self._out) < self.cap:
                slab = self._new(n)
            elif self._free:   # every free slab is too small: replace one
                self._free.pop()
                slab = self._new(n)
            else:
                return None
            self._out[slab.ctypes.data] = slab
        return slab

    def owns(self, plane: np.ndarray) -> bool:
        """Whether ``plane`` is the first plane of a slab that is out."""
        return plane.ctypes.data in self._out

    def give(self, plane: np.ndarray) -> None:
        """Take back the slab whose first plane is ``plane``, once nothing
        reads or copies its planes any more (no-op for any other array)."""
        with self._lock:
            slab = self._out.pop(plane.ctypes.data, None)
            if slab is not None:
                self._free.append(slab)

    def slabs(self) -> tuple[int, int]:
        """(slabs free, slabs out)."""
        with self._lock:
            return len(self._free), len(self._out)
