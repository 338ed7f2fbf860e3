"""Spans around the engine's entry points, and the card's trace.

A traced run wraps, at run time and on the worker's engine instance only,
the three entry points both workers call: ``decode_for_plan_ex`` (the
host scan of one upload), ``device_group`` (pack, copies and kernels of
one group) and ``finish_item`` (encode, splice and store of one upload).
Each call leaves a span in memory: name, start and end on the wall
clock, and what it worked on.

The card's busy time is the union of its kernel, copy and set intervals
over every stream, so that two streams running at once count once. An
idle gap is labelled by the wrapped stage that overlapped it most.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Span:
    name: str
    t0: float          # time.time(), seconds
    t1: float
    info: dict = field(default_factory=dict)


class Spans:
    def __init__(self):
        self.items: list[Span] = []
        self._lock = threading.Lock()

    def wrap(self, obj, name: str, info=None) -> None:
        """Replace ``obj.name`` by a wrapper that records a span per call;
        ``info(args, kwargs)`` says what the call worked on."""
        orig = getattr(obj, name)

        def wrapped(*args, **kwargs):
            t0 = time.time()
            try:
                return orig(*args, **kwargs)
            finally:
                span = Span(name, t0, time.time(),
                            info(args, kwargs) if info else {})
                with self._lock:
                    self.items.append(span)

        setattr(obj, name, wrapped)

    def of(self, name: str, lo: float = float("-inf"),
           hi: float = float("inf")) -> list[Span]:
        with self._lock:
            return [s for s in self.items if s.name == name
                    and s.t0 >= lo and s.t1 <= hi]


def group_info(args, kwargs) -> dict:
    """What a ``device_group(group)`` call ran: its real images' (h, w),
    its layout and its plan's operation types."""
    group = args[0] if args else kwargs["group"]
    plan = group.items[0].payload[3]
    return {"hw": [tuple(int(v) for v in it.hw) for it in group.items],
            "layout": group.layout,
            "ops": [op.type.value for op in plan.ops]}


def instrument(engine, spans: Spans) -> None:
    spans.wrap(engine, "decode_for_plan_ex")
    spans.wrap(engine, "device_group", group_info)
    spans.wrap(engine, "finish_item")


def device_events(trace_path: str) -> list[tuple[str, str, float, float]]:
    """(name, category, start, end) of every kernel, copy and set in a
    Chrome trace written by torch.profiler, on the wall clock in seconds
    (the trace's microseconds plus its ``baseTimeNanoseconds``)."""
    with open(trace_path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds", 0) / 1e9
    out = []
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            t0 = base + float(e["ts"]) / 1e6
            out.append((e["name"], e["cat"], t0, t0 + float(e.get("dur", 0)) / 1e6))
    return out


def union(intervals) -> list[tuple[float, float]]:
    """The merged cover of (start, end) intervals, in order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def busy_seconds(intervals, lo: float, hi: float) -> float:
    return sum(b - a for a, b in clip(union(intervals), lo, hi))


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The gaps in [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for a, b in clip(union(intervals), lo, hi):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label(gap: tuple[float, float], spans: list[Span]) -> str:
    """The wrapped stage that overlapped the gap most, or "no stage"."""
    a, b = gap
    cover: dict[str, float] = {}
    for s in spans:
        o = min(b, s.t1) - max(a, s.t0)
        if o > 0:
            cover[s.name] = cover.get(s.name, 0.0) + o
    return max(cover, key=cover.get) if cover else "no stage"
