"""Stage tracing: spans, their records, and torch.profiler integration.

The counterpart of imageprocessor_tpu/utils/tracing.py, written for
torch (the one utils module that is not a copy). Every pipeline stage
can be wrapped in `span(...)`, which always feeds the `span_<name>_ms`
metrics histogram (GET /api/metrics). While a torch.profiler runs it
also marks the stage in the profiler's timeline, so host stages line up
with the card's kernels in a Chrome trace (chrome://tracing, Perfetto).
While recording is on (`record()` to `stop_recording()`), each span also
leaves a `SpanRecord`: its name, its parent span on the same thread, the
thread, start and end from `time.time_ns()` (the clock of a Chrome
trace's ``baseTimeNanoseconds`` + ``ts``) and its attributes. With
neither on, a span costs two flag tests and the metrics observe.

    with span("decode", image_id=i) as attrs:
        ...
        attrs["layout"] = layout          # attributes known inside
    spans = record()                      # keep every span from here ...
    stop_recording()                      # ... to here
    with profile_capture("/tmp/trace"):   # writes a Chrome trace
        engine.process_tasks(batch)
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass

import torch
import torch.autograd.profiler as _profiler

from imageprocessor_tpu_torch.utils.metrics import METRICS


@dataclass(slots=True)
class SpanRecord:
    name: str
    id: int
    parent: int | None     # the enclosing span's id on the same thread
    thread: int            # threading.get_ident()
    start_ns: int          # time.time_ns()
    end_ns: int
    attrs: dict


_records: list[SpanRecord] | None = None
_ids = itertools.count(1)
_open = threading.local()   # .ids: the ids of this thread's open spans


def record() -> list[SpanRecord]:
    """Switch recording on: every span that starts from now until
    `stop_recording()` is appended, as it ends, to the returned list."""
    global _records
    _records = []
    return _records


def stop_recording() -> list[SpanRecord]:
    """Switch recording off; returns what was recorded. A span that
    started while recording was on is still appended when it ends."""
    global _records
    out, _records = _records, None
    return out if out is not None else []


def _open_ids() -> list[int]:
    ids = getattr(_open, "ids", None)
    if ids is None:
        ids = _open.ids = []
    return ids


class span:
    """``with span(name, **attrs) as attrs:`` times a host stage; the
    block may add to ``attrs`` what it learns (a recorded span keeps
    them)."""

    __slots__ = ("name", "attrs", "_t0", "_rf", "_into", "_id", "_parent",
                 "_start_ns")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> dict:
        self._into = _records
        if self._into is not None:
            ids = _open_ids()
            self._parent = ids[-1] if ids else None
            self._id = next(_ids)
            ids.append(self._id)
            self._start_ns = time.time_ns()
        self._t0 = time.monotonic()
        # the profiler's own mark lies inside the span's times
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self.attrs

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        METRICS.observe(f"span_{self.name}_ms",
                        (time.monotonic() - self._t0) * 1000.0)
        if self._into is not None:
            end = time.time_ns()
            _open_ids().pop()
            self._into.append(SpanRecord(
                self.name, self._id, self._parent, threading.get_ident(),
                self._start_ns, end, self.attrs))
        return False


@contextlib.contextmanager
def profile_capture(log_dir: str):
    """Profile a block (host, and the card when there is one) and write a
    Chrome trace into ``log_dir`` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
