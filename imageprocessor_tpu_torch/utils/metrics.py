# Copy of imageprocessor_tpu/utils/metrics.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Lightweight process metrics: counters + streaming histograms.

The reference has no metrics subsystem (SURVEY.md §5 — only log-line
durations); this framework exposes per-stage counters/latency percentiles
at GET /api/metrics and from the worker's periodic stats line. Lock-light:
one mutex, bounded reservoir per histogram.
"""

from __future__ import annotations

import random
import threading
from collections import defaultdict


class Metrics:
    _RESERVOIR = 2048

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._samples: dict[str, list[float]] = defaultdict(list)
        self._counts: dict[str, int] = defaultdict(int)
        # the running sum of every value observed, beside the reservoir:
        # a per-item time over a period is sum / count, which no
        # percentile gives
        self._sums: dict[str, float] = defaultdict(float)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._counts[name] += 1
            self._sums[name] += value
            samples = self._samples[name]
            if len(samples) < self._RESERVOIR:
                samples.append(value)
            else:  # reservoir sampling keeps percentiles unbiased
                j = random.randrange(self._counts[name])
                if j < self._RESERVOIR:
                    samples[j] = value

    def snapshot(self) -> dict:
        # Copy under the lock, sort OUTSIDE it: sorting ~10 reservoirs
        # of 2048 samples under the one global mutex stalls every
        # hot-path observe()/inc() for the whole scrape on the 1-core
        # host.
        with self._lock:
            counters = dict(self._counters)
            counts = dict(self._counts)
            sums = dict(self._sums)
            sampled = {name: list(s) for name, s in self._samples.items()
                       if s}
        out: dict = {"counters": counters, "timings": {}}
        for name, samples in sampled.items():
            s = sorted(samples)
            n = len(s)
            out["timings"][name] = {
                "count": counts.get(name, n),
                "p50": s[n // 2],
                "p90": s[min(int(n * 0.9), n - 1)],
                "p99": s[min(int(n * 0.99), n - 1)],
                "max": s[-1],
                "sum": sums[name],
            }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (0.0.4) of the same snapshot the
        JSON endpoint serves: counters as counters, timing reservoirs as
        quantile gauges + a _count counter."""
        def norm(name: str) -> str:
            clean = "".join(ch if ch.isalnum() or ch == "_" else "_"
                            for ch in name)
            return f"imageprocessor_{clean}"

        snap = self.snapshot()
        lines: list[str] = []
        for name, value in sorted(snap["counters"].items()):
            m = norm(name)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {value}")
        for name, t in sorted(snap["timings"].items()):
            m = norm(name)
            lines.append(f"# TYPE {m} summary")
            for q_label, key in (("0.5", "p50"), ("0.9", "p90"),
                                 ("0.99", "p99")):
                lines.append(
                    f'{m}{{quantile="{q_label}"}} {t[key]}')
            lines.append(f"{m}_count {t['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._samples.clear()
            self._counts.clear()
            self._sums.clear()


METRICS = Metrics()
