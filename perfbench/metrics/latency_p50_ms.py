"""The median of due time to `completed` over every upload due in an
open-loop window, as latency_p95_ms counts it."""

from perfbench.common import percentile

UNIT, SOURCE = "ms", "host_clock"


def read(run):
    return percentile(run.latency_ms, 0.50) if run.latency_ms else None
