"""The 95th percentile of due time to `completed` over every upload due in
an open-loop window; an upload that failed or never finished is
infinitely late."""

from perfbench.common import percentile

UNIT, SOURCE = "ms", "host_clock"


def read(run):
    return percentile(run.latency_ms, 0.95) if run.latency_ms else None
