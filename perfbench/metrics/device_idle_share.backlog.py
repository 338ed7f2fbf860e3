"""The share of the traced window in which the card ran no kernel, copy
or set on any stream (one minus the union of those intervals)."""

from perfbench import tracing

LAYER = "device"
UNIT, SOURCE, MOVES = "%", "device_trace", "images_per_s"


def read(run):
    if not run.device_events or run.traffic["kind"] != "backlog":
        return None
    busy = tracing.busy_seconds([(a, b) for _n, _c, a, b in run.device_events],
                                run.trace_lo, run.trace_hi)
    return 100.0 * (1.0 - busy / (run.trace_hi - run.trace_lo))
