"""p99 of the program's `queue_wait_ms`: produce to poll, which both
workers record for every message they take (a reservoir of 2048)."""

LAYER = "queue worker"
UNIT, SOURCE, MOVES = "ms", "program_counter", "latency_p95_ms"


def read(run):
    t = run.snapshot.get("timings", {}).get("queue_wait_ms")
    return t["p99"] if t else None
