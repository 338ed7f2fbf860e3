"""The queue worker's `ack` spans (one upload's ack or nack: with the
Kafka client a synchronous OffsetCommit, lock wait included; with the
SQLite broker a committed write; in memory a dict update) summed, over
their count. Read from the program's own metrics over the window and
the drain after it, as record_ms_per_image, whose spans hold these."""

LAYER = "queue worker"
UNIT, SOURCE, MOVES = "ms/image", "program_span", "images_per_s"


def read(run):
    t = run.snapshot.get("timings", {}).get("span_ack_ms", {})
    return t["sum"] / t["count"] if "sum" in t else None
