"""The queue worker's `publish` spans (one upload's result produced to
the results topic: with the Kafka client a Produce round trip, lock wait
included) summed, over their count. Read from the program's own metrics
over the window and the drain after it, as record_ms_per_image, whose
spans hold these."""

LAYER = "queue worker"
UNIT, SOURCE, MOVES = "ms/image", "program_span", "images_per_s"


def read(run):
    t = run.snapshot.get("timings", {}).get("span_publish_ms", {})
    return t["sum"] / t["count"] if "sum" in t else None
