"""The queue worker's `record` spans (one upload's processed rows and
status written, its message acked or nacked, its result produced)
summed, over the uploads recorded. Read from the program's own metrics
over the window and the drain after it, as pack_ms_per_image."""

LAYER = "queue worker"
UNIT, SOURCE, MOVES = "ms/image", "program_span", "images_per_s"


def read(run):
    t = run.snapshot.get("timings", {}).get("span_record_ms", {})
    return t["sum"] / t["count"] if "sum" in t else None
