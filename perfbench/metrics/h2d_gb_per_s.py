"""The bytes the program copied host to device (`engine_h2d_bytes`) over
the summed time of its `h2d` spans, one per copy: the rate of the device
stage's uploads, in 10**9 bytes a second. Read from the program's own
metrics over the window and the drain after it, as pack_ms_per_image."""

LAYER = "device stage"
UNIT, SOURCE, MOVES = "GB/s", "program_span", "images_per_s"


def read(run):
    t = run.snapshot.get("timings", {}).get("span_h2d_ms", {})
    n = run.snapshot.get("counters", {}).get("engine_h2d_bytes", 0)
    return n / t["sum"] / 1e6 if t.get("sum") and n else None
