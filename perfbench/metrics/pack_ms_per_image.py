"""The program's `pack` spans (Group.pack: a device group's rows copied
into the batch's host canvases) summed, over the images they packed
(`engine_pack_images`). Read from the program's own metrics, which the
harness resets as the window opens and reads once the worker has
stopped: the window and the drain after it."""

LAYER = "device stage"
UNIT, SOURCE, MOVES = "ms/image", "program_span", "images_per_s"


def read(run):
    t = run.snapshot.get("timings", {}).get("span_pack_ms", {})
    n = run.snapshot.get("counters", {}).get("engine_pack_images", 0)
    return t["sum"] / n if "sum" in t and n else None
