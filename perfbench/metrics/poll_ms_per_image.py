"""The queue worker's `poll` spans (the broker's poll, one per call) and
`fetch` spans (one original's get from the object store) summed, over
the uploads fetched. Read from the program's own metrics over the window
and the drain after it, as pack_ms_per_image."""

LAYER = "queue worker"
UNIT, SOURCE, MOVES = "ms/image", "program_span", "images_per_s"


def read(run):
    t = run.snapshot.get("timings", {})
    poll, fetch = t.get("span_poll_ms", {}), t.get("span_fetch_ms", {})
    if "sum" not in poll or "sum" not in fetch:
        return None
    return (poll["sum"] + fetch["sum"]) / fetch["count"]
