"""Summed time in the engine's `finish_item` (encodes, the watermark
splice and the store's saves of one upload) over the uploads it finished
in the traced window."""

LAYER = "finish stage"
UNIT, SOURCE, MOVES = "ms/image", "program_span", "images_per_s"


def read(run):
    spans = run.spans.of("finish_item", run.trace_lo, run.trace_hi)
    return 1000.0 * sum(s.t1 - s.t0 for s in spans) / len(spans) if spans else None
