"""Summed time in the engine's `decode_for_plan_ex` (the host scan of one
upload) over the uploads it scanned in the traced window."""

LAYER = "engine decode stage"
UNIT, SOURCE, MOVES = "ms/image", "program_span", "images_per_s"


def read(run):
    spans = run.spans.of("decode_for_plan_ex", run.trace_lo, run.trace_hi)
    return 1000.0 * sum(s.t1 - s.t0 for s in spans) / len(spans) if spans else None
