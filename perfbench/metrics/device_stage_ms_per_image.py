"""Summed time in the engine's `device_group` (pack, copies, kernels and
the copies back of one group) over the groups' real images in the
traced window."""

LAYER = "device stage"
UNIT, SOURCE, MOVES = "ms/image", "program_span", "images_per_s"


def read(run):
    spans = run.spans.of("device_group", run.trace_lo, run.trace_hi)
    n = sum(len(s.info["hw"]) for s in spans)
    return 1000.0 * sum(s.t1 - s.t0 for s in spans) / n if n else None
