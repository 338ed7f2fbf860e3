"""One run of a cell with the program's own span recording on, and the
checks of that instrumentation against the card's trace.

    python3 -m perfbench.spancheck --workload <cell> --seed <n> --seconds <s> [--trace 0|1]

The run is ``perfbench.run``'s, with the program's recording
(``imageprocessor_tpu_torch.utils.tracing.record``) switched on as the
window opens and off as the trace ends. The last line of standard output
is one JSON object: the run's metrics and ``correct``, the spans an upload
and, traced, the checks:

* ``busy_in_device_span``: the share of the card's busy time inside the
  program's ``device`` spans (all of it is launched there);
* ``htod_in_h2d_span``: the share of the trace's host-to-device copy time
  inside the program's ``h2d`` spans;
* ``idle_unspanned_share``: the share of the card's idle time under no
  program span at all;
* ``program_over_wrapper``: the program's ``decode``, ``device`` and
  ``encode`` sums over the harness's wrappers' sums, in the window;
* ``idle_gaps``: the ten longest idle gaps, each labelled by the innermost
  program span that overlaps it most, and ``idle_under_s``: the card's
  idle seconds under each span's own time (its interval less its
  children's, the threads merged).

The two clocks agree because a span's start and end come from
``time.time_ns()`` and the trace's events from its
``baseTimeNanoseconds`` plus their ``ts``. A program without recording
exits 2 with no result.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench import tracing

# the program's spans the harness's wrappers also time
WRAPPED = {"decode": "decode_for_plan_ex", "device": "device_group",
           "encode": "finish_item"}


def spans_s(records) -> list[tracing.Span]:
    """The program's records as spans in seconds; ``info`` keeps their
    attributes and their id and parent's id under ``_id``, ``_parent``."""
    return [tracing.Span(r.name, r.start_ns / 1e9, r.end_ns / 1e9,
                         {**r.attrs, "_id": r.id, "_parent": r.parent})
            for r in records]


def own_time(spans: list[tracing.Span]) -> dict[str, list[tuple[float, float]]]:
    """Each name's own time, threads merged: every span's interval less
    its children's."""
    kids: dict[int, list[tuple[float, float]]] = {}
    for s in spans:
        if s.info["_parent"] is not None:
            kids.setdefault(s.info["_parent"], []).append((s.t0, s.t1))
    out: dict[str, list[tuple[float, float]]] = {}
    for s in spans:
        t, parts = s.t0, out.setdefault(s.name, [])
        for a, b in tracing.union(kids.get(s.info["_id"], [])):
            if a > t:
                parts.append((t, a))
            t = max(t, b)
        if s.t1 > t:
            parts.append((t, s.t1))
    return {name: tracing.union(parts) for name, parts in out.items()}


def overlap(intervals, a: float, b: float) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in intervals)


def label(gap: tuple[float, float], own: dict[str, list]) -> str:
    """The innermost program span that overlaps the gap most: the name
    whose own time covers most of it, or "no span"."""
    cover = {name: overlap(parts, *gap) for name, parts in own.items()}
    cover = {k: v for k, v in cover.items() if v > 0}
    return max(cover, key=cover.get) if cover else "no span"


def checks(spans: list[tracing.Span], events, wrappers: tracing.Spans,
           lo: float, hi: float) -> dict:
    """The checks of the module docstring over the window [lo, hi];
    ``events`` are the trace's (name, category, start, end)."""
    busy_iv = [(a, b) for _n, _c, a, b in events]
    busy = tracing.busy_seconds(busy_iv, lo, hi)
    device = tracing.union((s.t0, s.t1) for s in spans if s.name == "device")
    busy_in = sum(tracing.busy_seconds(busy_iv, a, b) for a, b in device)
    htod = [(a, b) for n, _c, a, b in events if "HtoD" in n]
    h2d = tracing.union((s.t0, s.t1) for s in spans if s.name == "h2d")
    htod_s = sum(b - a for a, b in htod)
    htod_in = sum(overlap(h2d, a, b) for a, b in htod)
    gaps = tracing.idle_gaps(busy_iv, lo, hi)
    idle = sum(b - a for a, b in gaps)
    spanned = tracing.union((s.t0, s.t1) for s in spans)
    idle_spanned = sum(overlap(spanned, a, b) for a, b in gaps)
    inside = [s for s in spans if s.t0 >= lo and s.t1 <= hi]
    ratios = {}
    for name, wrapped in WRAPPED.items():
        prog = sum(s.t1 - s.t0 for s in inside if s.name == name)
        wrap = sum(s.t1 - s.t0 for s in wrappers.of(wrapped, lo, hi))
        ratios[name] = prog / wrap if wrap else None
    own = own_time(spans)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"busy_in_device_span": busy_in / busy if busy else None,
            "htod_in_h2d_span": htod_in / htod_s if htod_s else None,
            "idle_unspanned_share": 1.0 - idle_spanned / idle if idle else None,
            "program_over_wrapper": ratios,
            "idle_gaps": [[label(g, own), g[1] - g[0]] for g in longest],
            "idle_under_s": {name: sum(overlap(parts, a, b) for a, b in gaps)
                             for name, parts in sorted(own.items())}}


def main(argv=None) -> int:
    from perfbench import harness

    t_start = harness.process_start_monotonic()
    p = argparse.ArgumentParser(prog="python3 -m perfbench.spancheck")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    import torch

    from imageprocessor_tpu_torch.utils import tracing as program

    if not hasattr(program, "record") or not torch.cuda.is_available():
        print("perfbench.spancheck: needs a CUDA card and a program that "
              "records its spans", file=sys.stderr)
        return 2
    kept: dict = {}
    begin, end = harness.Run.begin_window, harness.Run.end_trace

    def begin_recording(run):
        program.record()
        return begin(run)

    def end_recording(run):
        end(run)
        kept.setdefault("records", list(program.stop_recording()))

    harness.Run.begin_window, harness.Run.end_trace = begin_recording, end_recording
    try:
        line, run = harness.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), "cuda:0", t_start)
    finally:
        harness.Run.begin_window, harness.Run.end_trace = begin, end
    spans = spans_s(kept.get("records", []))
    uploads = sum(1 for s in spans if s.name == "record")
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
           "correct": line["correct"], "card": run.power_limit,
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "spans": len(spans), "spans_per_upload": len(spans) / uploads if uploads else None}
    if args.trace:
        out.update(checks(spans, run.device_events, run.spans, run.trace_lo, run.trace_hi))
    print(harness.describe(run), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
