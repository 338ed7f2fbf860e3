"""Find an open-loop cell's rate: the same cell at several fixed rates.

    python3 -m perfbench.sweep --workload <open cell> --rates 20,40,60
        [--seconds 20] [--seed 1]

One process, one run of the cell per rate (each with its own set-up),
on the card. Prints a line per rate: the latency percentiles over every
upload due in the window, the served rate, and how the median of the
last quarter of uploads compares with the first quarter's (a backlog
that grows through the window shows as a ratio well above 1). The
highest rate whose p99 meets the reference's 500 ms queue-to-processed
target with no growing backlog is the knee; an open cell runs at 0.8 of
it, written in its ``cells/<workload>.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch

from perfbench import common, harness


def summary(run) -> dict:
    lat = run.latency_ms
    due_order = [run.results.get(i) for i in run.judged]
    n = len(due_order)

    def med(part):
        vals = [(got[0][0] - t) * 1000.0 if got else float("inf")
                for got, t in part]
        return statistics.median(vals) if vals else float("nan")

    pairs = list(zip(due_order, run.due))
    q = max(n // 4, 1)
    return {"rate_per_s": run.traffic["rate_per_s"], "n": n, "failed": run.failed,
            "p50_ms": common.percentile(lat, 0.5), "p95_ms": common.percentile(lat, 0.95),
            "p99_ms": common.percentile(lat, 0.99), "max_ms": lat[-1],
            "served_per_s": run.rate,
            "last_over_first_quarter_p50": med(pairs[-q:]) / med(pairs[:q]),
            "lateness_p99_ms": common.percentile(run.lateness_ms, 0.99)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        line, run = harness.run_cell(args.workload, args.seed + k, args.seconds, False,
                                     "cuda:0", traffic_overrides={"rate_per_s": rate})
        print(json.dumps({**summary(run), "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
