"""Run one cell of the port's benchmark once, on the card.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's other numbers on earlier
lines and, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; last, ``checks``: each number
compared with its limit, which also end standard error. Without a CUDA
card, or with fewer than the cell asks for, it prints no result and
exits 2; it never falls back to the CPU. If, once the run is over,
``sys.modules`` holds JAX or the JAX package (top-level names compared
whole), it names them on standard error, prints no result and exits 3.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from perfbench import harness, spec

    t_start = harness.process_start_monotonic()
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, run = harness.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda:0", t_start, bench=bench)
    print(harness.describe(run), flush=True)
    # last, once the checks and every metric's reader have been imported
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or the JAX package are loaded: {found}; "
              "no result", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
