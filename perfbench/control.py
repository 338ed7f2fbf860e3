"""The control: the program with its own lower-precision path switched on.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 [--seconds 10]
        [--quality 75]

One process, one run of the cell per seed (each with its own set-up), on
the card. Each run is the benchmark's own run with one change: once the
members are built, each one's engine stores every JPEG it encodes at ``--quality``
(the engine's ``jpeg_quality``) in place of the configuration's 85, the
lower-precision step (coarser quantization, fewer coefficients to emit)
that would tempt a later change. Each seed prints its checks and
``correct``, which has to come out false. The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench import harness


def lower_quality(quality: int):
    """An ``on_worker`` hook: every member's engine encodes at ``quality``."""

    def hook(run):
        for w in run.workers:
            w.engine.jpeg_quality = int(quality)

    return hook


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--quality", type=int, default=75)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        line, run = harness.run_cell(args.workload, seed, args.seconds, False, "cuda:0",
                                     on_worker=lower_quality(args.quality))
        print(json.dumps({"seed": seed, "quality": args.quality,
                          "correct": line["correct"], "attempted": line["attempted"],
                          "sampled": run.extra["sampled"],
                          "checks": {k: c["value"] for k, c in line["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
