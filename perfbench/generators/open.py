"""Open-loop arrivals at a fixed rate: users who do not wait for each other.

Every seed gets the same work: round(rate * seconds) uploads spanning
exactly ``seconds``. Their gaps are those of a Poisson process, the
exponential distribution's quantiles scaled to the window, in an order
the seed sets; so every seed has the same set of gaps and no seed sends
a lighter or a heavier window. The mix is a fixed round of its entries
by their shares (nine small uploads, then one large), and the seed picks
the originals. The schedule never waits on the program: a thread
submits each upload at its due time, and each is timed from that due
time to its answer on the results topic. An upload that fails, or is not
answered by ``drain_s`` after the window, counts as infinitely late.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from perfbench.common import percentile


def schedule(traffic: dict, seed: int, seconds: float) -> list[tuple[float, str, int, list]]:
    """[(due offset s, pool, index, flags)] in due order."""
    rng = np.random.default_rng(seed)
    rate = float(traffic["rate_per_s"])
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps * (seconds / gaps.sum()))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    mix = traffic["mix"]
    rounds = [k for k, m in enumerate(mix) for _ in range(int(m["share"]))]
    kinds = [rounds[i % len(rounds)] for i in range(n)]
    cursors = {m["pool"]: 0 for m in mix}
    orders = {p: rng.permutation(int(traffic["pools"][p]["count"])) for p in cursors}
    out = []
    for t, k in zip(due, kinds):
        m = mix[k]
        order = orders[m["pool"]]
        out.append((float(t), m["pool"], int(order[cursors[m["pool"]] % len(order)]),
                    list(m["flags"])))
        cursors[m["pool"]] += 1
    return out


def latencies_ms(due: dict, results: dict) -> list[float]:
    """Due time to the first answer, in ms, sorted; inf for an upload
    with no answer or whose answer is not `completed`."""
    out = []
    for i, t in due.items():
        got = results.get(i)
        out.append((got[0][0] - t) * 1000.0 if got and got[0][1] == "completed"
                   else math.inf)
    return sorted(out)


def drive(run) -> None:
    plan = schedule(run.traffic, run.seed, run.seconds)
    due: dict[str, float] = {}
    late: list[float] = []
    t0 = run.begin_window()

    def send():
        for off, kind, idx, flags in plan:
            t = t0 + off
            wait = t - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            late.append((time.monotonic() - t) * 1000.0)
            due[run.submit(run.pools[kind][idx], flags)] = t

    sender = threading.Thread(target=send, name="arrivals")
    sender.start()
    sender.join()
    run.wait_done(list(due), t0 + run.seconds + float(run.traffic["drain_s"]))
    run.end_trace()
    run.judged = list(due)
    run.due = list(due.values())
    run.latency_ms = latencies_ms(due, run.results)
    run.lateness_ms = sorted(late)
    run.extra["lateness_ms_p99"] = percentile(run.lateness_ms, 0.99)
    run.attempted = len(due)
    run.failed = sum(1 for x in run.latency_ms if math.isinf(x))
    run.rate = (len(due) - run.failed) / max(
        max((run.results[i][0][0] for i in due if i in run.results), default=t0) - t0,
        1e-9)
    run.extra["served_per_s"] = run.rate
    run.extra["latency_p99_ms"] = percentile(run.latency_ms, 0.99)
