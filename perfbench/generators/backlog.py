"""A full queue: the worker never waits for work.

A feeder thread keeps ``depth`` uploads outstanding (submitted and not
yet answered on the results topic), drawing them from the traffic's mix
in an order the seed sets. The window runs from the first completion at
or after the feed starts to the first completion at or after
``seconds`` later; the rate is the completions in (start, end] over the
window's length. A batch worker answers a whole call at once, so edges
taken at completions count whole calls. Then the feed stops and what is
outstanding drains, up to ``drain_s``: every upload submitted is judged,
and one never answered counts as failed.
"""

from __future__ import annotations

import threading
import time

import numpy as np


def stream(traffic: dict, seed: int):
    """Endless (pool, index, flags): each mix entry's share of every
    round, the originals of each pool in a seeded order, cycled."""
    rng = np.random.default_rng(seed)
    mix = traffic["mix"]
    rounds = [k for k, m in enumerate(mix) for _ in range(int(m["share"]))]
    cursors = {m["pool"]: 0 for m in mix}
    orders = {p: rng.permutation(int(traffic["pools"][p]["count"])) for p in cursors}
    while True:
        for k in rng.permutation(rounds):
            m = mix[k]
            order = orders[m["pool"]]
            yield m["pool"], int(order[cursors[m["pool"]] % len(order)]), list(m["flags"])
            cursors[m["pool"]] += 1


def window(done: list[tuple[float, str]], start: float, seconds: float):
    """(t0, t1, ids) from (time, id) completions in time order: t0 the
    first at or after ``start``, t1 the first at or after t0 + seconds,
    ids those in (t0, t1]; None while the log does not reach t1."""
    t0 = next((t for t, _ in done if t >= start), None)
    if t0 is None:
        return None
    t1 = next((t for t, _ in done if t >= t0 + seconds), None)
    if t1 is None:
        return None
    return t0, t1, [i for t, i in done if t0 < t <= t1]


def drive(run) -> None:
    depth = int(run.traffic["depth"])
    items = stream(run.traffic, run.seed)
    stop = threading.Event()
    submitted: list[str] = []

    def feed():
        while not stop.is_set():
            with run.cond:
                outstanding = len(submitted) - sum(1 for i in submitted
                                                   if i in run.results)
                if outstanding >= depth:
                    run.cond.wait(0.05)
                    continue
            for _ in range(depth - outstanding):
                kind, idx, flags = next(items)
                submitted.append(run.submit(run.pools[kind][idx], flags))

    start = run.begin_window()
    feeder = threading.Thread(target=feed, name="feeder")
    feeder.start()
    drain_s = float(run.traffic["drain_s"])
    try:
        deadline = start + run.seconds + drain_s
        while True:
            with run.cond:
                done = sorted((run.results[i][0][0], i) for i in submitted
                              if i in run.results)
                got = window(done, start, run.seconds)
                if got is not None or time.monotonic() > deadline:
                    break
                run.cond.wait(0.2)
    finally:
        stop.set()
        feeder.join()
    run.end_trace()
    if got is None:   # the window never closed: judge what came
        got = (start, time.monotonic(), [i for _t, i in done])
        run.extra["window_closed"] = False
    t0, t1, ids = got
    run.wait_done(list(submitted), time.monotonic() + drain_s)
    run.rate = len(ids) / (t1 - t0)
    run.judged = list(submitted)
    run.attempted = len(submitted)
    run.failed = sum(1 for i in submitted
                     if run.results.get(i, [(0, "")])[0][1] != "completed")
    run.extra["in_window"] = len(ids)
