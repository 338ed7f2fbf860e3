"""Images completed per second over a backlog window, every variant of
each stored and recorded (generators/backlog.py sets the window)."""

UNIT, SOURCE = "images/s", "host_clock"


def read(run):
    return run.rate if run.traffic["kind"] == "backlog" else None
