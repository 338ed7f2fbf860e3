"""Process start to the window's first due time: imports, the libraries'
build (first run in a checkout) or load, the pool, the worker, warm-up."""

UNIT, SOURCE = "s", "host_clock"


def read(run):
    return run.setup_s
