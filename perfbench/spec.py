"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, a traffic mix
and its chips. Everything that belongs to one of them sits in a file of
its own, so that a later change adds a cell, a configuration, a mix or a
metric by adding files and entries, never by editing one:

* ``configs/<config>.json``: the worker class, the environment its
  ``Config`` is loaded from, the backends, source, reduced and assumed,
  and the deployment's shape in three optional keys (``deployment``):
  ``services``, the program's servers the run starts as child processes
  before any broker is built (``SERVICES``); ``members``, how many
  workers of the class serve as one consumer group (default 1); and the
  keys of ``env`` that the program's ``config.load`` does not read, such
  as the engine's ``IMAGEPROCESSOR_*`` switches, which the run sets in
  its own environment until it closes;
* ``traffic/<traffic>.json``: the generator kind, the pools of
  originals, the mix of upload flags, the rate or the backlog depth and
  the warm-up bursts;
* ``cells/<workload>.json`` (optional): parameters of the cell's
  traffic that differ from the mix's file, such as an open cell's rate;
* ``generators/<kind>.py``: one general generator per kind;
* ``metrics/<metric>.py``: one reader per metric, ``read(run)``.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def repo_root() -> pathlib.Path:
    return HERE.parent


def load_benchmark(root: pathlib.Path | None = None) -> dict:
    with open((root or repo_root()) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


# the program's servers a configuration may list under "services", each
# started as ``python -m imageprocessor_tpu_torch.service <args>`` on a
# free loopback port; "env" is what the members' Config is loaded with
# to reach it. "{port}" stands for the port.
SERVICES = {
    "kafkaserver": {"args": ["kafkaserver", "--port", "{port}"],
                    "env": {"KAFKA_BROKERS": "127.0.0.1:{port}"}},
}


def deployment(cfg: dict) -> tuple[list[str], int]:
    """A configuration's services and its number of members, refused
    before anything is built where a service is unknown or there are
    fewer than one member."""
    services = list(cfg.get("services", []))
    unknown = [s for s in services if s not in SERVICES]
    if unknown:
        raise ValueError(f"unknown service(s) {unknown}: the harness runs "
                         f"{sorted(SERVICES)}")
    members = cfg.get("members", 1)
    if not isinstance(members, int) or isinstance(members, bool) or members < 1:
        raise ValueError(f"members must be a whole number of at least 1, got {members!r}")
    return services, members


def traffic(cell: dict) -> dict:
    """The cell's traffic: its mix's file, then its own file over it."""
    out = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    own = HERE / "cells" / f"{cell['name']}.json"
    if own.exists():
        out.update(_json(own).get("traffic", {}))
    return out


def _module(path: pathlib.Path, name: str):
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def generator(kind: str):
    return _module(HERE / "generators" / f"{kind}.py", f"perfbench_gen_{kind}")


def metric(name: str):
    return _module(HERE / "metrics" / f"{name}.py",
                   "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
