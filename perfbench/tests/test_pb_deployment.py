"""A configuration that runs its whole deployment, on the CPU at a small
size: the program's Kafka-wire server as a child of the run, several
workers as members of one consumer group, and the configuration's engine
switches in the run's environment. The fixture configurations are this
file's own, handed to the harness in place of ``spec.config``'s files.
"""

from __future__ import annotations

import copy
import glob
import os

import pytest

from perfbench import common, harness, pool, spec

TRAFFIC = "camera12mp-backlog"
BACKLOG = {"pools": {"camera": {"h": 720, "w": 960, "count": 4}}, "depth": 8,
           "drain_s": 8, "warm": [["camera", 4, []]], "sample": 6}
SEED = 2**31 + 1931


def pipelined(**changes) -> dict:
    """The pipelined-worker configuration with ``changes`` over it; an
    ``env`` in them is laid over the configuration's own."""
    cfg = spec.config("pipelined-worker")
    env = {**cfg["env"], **changes.pop("env", {})}
    return {**cfg, **changes, "env": env}


KAFKA_GROUP = pipelined(
    services=["kafkaserver"], members=2,
    env={"BROKER_BACKEND": "kafka", "BROKER_PARTITIONS": 3,
         "KAFKA_GROUP_ID": "image-processor-group"})
SWITCHES = {"IMAGEPROCESSOR_JPEG_SPLICE": "0", "IMAGEPROCESSOR_DEVICE_JPEG": "0"}


@pytest.fixture(autouse=True)
def font(monkeypatch):
    """The font every run sets, set before the tests read the environment."""
    monkeypatch.setenv("IMAGEPROCESSOR_FONT", common.ensure_font())


def children() -> set[int]:
    """This process's child processes, exited and not yet reaped ones too."""
    me, out = str(os.getpid()), set()
    for path in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(path) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me:
            out.add(int(path.split("/")[2]))
    return out


def run(monkeypatch, cfg: dict, on_worker=None, trace=False):
    """One run of ``cfg`` under the camera backlog, at the fault tests'
    small size, as the workload ``fixture.<traffic>``."""
    real = spec.config
    monkeypatch.setattr(spec, "config", lambda name: copy.deepcopy(cfg)
                        if name == "fixture" else real(name))
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": f"fixture.{TRAFFIC}", "config": "fixture",
                               "traffic": TRAFFIC, "chips": 1})
    return harness.run_cell(f"fixture.{TRAFFIC}", SEED, 2.0, trace, "cpu",
                            traffic_overrides=BACKLOG, bench=bench, on_worker=on_worker)


class Stop(Exception):
    """Ends a run once its members are built."""


def test_a_kafka_group_of_two_runs_correct(monkeypatch):
    before, env = children(), dict(os.environ)
    line, r = run(monkeypatch, KAFKA_GROUP)
    checks = {k: (c["value"], c["limit"]) for k, c in line["checks"].items()}
    assert line["correct"], checks
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(len(r.results[i]) == 1 for i in r.judged)
    assert len(r.workers) == 2 and r.worker is r.workers[0]
    assert all(w.broker is not r.broker for w in r.workers)
    assert r.workers[0].broker is not r.workers[1].broker
    assert sorted(p for ps in r.extra["member_partitions"] for p in ps) == [0, 1, 2]
    assert all(n >= 1 for n in r.extra["member_completed"]), r.extra["member_completed"]
    assert sum(r.extra["member_completed"]) == len(r.judged)
    assert r.extra["service_exit"] == {"kafkaserver": 0}
    assert children() <= before
    assert dict(os.environ) == env


def test_a_traced_kafka_group_instruments_every_member(monkeypatch):
    line, r = run(monkeypatch, KAFKA_GROUP, trace=True)
    assert line["correct"], line["checks"]
    assert all({"decode_for_plan_ex", "device_group", "finish_item"} <= set(vars(w.engine))
               for w in r.workers)
    assert r.spans.of("device_group") and r.spans.of("finish_item")


def test_setup_that_raises_after_the_spawn_leaves_no_child(monkeypatch):
    before, env = children(), dict(os.environ)
    started = []
    real_start = harness.Run._start_services

    def start(self):
        real_start(self)
        started.extend(p.pid for p, _port, _log in self._children.values())

    def planted(*_a, **_k):
        raise RuntimeError("planted")

    monkeypatch.setattr(harness.Run, "_start_services", start)
    monkeypatch.setattr(pool, "make_pools", planted)
    with pytest.raises(RuntimeError, match="planted"):
        run(monkeypatch, pipelined(services=["kafkaserver"], members=2, env=SWITCHES))
    assert started and not set(started) & children()
    assert children() <= before
    assert dict(os.environ) == env


@pytest.mark.parametrize("config", ["compose-worker", "pipelined-worker"])
def test_one_member_holds_the_harness_broker(monkeypatch, config):
    """Without the new keys a run builds one worker on the harness's own
    in-process broker, as before, and starts no child."""
    seen = {}

    def look(r):
        seen.update(workers=list(r.workers), worker=r.worker, broker=r.broker,
                    children=dict(r._children), members=r.members)
        raise Stop

    with pytest.raises(Stop):
        run(monkeypatch, spec.config(config), on_worker=look)
    assert seen["members"] == 1 and seen["workers"] == [seen["worker"]]
    assert seen["worker"].broker is seen["broker"]
    assert seen["children"] == {}


def test_an_engine_switch_reaches_the_program_and_is_restored(monkeypatch):
    from imageprocessor_tpu_torch.runtime import splice

    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    env, seen = dict(os.environ), {}
    end = harness.Run.end_trace

    def look(r):
        seen["built"] = (splice.enabled(), r.worker.engine.device_jpeg)

    def at_close(r):
        seen["window"] = splice.enabled()
        return end(r)

    monkeypatch.setattr(harness.Run, "end_trace", at_close)
    line, _r = run(monkeypatch, pipelined(env=SWITCHES), on_worker=look)
    assert line["attempted"] > 0
    assert seen == {"built": (False, False), "window": False}
    assert dict(os.environ) == env


@pytest.mark.parametrize("changes", [{"services": ["postgres"]}, {"members": 0},
                                     {"members": "2"}],
                         ids=["unknown-service", "no-members", "members-not-a-number"])
def test_a_malformed_deployment_is_refused_before_anything_is_built(monkeypatch, changes):
    before = children()

    def setup(self):
        raise AssertionError("set-up began")

    monkeypatch.setattr(harness.Run, "setup", setup)
    with pytest.raises(ValueError):
        run(monkeypatch, pipelined(**changes))
    assert children() <= before


@pytest.mark.parametrize("config", ["compose-worker", "pipelined-worker"])
def test_the_benchmarks_configurations_keep_one_member_and_no_service(config):
    cfg = spec.config(config)
    assert spec.deployment(cfg) == ([], 1)
    assert not set(cfg["env"]) - harness.config_keys()
