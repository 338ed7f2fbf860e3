"""The kafka-topology configuration and the two readers of the queue
worker's ``ack`` and ``publish`` spans: the configuration is a valid
deployment of two group members over the kafkaserver child; each reader
on a scripted snapshot, on the program's own spans, on a program without
them, and in a traced CPU run of the configuration at a small size."""

from __future__ import annotations

import types

import pytest

from perfbench import common, harness, spec

BENCH = spec.load_benchmark()
CELL = "kafka-topology.camera12mp-backlog"
READERS = ("ack_ms_per_image", "publish_ms_per_image")
BACKLOG = {"pools": {"camera": {"h": 720, "w": 960, "count": 4}}, "depth": 8,
           "drain_s": 8, "warm": [["camera", 4, []]], "sample": 6}
SEED = 2**31 + 1931


@pytest.fixture(autouse=True)
def font(monkeypatch):
    """The font every run sets, set before the tests read the environment."""
    monkeypatch.setenv("IMAGEPROCESSOR_FONT", common.ensure_font())


def scripted(timings: dict, counters: dict):
    return types.SimpleNamespace(snapshot={"timings": timings, "counters": counters})


def timing(count, total):
    return {"count": count, "p50": 0.0, "p90": 0.0, "p99": 0.0, "max": 0.0,
            "sum": total}


def test_the_kafka_topology_is_a_valid_deployment():
    cfg, member = spec.config("kafka-topology"), spec.config("pipelined-worker")
    assert spec.deployment(cfg) == (["kafkaserver"], 2)
    assert not set(cfg["env"]) - harness.config_keys()
    assert cfg["worker"] == member["worker"]
    assert cfg["limits"] == member["limits"]
    assert cfg["jpeg_quality"] == member["jpeg_quality"]
    assert {k: cfg["env"][k] for k in ("BROKER_BACKEND", "BROKER_PARTITIONS",
                                       "KAFKA_GROUP_ID", "KAFKA_COMMIT_INTERVAL")} \
        == {"BROKER_BACKEND": "kafka", "BROKER_PARTITIONS": 3,
            "KAFKA_GROUP_ID": "image-processor-group", "KAFKA_COMMIT_INTERVAL": 0}
    # every guarantee of the one member, and the group's own
    assert set(member["guarantees"]) < set(cfg["guarantees"])


def test_the_cell_runs_the_configuration_on_one_chip():
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("kafka-topology", "camera12mp-backlog", 1)


# 64 uploads: an ack of 3 ms and a publish of 2 ms each, inside a record of 12
CALLS = scripted(
    {"span_record_ms": timing(64, 64 * 12.0),
     "span_ack_ms": timing(64, 64 * 3.0),
     "span_publish_ms": timing(64, 64 * 2.0)},
    {})


@pytest.mark.parametrize("name,want", [("ack_ms_per_image", 3.0),
                                       ("publish_ms_per_image", 2.0)])
def test_reader_on_a_scripted_run(name, want):
    assert spec.metric(name).read(CALLS) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_a_program_without_spans(name):
    # the parent's program: a record span, and no ack or publish inside it
    old = scripted({"span_record_ms": timing(64, 64 * 12.0)}, {})
    assert spec.metric(name).read(old) is None
    assert spec.metric(name).read(scripted({}, {})) is None


def test_readers_on_the_programs_own_spans():
    from imageprocessor_tpu_torch.utils.metrics import METRICS
    from imageprocessor_tpu_torch.utils.tracing import span

    METRICS.reset()
    for _ in range(2):
        with span("record"):
            with span("ack"):
                pass
            with span("publish", bytes=100):
                pass
    run = types.SimpleNamespace(snapshot=METRICS.snapshot())
    t = run.snapshot["timings"]
    assert spec.metric("ack_ms_per_image").read(run) == pytest.approx(
        t["span_ack_ms"]["sum"] / 2)
    assert spec.metric("publish_ms_per_image").read(run) == pytest.approx(
        t["span_publish_ms"]["sum"] / 2)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_declared_for_every_cell(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["moves"] == "images_per_s"
    assert entry["layer"] == "queue worker"
    assert sorted(entry["workloads"]) == sorted(w["name"] for w in BENCH["workloads"])


def test_the_kafka_topology_cell_reads_ack_and_publish():
    """The real configuration, traced, at the small size: both new
    readers find the wire's ack and publish, each inside the record."""
    line, r = harness.run_cell(CELL, SEED, 2.0, True, "cpu",
                               traffic_overrides=BACKLOG, bench=BENCH)
    assert line["correct"], line["checks"]
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["ack_ms_per_image"] > 0 and got["publish_ms_per_image"] > 0
    assert got["record_ms_per_image"] >= got["ack_ms_per_image"] + got["publish_ms_per_image"]
    assert r.extra["service_exit"] == {"kafkaserver": 0}
