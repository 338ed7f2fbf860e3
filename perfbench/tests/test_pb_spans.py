"""The readers of the program's spans, on scripted snapshots of the
program's metrics and on one that the program's own spans fill: pack and
upload rate of the device stage, poll and record of the queue worker.
A program without the spans or the running sums reads nothing."""

from __future__ import annotations

import time
import types

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
READERS = ("pack_ms_per_image", "h2d_gb_per_s", "poll_ms_per_image",
           "record_ms_per_image")


def scripted(timings: dict, counters: dict):
    return types.SimpleNamespace(snapshot={"timings": timings, "counters": counters})


def timing(count, total):
    return {"count": count, "p50": 0.0, "p90": 0.0, "p99": 0.0, "max": 0.0,
            "sum": total}


# two 32-image calls of a batch worker: pack 600 and 700 ms; five copies a
# call of 38 MB an image at 6 GB/s; a poll of 40 ms a call and a fetch of
# 2 ms an upload; a record of 12 ms an upload
CALLS = scripted(
    {"span_pack_ms": timing(2, 1300.0),
     "span_h2d_ms": timing(10, 2 * 32 * 38e6 / 6e9 * 1e3),
     "span_poll_ms": timing(2, 80.0),
     "span_fetch_ms": timing(64, 64 * 2.0),
     "span_record_ms": timing(64, 64 * 12.0)},
    {"engine_pack_images": 64, "engine_h2d_bytes": 2 * 32 * 38e6})


@pytest.mark.parametrize("name,want", [
    ("pack_ms_per_image", 1300.0 / 64),
    ("h2d_gb_per_s", 6.0),
    ("poll_ms_per_image", (80.0 + 128.0) / 64),
    ("record_ms_per_image", 12.0)])
def test_reader_on_a_scripted_run(name, want):
    assert spec.metric(name).read(CALLS) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_in_a_program_without_spans(name):
    # the parent's program: reservoirs without a running sum, no spans
    old = scripted({"engine_decode_ms": {"count": 2, "p50": 1.0, "p90": 1.0,
                                         "p99": 1.0, "max": 1.0}},
                   {"engine_device_images": 64})
    assert spec.metric(name).read(old) is None
    assert spec.metric(name).read(scripted({}, {})) is None


def test_readers_on_the_programs_own_spans():
    from imageprocessor_tpu_torch.utils.metrics import METRICS
    from imageprocessor_tpu_torch.utils.tracing import span

    METRICS.reset()
    for n in (32, 5):
        with span("pack", images=n):
            pass
        METRICS.inc("engine_pack_images", n)
        with span("h2d", bytes=1 << 20):
            time.sleep(0.001)
        METRICS.inc("engine_h2d_bytes", 1 << 20)
    with span("poll", n=2):
        pass
    for _ in range(2):
        with span("fetch"):
            pass
        with span("record"):
            pass
    run = types.SimpleNamespace(snapshot=METRICS.snapshot())
    t = run.snapshot["timings"]
    assert spec.metric("pack_ms_per_image").read(run) == pytest.approx(
        t["span_pack_ms"]["sum"] / 37)
    assert spec.metric("h2d_gb_per_s").read(run) == pytest.approx(
        2 * (1 << 20) / t["span_h2d_ms"]["sum"] / 1e6)
    assert spec.metric("poll_ms_per_image").read(run) == pytest.approx(
        (t["span_poll_ms"]["sum"] + t["span_fetch_ms"]["sum"]) / 2)
    assert spec.metric("record_ms_per_image").read(run) == pytest.approx(
        t["span_record_ms"]["sum"] / 2)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_declared_for_both_cells(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["moves"] == "images_per_s"
    assert sorted(entry["workloads"]) == sorted(w["name"] for w in BENCH["workloads"])


def rec(name, id_, parent, t0, t1, thread=1, **attrs):
    from imageprocessor_tpu_torch.utils.tracing import SpanRecord

    return SpanRecord(name, id_, parent, thread, int(t0 * 1e9), int(t1 * 1e9), attrs)


# one batch call on a scripted clock (seconds): three codec threads decode
# in [1, 4], the worker's thread runs the group in [4, 6.5] (pack [4, 5],
# two copies, a launch, the copy back), the encodes in [6.5, 7.0] and one
# to 7.5 with a save in [7.0, 7.4], the records in [7.5, 7.95]; the card
# is busy only under the copies and the kernel
CALL = [rec("poll", 1, None, 0.0, 0.2, n=3),
        *[rec("fetch", 2 + k, None, 0.2 + 0.1 * k, 0.3 + 0.1 * k) for k in range(3)],
        *[rec("decode", 5 + k, None, 1.0, 4.0, thread=10 + k) for k in range(3)],
        rec("device", 8, None, 4.0, 6.5, images=3),
        rec("pack", 9, 8, 4.0, 5.0, images=3),
        rec("h2d", 10, 8, 5.0, 5.6, bytes=600),
        rec("h2d", 11, 8, 5.6, 6.0, bytes=400),
        rec("launch", 12, 8, 6.0, 6.05),
        rec("d2h", 13, 8, 6.05, 6.5, bytes=100),
        *[rec("encode", 14 + k, None, 6.5, 7.0 if k else 7.5, thread=10 + k)
          for k in range(3)],
        rec("save", 17, 14, 7.0, 7.4, thread=10),
        *[rec("record", 18 + k, None, 7.5 + 0.15 * k, 7.65 + 0.15 * k) for k in range(3)]]
EVENTS = [("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5.1, 5.55),
          ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 5.65, 5.95),
          ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 6.01, 6.02),   # a table
          ("decode_kernel", "kernel", 6.05, 6.2),
          ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 6.3, 6.45)]


def test_innermost_span_labels_each_gap():
    from perfbench import spancheck

    own = spancheck.own_time(spancheck.spans_s(CALL))
    # the device span's own time is what its children leave: none here
    assert own["device"] == []
    assert own["encode"] == [(6.5, 7.0), (7.4, 7.5)]   # three threads, merged
    assert own["decode"] == [(1.0, 4.0)]
    # a gap over the pack is the pack's, not the device's that holds it
    assert spancheck.label((4.0, 5.1), own) == "pack"
    # a gap mostly under the decode threads, a little under the poll
    assert spancheck.label((0.0, 3.0), own) == "decode"
    # the save inside the encode wins where it covers most of the gap
    assert spancheck.label((7.0, 7.4), own) == "save"
    assert spancheck.label((7.45, 8.0), own) == "record"
    assert spancheck.label((8.5, 9.0), own) == "no span"


def test_checks_on_a_scripted_call():
    from perfbench import spancheck, tracing

    wrappers = tracing.Spans()
    wrappers.items = [tracing.Span("device_group", 4.0, 6.5),
                      *[tracing.Span("decode_for_plan_ex", 1.0, 4.1) for _ in range(3)],
                      *[tracing.Span("finish_item", 6.5, t) for t in (7.5, 7.0, 7.0)]]
    got = spancheck.checks(spancheck.spans_s(CALL), EVENTS, wrappers, 0.0, 9.0)
    assert got["busy_in_device_span"] == pytest.approx(1.0)
    # the table copied outside the h2d spans: 0.01 of 0.76 s
    assert got["htod_in_h2d_span"] == pytest.approx(0.75 / 0.76)
    # idle 9 - 1.06 s, of it [0.5, 1], [7.95, 9] under no span
    assert got["idle_unspanned_share"] == pytest.approx(1.55 / (9.0 - 1.06))
    assert got["program_over_wrapper"]["device"] == pytest.approx(1.0)
    assert got["program_over_wrapper"]["decode"] == pytest.approx(3.0 / 3.1)
    assert got["program_over_wrapper"]["encode"] == pytest.approx(1.0)
    # the longest gap runs from 0 to the first copy: mostly the decodes'
    assert got["idle_gaps"][0] == ["decode", pytest.approx(5.1)]
    assert got["idle_under_s"]["pack"] == pytest.approx(1.0)
    assert got["idle_under_s"]["record"] == pytest.approx(0.45)
