"""BENCHMARK.json and the files it names: every name resolves, every name
and unit keeps to the contract's characters, every metric's reader
declares what BENCHMARK.json says of it."""

from __future__ import annotations

import json
import pathlib

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
ROOT = spec.repo_root()


def names():
    yield from (c["name"] for c in BENCH["configs"])
    yield from (w["name"] for w in BENCH["workloads"])
    yield from (w[k] for w in BENCH["workloads"] for k in ("config", "traffic"))
    yield from (m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k])
    yield from (r for c in BENCH["configs"] for r in c["reduced"])


@pytest.mark.parametrize("name", sorted(set(names())))
def test_name_characters(name):
    assert spec.NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_matches_its_entry(metric):
    assert spec.UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    mod = spec.metric(metric["name"])
    assert (mod.UNIT, mod.SOURCE) == (metric["unit"], metric["source"])
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert cell["chips"] == 1
    cfg = spec.config(cell["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (ROOT / entry["file"]).exists()
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    module, cls = cfg["worker"].split(":")
    assert module.split(".")[0] == "imageprocessor_tpu_torch" and cls
    traffic = spec.traffic(cell)
    assert spec.generator(traffic["kind"]).drive
    assert "gap_lsb" in cfg["limits"]
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in spec.cell_metrics(BENCH, cell["name"], "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.cell_metrics(BENCH, cell["name"], "per_layer")


def test_texts_are_one_line_of_at_most_200():
    texts = [c["source"] for c in BENCH["configs"]] + [c["why"] for c in BENCH["configs"]]
    texts += [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
    texts += BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    assert all(c["source"].startswith("https://") for c in BENCH["configs"])


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(BENCH)) < 64 * 1024
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_file_under_paths_has_a_contract_name():
    for path in (ROOT / "perfbench").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel:
            continue
        assert all(spec.NAME.match(part) for part in rel.split("/")), rel
