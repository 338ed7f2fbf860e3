"""The port's bench (imageprocessor_tpu_torch/bench.py) on the CPU, held to
the reference bench (bench.py at the repository root, loaded by path: its
top level imports only numpy) and to the JAX package's resampler.

The runs use DEVICE_PLATFORM=cpu, where every kernel takes its plain
PyTorch version; one test checks that without it, and without a card, the
bench refuses to run.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from imageprocessor_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent
# bench.py:637-656, the reference's latency keys
REFERENCE_LATENCY_KEYS = {"metric", "value", "unit", "vs_baseline", "p50_ms", "p90_ms",
                          "p99_ms", "max_ms", "small_p50_ms", "small_p99_ms", "n",
                          "stages_ms", "note"}


def _reference_bench():
    spec = importlib.util.spec_from_file_location("reference_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setenv("DEVICE_PLATFORM", "cpu")
    monkeypatch.delenv("IMAGEPROCESSOR_JPEG_SPLICE", raising=False)


@pytest.mark.parametrize("shape", [(2, 48, 64, 64, 128), (3, 30, 50, 30, 50)])
def test_make_inputs_equals_the_reference(shape):
    imgs, hw = bench.make_inputs(*shape)
    ref_imgs, ref_hw = _reference_bench().make_inputs(*shape)
    assert imgs.dtype == ref_imgs.dtype == np.uint8
    np.testing.assert_array_equal(imgs, ref_imgs)
    np.testing.assert_array_equal(hw, ref_hw)


def test_quick_psnr_check_against_the_oracle_and_the_reference():
    from imageprocessor_tpu.ops.resize import batched_resize_bilinear

    db, out = bench.quick_psnr_check(torch.device("cpu"))
    assert db > 45.0
    # the reference's quick_psnr_check input (bench.py:667-673)
    img = np.random.default_rng(5).integers(0, 256, size=(600, 800, 3), dtype=np.uint8)
    batch = np.zeros((1, 640, 1024, 3), dtype=np.uint8)
    batch[0, :600, :800] = img
    ref = np.asarray(batched_resize_bilinear(
        batch, np.asarray([[600, 800]], np.int32), np.asarray([[300, 400]], np.int32),
        out_h=300, out_w=400))[0]
    assert out.shape == ref.shape == (300, 400, 3)
    assert np.abs(out.astype(np.int16) - ref.astype(np.int16)).max() <= 1


CODECS = {"host_decode_images_per_sec_per_core": 21.5,
          "host_encode_images_per_sec_per_core": 13.25,
          "host_entropy_scan_images_per_sec_per_core": 37.0,
          "host_entropy_emit_images_per_sec_per_core": 26.5,
          "host_splice_scan_ms": 27.3, "host_splice_edit_ms": 9.1,
          "host_splice_emit_ms": 2.6}


@pytest.mark.parametrize("splice_on", [True, False])
def test_end_to_end_model_is_the_references_arithmetic(splice_on):
    spl_step, djpeg, fused = 21539.0, 5667.2, 9876.5
    got = bench.end_to_end_model(CODECS, spl_step, djpeg, fused, splice_on)
    c = CODECS
    # bench.py:745-746
    host_codec = 1.0 / (1.0 / c["host_decode_images_per_sec_per_core"]
                        + 1.0 / c["host_encode_images_per_sec_per_core"] + 1.0 / fused)
    if splice_on:   # bench.py:755, 764-767
        host_ms = c["host_splice_scan_ms"] + (c["host_splice_edit_ms"]
                                              + c["host_splice_emit_ms"])
        one_core, path = 1.0 / (host_ms / 1000.0 + 1.0 / spl_step), "device_jpeg_splice"
    else:           # bench.py:771-774
        one_core = 1.0 / (1.0 / c["host_entropy_scan_images_per_sec_per_core"]
                          + 1.0 / c["host_entropy_emit_images_per_sec_per_core"]
                          + 1.0 / djpeg)
        path = "device_jpeg"
    assert got == {
        "end_to_end_one_host_core_images_per_sec": pytest.approx(one_core, rel=1e-12),
        "end_to_end_path": path,
        "end_to_end_one_host_core_host_codec_images_per_sec":
            pytest.approx(host_codec, rel=1e-12)}


def _last_json(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_main_smoke_prints_the_documented_keys(on_cpu, capsys):
    assert bench.main(["--smoke"]) == 0
    out = _last_json(capsys)
    assert set(out) == set(bench.KEYS)
    assert all(k in bench.__doc__ for k in bench.KEYS)
    assert out["platform"] == "cpu" and out["card"] == "cpu"
    rates = [k for k in out if k.endswith(("_per_sec", "_per_core", "_mb_per_s"))]
    assert len(rates) == 14
    for k in rates + ["value", "vs_baseline"]:
        assert math.isfinite(out[k]) and out[k] > 0, k
    assert out["psnr_db_vs_oracle"] > 45.0
    assert out["value"] == out["device_splice_step_images_per_sec"]
    assert out["end_to_end_path"] == "device_jpeg_splice"
    assert (out["batch"], out["bucket"], out["layout"]) == (2, [512, 640], "chw")
    assert out["engine_stages_ms"]["span_device_ms"] > 0


def test_main_latency_prints_both_workers(on_cpu, capsys):
    assert bench.main(["--latency", "--lat-n", "6", "--lat-big-every", "0"]) == 0
    out = _last_json(capsys)
    assert set(out) == set(bench.LATENCY_KEYS)
    assert REFERENCE_LATENCY_KEYS <= set(out)
    per_run = REFERENCE_LATENCY_KEYS - {"metric", "value", "unit", "vs_baseline", "note"}
    assert {f"pipelined_{k}" for k in per_run} <= set(out)
    assert out["n"] == out["pipelined_n"] == 6
    assert out["value"] == out["p99_ms"] > 0
    assert out["vs_baseline"] == pytest.approx(500.0 / out["p99_ms"])
    for run in ("", "pipelined_"):
        assert out[f"{run}p50_ms"] <= out[f"{run}p99_ms"] <= out[f"{run}max_ms"]
        assert out[f"{run}stages_ms"]["queue_wait_ms"]["count"] == 6
    assert "batcher_wait_ms" in out["pipelined_stages_ms"]


def test_main_refuses_without_a_card(monkeypatch):
    monkeypatch.delenv("DEVICE_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--smoke"])
