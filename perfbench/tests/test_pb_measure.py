"""The harness's arithmetic, on the CPU and without the program: traffic
from the seed, the union of device intervals, the kernels' bytes, the
due-time latency and the backlog window, the look for JAX."""

from __future__ import annotations

import math

import numpy as np
import pytest

from perfbench import harness, reference, roofline, spec, tracing
from perfbench.generators import backlog, open as open_loop

BENCH = spec.load_benchmark()


def open_traffic():
    return spec.traffic({"name": "compose-worker.web-watermark-open",
                         "traffic": "web-watermark-open"})


@pytest.mark.parametrize("seconds", [20.0, 30.0])
def test_open_schedule_is_the_seeds_and_exact(seconds):
    t = open_traffic()
    a = open_loop.schedule(t, 2**31 + 12345, seconds)
    assert a == open_loop.schedule(t, 2**31 + 12345, seconds)
    b = open_loop.schedule(t, 7, seconds)
    assert a != b
    rate = float(t["rate_per_s"])
    assert len(a) == len(b) == round(rate * seconds)
    # the same work for every seed: the same gaps and mix, in another order
    gaps = lambda s: sorted(np.round(np.diff([x[0] for x in s] + [seconds]), 9))
    assert gaps(a) == gaps(b)
    assert gaps(a) != [gaps(a)[0]] * len(a)      # Poisson gaps, not even ones
    assert a[0][0] == 0.0 and a[-1][0] < seconds
    assert sum(np.diff([x[0] for x in a])) + (seconds - a[-1][0]) == pytest.approx(seconds)
    # every tenth upload is the large one
    assert [x[1] for x in a[9::10]] == ["camera"] * (len(a) // 10)
    assert sorted(x[1] for x in a).count("camera") == round(len(a) / 10)


def test_backlog_stream_is_the_seeds():
    t = spec.traffic(spec.workload(BENCH, "compose-worker.camera12mp-backlog"))
    take = lambda seed: [next(it) for it in [backlog.stream(t, seed)] for _ in range(40)]
    assert take(5) == take(5) and take(5) != take(6)
    # each round of the pool visits every original once
    first = [idx for _p, idx, _f in take(5)[:16]]
    assert sorted(first) == list(range(16))


def test_union_of_overlapping_streams():
    # two streams overlap in [2, 3]: counted once
    ev = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (6.5, 6.8)]
    assert tracing.union(ev) == [(1.0, 4.0), (6.0, 7.0)]
    assert tracing.busy_seconds(ev, 0.0, 10.0) == pytest.approx(4.0)
    assert tracing.busy_seconds(ev, 2.5, 6.5) == pytest.approx(2.0)
    assert tracing.idle_gaps(ev, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    spans = [tracing.Span("finish_item", 3.5, 5.5), tracing.Span("device_group", 5.5, 5.7)]
    assert tracing.label((4.0, 6.0), spans) == "finish_item"
    assert tracing.label((8.0, 9.0), spans) == "no stage"


def test_b1_bytes_by_hand():
    # 3000 x 4000, 4:2:0: grid 3008 x 4000, chroma 1504 x 2000 twice, int16;
    # 3 tables of 64 float32; RGB 3 * 3000 * 4000
    coefs = 3008 * 4000 + 2 * 1504 * 2000
    assert roofline.b1_work(3000, 4000)[0] == 2 * coefs + 768 + 36_000_000
    coefs = 480 * 640 + 2 * 240 * 320
    assert roofline.b1_work(480, 640)[0] == 2 * coefs + 768 + 3 * 480 * 640
    assert roofline.bound_s(*roofline.b1_work(3000, 4000))[1] == "bytes"


def test_b2_bytes_by_hand():
    # 480 x 640 (h x w): thumbnail from the 480 x 480 centre (cx 80), the
    # resize 1024 x 768 keep-aspect upsamples to 768 x 1024 and touches
    # every row and column; the thumbnail's 200 outputs per axis read 2 taps
    # each in 480, which with the resize's rows are all rows. Each row
    # needs every column's sector: 640 / 32 = 20 sectors, 3 planes.
    nbytes, flop = roofline.b2_work(480, 640)
    outs = 3 * (200 * 200 + 768 * 1024)
    tables = 12 * (400 + 768 + 1024)
    assert nbytes == 3 * 32 * 480 * 20 + outs + tables
    assert flop == 11 * outs
    # 3000 x 4000: the resize reads 1536 distinct rows, the thumbnail's 400
    # taps over rows 0-2999 (no crop in y); rows shared by both read the
    # union of columns. Counted independently here from the tap sets.
    rows_r = set(roofline.taps(3000, 768).tolist())
    rows_t = set(roofline.taps(3000, 200).tolist())
    cols_r = {c // 32 for c in roofline.taps(4000, 1024).tolist()}
    cols_t = {c // 32 for c in roofline.taps(3000, 200, 500).tolist()}
    sectors = (len(rows_r - rows_t) * len(cols_r) + len(rows_t - rows_r) * len(cols_t)
               + len(rows_r & rows_t) * len(cols_r | cols_t))
    outs = 3 * (200 * 200 + 768 * 1024)
    assert roofline.b2_work(3000, 4000)[0] == 3 * 32 * sectors + outs + 12 * (400 + 768 + 1024)


def test_open_latency_from_due_time():
    due = {"a": 10.0, "b": 10.5, "c": 11.0, "d": 11.5}
    results = {"a": [(10.2, "completed")], "b": [(10.55, "completed")],
               "c": [(11.4, "failed")]}   # d never answered
    lat = open_loop.latencies_ms(due, results)
    assert lat[:2] == pytest.approx([50.0, 200.0])
    assert lat[2:] == [math.inf, math.inf]


def test_backlog_window_on_a_scripted_log():
    # a batch worker answers 4 at a time, every second from t = 1
    done = [(1.0 + k + j * 1e-3, f"{k}-{j}") for k in range(8) for j in range(4)]
    t0, t1, ids = backlog.window(done, start=0.5, seconds=3.0)
    assert t0 == 1.0 and t1 == 4.0
    assert len(ids) == 3 * 4   # (t0, t1]: the rest of call 0, calls 1-2, call 3's first
    assert backlog.window(done, start=0.5, seconds=30.0) is None


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(["imageprocessor_tpu_torch.engine", "numpy"]) == []
    assert harness.forbidden_modules(["imageprocessor_tpu.ops", "jax._src"]) == [
        "imageprocessor_tpu", "jax"]
    assert harness.forbidden_modules(["jaxlib", "flax.linen", "jaxtyping"]) == ["flax", "jaxlib"]


def test_jpeg_dims_and_gap():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)
    data = reference.encode(img, 85)
    assert reference.jpeg_dims(data) == (48, 80)
    assert reference.jpeg_dims(b"not a jpeg") is None
    r = reference.Rendition(img, (0, 0, 48, 80))
    view = reference.stored_view(r, 85)
    assert reference.gap_lsb(reference.decode(data), r, view) == 0.0
    assert math.isinf(reference.gap_lsb(img[:40], r, view))
    assert reference.tile_gap_lsb(reference.decode(data), r, view) == 0.0


def test_a_local_fault_reads_in_the_tile_gap():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (320, 320, 3), dtype=np.uint8)
    r = reference.Rendition(img, (0, 0, 320, 320))
    bad = img.copy()
    bad[32:48, 64:80] = 255 - bad[32:48, 64:80]     # one MCU, 0.25 % of the box
    assert reference.gap_lsb(bad, r, img) < 0.25 * reference.tile_gap_lsb(bad, r, img)
    assert reference.gap_lsb(bad, r, img) < 0.07 * reference.tile_gap_lsb(bad, r, img, 16)
    # the last square of a row ends at the far edge: whole, overlapping
    img = rng.integers(0, 256, (170, 170, 3), dtype=np.uint8)
    r = reference.Rendition(img, (0, 0, 170, 170))
    bad = img.copy()
    bad[154:, 154:] = 255 - bad[154:, 154:]
    assert reference.tile_gap_lsb(bad, r, img, 16) == pytest.approx(reference.gap_lsb(
        bad[154:, 154:], reference.Rendition(img[154:, 154:], (0, 0, 16, 16)),
        img[154:, 154:]))
    # a box narrower than a square: squares as wide as the box
    r = reference.Rendition(img, (100, 0, 120, 170))
    bad = img.copy()
    bad[100:120, 32:64] = 255 - bad[100:120, 32:64]
    whole = reference.gap_lsb(bad[100:120, 32:64], reference.Rendition(
        img[100:120, 32:64], (0, 0, 20, 32)), img[100:120, 32:64])
    assert reference.tile_gap_lsb(bad, r, img[100:120], 32) == pytest.approx(whole)
    assert reference.tile_gap_lsb(bad, r, img[100:120]) == pytest.approx(whole / 2 ** 0.5)


def test_outside_band_counts_pixels_beyond_the_box_band():
    rng = np.random.default_rng(2)
    src = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    r = reference.Rendition(src, (40, 50, 60, 90), keep=src)
    assert reference.band(r.box, 96, 128) == (16, 32, 80, 112)
    out = src.copy()
    out[16:80, 32:112] = 0          # anything inside the band is the box's
    assert reference.outside_band_px(out, r) == 0.0
    out[5, 5] ^= 1
    out[90, 120, 2] ^= 1
    assert reference.outside_band_px(out, r) == 2.0
    assert math.isinf(reference.outside_band_px(out[:80], r))
    assert reference.outside_band_px(out, reference.Rendition(src, r.box)) == 0.0


def test_jax_loaded_by_a_metric_reader_refuses_the_result(tmp_path, monkeypatch, capsys):
    """The look for JAX comes after every metric's reader has been
    loaded: a reader that imports it leaves the run with no result."""
    import sys

    import torch

    from perfbench import run as run_mod

    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    readers = tmp_path / "metrics"
    readers.mkdir()
    (readers / "planted_ms.py").write_text(
        "import jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(fake))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    bench = {"workloads": [{"name": "cell", "config": "c", "traffic": "t", "chips": 1}],
             "end_to_end": [{"name": "planted_ms", "unit": "ms"}], "per_layer": []}
    monkeypatch.setattr(spec, "load_benchmark", lambda root=None: bench)
    monkeypatch.setattr(spec, "metric", lambda name: spec._module(
        readers / f"{name}.py", f"perfbench_metric_{name}"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def run_cell(name, seed, seconds, trace, device, t_start, bench):
        r = harness.Run(name, {}, {}, seed, seconds, trace, "cpu", t_start, bench)
        return harness.result_line(r, {"gap_lsb": (0.0, 1.0)}, 0), r

    monkeypatch.setattr(harness, "run_cell", run_cell)
    rc = run_mod.main(["--workload", "cell", "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert "jax" in sys.modules
    assert rc != 0 and "jax" in err
    assert '"correct"' not in out
    monkeypatch.delitem(sys.modules, "jax")
