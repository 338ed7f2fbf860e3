"""A whole run, without the look for a card, on the CPU at a small size:
sound, it is correct; with the timed path broken underneath, or with the
control (the program's own q75 encode) in its place, ``correct`` comes
out false.

The faults a one-card cell of this system can have: a step that returns
its state unchanged (the device step hands back its input bucket), part
of the work left out (every second upload never answered), and an
answer altered where it is produced (a variant's pixels shifted before
its encode). No cell spans cards, so none can leave out an exchange
between them. The plain versions of the kernels run here; the card runs
the same harness with the kernels themselves.
"""

from __future__ import annotations

import pytest

from perfbench import control, harness, spec

BACKLOG = {"pools": {"camera": {"h": 720, "w": 960, "count": 4}}, "depth": 8,
           "drain_s": 8, "warm": [["camera", 4, []]], "sample": 6}
CELLS = {
    "compose-worker.camera12mp-backlog": BACKLOG,
    "pipelined-worker.camera12mp-backlog": BACKLOG,
    "compose-worker.web-watermark-open": {
        "pools": {"web": {"h": 480, "w": 640, "count": 6},
                  "camera": {"h": 720, "w": 960, "count": 2}},
        "rate_per_s": 8, "drain_s": 8, "sample": 8,
        "warm": [["web", 2, ["thumbnail", "resize", "watermark"]],
                 ["camera", 1, ["thumbnail", "resize", "watermark"]]]},
}
SEED = 2**31 + 977
# the web mix's cell is out of BENCHMARK.json until its runs hold a bound
# (PERF.md); its harness is data, and runs here as any cell would
OPEN_CELL = {"name": "compose-worker.web-watermark-open", "config": "compose-worker",
             "traffic": "web-watermark-open", "chips": 1}


def run(cell, on_worker=None):
    bench = spec.load_benchmark()
    if all(w["name"] != cell for w in bench["workloads"]):
        bench["workloads"].append(OPEN_CELL)
    return harness.run_cell(cell, SEED, 2.0, False, "cpu", traffic_overrides=CELLS[cell],
                            bench=bench, on_worker=on_worker)


def in_window(monkeypatch) -> list[bool]:
    """A flag that turns true when the window opens: the faults break the
    timed path only, not the warm-up."""
    flag = [False]
    real = harness.Run.begin_window

    def begin(self):
        flag[0] = True
        return real(self)

    monkeypatch.setattr(harness.Run, "begin_window", begin)
    return flag


def state_unchanged(monkeypatch):
    from imageprocessor_tpu_torch.runtime import engine

    on, real = in_window(monkeypatch), engine.step_chw

    def step(imgs, src_hw, out_hws, specs):
        return [imgs for _ in specs] if on[0] else real(imgs, src_hw, out_hws, specs)

    monkeypatch.setattr(engine, "step_chw", step)


def half_left_out(monkeypatch):
    from imageprocessor_tpu_torch.service.worker import Worker

    on, real = in_window(monkeypatch), Worker._finish_message
    seen = []

    def finish(self, msg, task, eng_res):
        seen.append(task.image_id)
        if on[0] and len(seen) % 2 == 0:
            return   # never recorded, acked or answered
        real(self, msg, task, eng_res)

    monkeypatch.setattr(Worker, "_finish_message", finish)


def answer_altered(monkeypatch):
    import numpy as np

    from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine

    on, real = in_window(monkeypatch), TorchProcessingEngine._encode_and_save

    def altered(self, task, op, arr, fmt):
        if on[0]:
            arr = np.clip(arr.astype(np.int16) + 16, 0, 255).astype(np.uint8)
        return real(self, task, op, arr, fmt)

    monkeypatch.setattr(TorchProcessingEngine, "_encode_and_save", altered)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    line, r = run(cell)
    checks = {k: (c["value"], c["limit"]) for k, c in line["checks"].items()}
    assert line["correct"], checks
    assert line["attempted"] > 0 and line["failed"] == 0
    assert r.extra["sampled"] >= 4
    assert set(checks) == {"incomplete_uploads", "bad_variants", *harness.PIXEL_CHECKS}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(cell):
    """The program's own lower-precision path, its engine encoding at
    q75, in place of the configuration's q85."""
    line, _r = run(cell, control.lower_quality(75))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line, _r = run(cell)
    assert not line["correct"], line["checks"]


def test_a_watermark_reencoded_outside_its_band_is_not_correct(monkeypatch):
    """The splice switched off in the window: every watermark rendition is
    decoded and re-encoded whole, at q85 as the configuration states, so
    its RMSE over the text's box passes; the pixels outside the band no
    longer are the original's, which only ``outside_band_px`` sees."""
    on, real = in_window(monkeypatch), harness.Run.submit

    def submit(self, original, flags):
        if on[0]:
            monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
        return real(self, original, flags)

    monkeypatch.setattr(harness.Run, "submit", submit)
    line, _r = run("compose-worker.web-watermark-open")
    checks = {k: (c["value"], c["limit"]) for k, c in line["checks"].items()}
    assert not line["correct"], checks
    assert checks["outside_band_px"][0] > 0, checks
    assert checks["gap_lsb"][0] <= checks["gap_lsb"][1], checks
