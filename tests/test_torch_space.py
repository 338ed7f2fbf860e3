"""The space axis on the port (DEVICE_SPACE_AXIS=s): each packed group
split into s column strips of its bucket (parallel/mesh.py,
models/strips.py), on s CPU devices here, every kernel's plain version
run once per strip.

* geometry (hypothesis): the strips cover every source column once, each
  output column of a resample, a crop and a flip is owned by exactly one
  strip, and every tap and gather index of a strip stays inside its
  halo'd slice;
* artifacts at s = 2, 3 and 4 are byte-identical to s = 1: the seven
  upload-form plans with the splice on and off, flip, crop, grayscale and
  rotate plans, 4:2:0, 4:2:2, 4:4:0 and 4:4:4 JPEGs and a PNG, the device
  JPEG switch at 0, a group that mixes an image narrower than one strip
  with images as wide as the bucket, and a 200-wide bucket (not a
  multiple of s * 16);
* each of B1-B4 runs once per strip (its wrapper's calls);
* against the reference's spatial engine (ProcessingEngine(space_axis=2,
  use_pallas=False) on the suite's virtual CPU devices): the engine
  contracts of ROADMAP's table;
* the service: Worker and PipelinedWorker from DEVICE_SPACE_AXIS=2,
  DEVICE_DATA_AXIS=2, DEVICE_PLATFORM=cpu; the refusals by name on a host
  acting out eight cards.
"""

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from imageprocessor_tpu_torch import domain as d
from imageprocessor_tpu_torch.models import strips as strips_mod
from imageprocessor_tpu_torch.ops.extra import crop_indices
from imageprocessor_tpu_torch.ops.fused_resample import (
    center_crop_windows,
    make_taps,
)
from imageprocessor_tpu_torch.parallel import (
    HALO,
    make_devices,
    owned_ranges,
    strip_bounds,
    strip_halos,
)
from imageprocessor_tpu_torch.runtime import engine as engine_mod
from imageprocessor_tpu_torch.runtime.batcher import BUCKET_LADDER
from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
from tests.oracle import psnr

RNG = np.random.default_rng(1212)
P, T = d.OperationParams, d.OperationType

# cv2's sampling factors: 4:2:0, 4:2:2, 4:4:0, 4:4:4
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def photo(h, w, noise=40):
    yy = np.linspace(0, 150, h)[:, None, None]
    xx = np.linspace(0, 90, w)[None, :, None]
    return np.clip(yy + xx + RNG.integers(0, noise, (h, w, 3)), 0, 255).astype(np.uint8)


def jpeg(h, w, sampling="420", noise=40):
    ok, buf = cv2.imencode(".jpg", photo(h, w, noise), [
        cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert ok
    return buf.tobytes()


def png(h, w):
    ok, buf = cv2.imencode(".png", photo(h, w))
    assert ok
    return buf.tobytes()


# a 4:2:0 group of three widths in the 128 x 256 bucket, one source of
# each other sampling, a 4:4:4 source in the 200-wide bucket, and a PNG
SOURCES = [jpeg(120, 250), jpeg(128, 210), jpeg(100, 256), jpeg(110, 240, "422"),
           jpeg(100, 230, "440"), jpeg(125, 200, "444"), png(90, 230)]
# the 64 x 64 bucket: a 10-wide image (narrower than one strip at s = 2,
# 3 and 4) among images as wide as the bucket
NARROW = [jpeg(50, 10), jpeg(60, 64), jpeg(40, 64), png(64, 12), png(33, 64)]

WATERMARK = P(T.WATERMARK, {"text": "© strips", "opacity": 0.5,
                            "position": "bottom-right"})
DEFAULT = [P(T.THUMBNAIL, {"size": 200, "crop_to_fit": True}),
           P(T.RESIZE, {"width": 1024, "height": 768, "keep_aspect": True})]
FORM_PLANS = {flags: [op for flag, op in zip("trw", (*DEFAULT, WATERMARK))
                      if flag in flags]
              for flags in ("t", "r", "w", "tr", "tw", "rw", "trw")}
TRANSFORMS = {
    "flip_h": [P(T.FLIP, {"direction": "horizontal"})],
    "flip_v": [P(T.FLIP, {"direction": "vertical"})],
    "crop": [P(T.CROP, {"x": 30, "y": 5, "width": 150, "height": 60})],
    "grayscale": [P(T.GRAYSCALE, {})],
    "rotate90": [P(T.ROTATE, {"angle": 90})],
    "rotate30": [P(T.ROTATE, {"angle": 30})],
}
MIXED = [P(T.THUMBNAIL, {"size": 24, "crop_to_fit": False}),
         P(T.RESIZE, {"width": 40, "height": 30, "keep_aspect": False}),
         P(T.FLIP, {"direction": "horizontal"}), P(T.GRAYSCALE, {}),
         P(T.CROP, {"x": 3, "y": 2, "width": 40, "height": 20}),
         P(T.ROTATE, {"angle": 270}), WATERMARK]


class CaptureStore:
    def __init__(self):
        self.blobs: dict[str, bytes] = {}

    def save_processed(self, path, data, mime=None):
        self.blobs[path] = data


def _task(ops, fmt, iid):
    return d.ProcessingTask(id=iid, image_id=iid, original_path=f"o/{iid}",
                            bucket="b", operations=ops, format=fmt)


def run(blobs, ops, fmt="jpeg", **kw):
    """The same tasks (same ids) through a port engine on the CPU;
    -> the artifacts by path."""
    store = CaptureStore()
    eng = TorchProcessingEngine(store, device="cpu", **kw)
    try:
        res = eng.process_tasks([(_task(ops, fmt, f"img{k}"), b)
                                 for k, b in enumerate(blobs)])
    finally:
        eng.close()
    for r in res:
        assert r.result.status is d.ImageStatus.COMPLETED, r.result.error
    assert len(store.blobs) == len(blobs) * len(ops)
    return store.blobs


def assert_strips_identical(blobs, ops, fmt="jpeg", spaces=(2, 3, 4)):
    one = run(blobs, ops, fmt)
    for s in spaces:
        got = run(blobs, ops, fmt, space_axis=s)
        assert got.keys() == one.keys()
        assert [p for p in one if got[p] != one[p]] == [], f"space_axis={s}"


# --- geometry -----------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.sampled_from(BUCKET_LADDER), st.integers(2, 4), st.data())
def test_strip_geometry_covers_each_column_once(wb, space, data):
    hb = 64
    bounds = strip_bounds(wb, space)
    halos = strip_halos(bounds)
    n = len(bounds) - 1
    assert bounds[0] == 0 and bounds[-1] == wb and 1 <= n <= space
    assert all(x % 16 == 0 for x in bounds[:-1])
    assert all(lo < hi for lo, hi in zip(bounds[:-1], bounds[1:]))
    for (a, b), lo, hi in zip(halos, bounds[:-1], bounds[1:]):
        assert a == max(lo - HALO, 0) and b == min(hi + HALO, wb)
    widths = data.draw(st.lists(st.integers(1, wb), min_size=1, max_size=4))
    src_hw = np.array([[hb, w] for w in widths], np.int64)
    out_w = data.draw(st.integers(1, 2 * wb))
    out_hw = np.array([[8, max(1, min(out_w, w * 3))] for w in widths], np.int64)
    crop_yx, crop_hw = center_crop_windows(src_hw)
    tables = {
        "resize": make_taps(src_hw, out_hw, (8, out_w), (hb, wb)),
        "thumbnail": make_taps(src_hw, np.full((len(widths), 2), 16), (16, 16),
                               (hb, wb), crop_yx, crop_hw),
    }
    for name, t in tables.items():
        c0, c1 = t.c0.numpy(), t.c1.numpy()
        rng = owned_ranges(c0, bounds)
        assert (rng[0, :, 0] == 0).all() and (rng[-1, :, 1] == c0.shape[1]).all()
        assert (rng[1:, :, 0] == rng[:-1, :, 1]).all(), name   # contiguous
        for k, (a, b) in enumerate(halos):
            st_taps = strips_mod._strip_taps(t, rng[k], (a, b), torch.device("cpu"))
            for i, (j0, j1) in enumerate(rng[k]):
                if j1 <= j0:
                    continue
                assert (bounds[k] <= c0[i, j0:j1]).all() and (c0[i, j0:j1] < bounds[k + 1]).all()
                assert (a <= c1[i, j0:j1]).all() and (c1[i, j0:j1] < b).all(), name
                # the strip's tables are those columns, rebased into its slice
                assert (st_taps.c0[i, :j1 - j0].numpy() == c0[i, j0:j1] - a).all()
                assert (st_taps.c1[i, :j1 - j0].numpy() == c1[i, j0:j1] - a).all()
            if st_taps is not None:
                assert (st_taps.c0 >= 0).all() and (st_taps.c1 < b - a).all()
    x, y = data.draw(st.integers(0, wb)), data.draw(st.integers(0, hb))
    cw = data.draw(st.integers(1, wb))
    ry, rx = crop_indices(src_hw, x, y, cw, 8, hb, wb)
    rng = owned_ranges(rx, bounds)
    assert (rng[0, :, 0] == 0).all() and (rng[-1, :, 1] == cw).all()
    for k, (a, b) in enumerate(halos):
        cols = strips_mod._strip_cols(rx, rng[k])
        if cols is not None:
            for i, (j0, j1) in enumerate(rng[k]):
                assert (cols[i, :j1 - j0] == rx[i, j0:j1]).all()
                assert (bounds[k] <= rx[i, j0:j1]).all() and (rx[i, j0:j1] < bounds[k + 1]).all()
    # flip horizontal: output column j of strip k reads one source column,
    # in exactly one strip's own columns
    for w in widths:
        src = np.clip(w - 1 - np.arange(wb), 0, wb - 1)
        owner = np.searchsorted(bounds, src, side="right") - 1
        assert ((owner >= 0) & (owner < n)).all()
        assert all((src[owner == m] >= bounds[m]).all()
                   and (src[owner == m] < bounds[m + 1]).all() for m in range(n))


def test_strip_bounds_of_a_bucket_not_a_multiple_of_s16():
    assert strip_bounds(200, 2) == [0, 96, 200]
    assert strip_bounds(200, 3) == [0, 64, 128, 200]
    assert strip_bounds(200, 4) == [0, 48, 96, 144, 200]
    assert strip_bounds(64, 8) == [0, 16, 32, 48, 64]   # four 16-column units


# --- artifacts, s strips against one -----------------------------------------

@pytest.mark.parametrize("splice", ["1", "0"], ids=["splice", "nosplice"])
@pytest.mark.parametrize("flags", sorted(FORM_PLANS))
def test_form_plans_byte_identical_across_strips(monkeypatch, flags, splice):
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", splice)
    assert_strips_identical(SOURCES, FORM_PLANS[flags])


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_plans_byte_identical_across_strips(monkeypatch, name, fmt):
    """The splice off: a JPEG rendition of flip and grayscale goes through
    B3 strip by strip; PNG renditions leave as pixels."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    assert_strips_identical(SOURCES, TRANSFORMS[name], fmt)


@pytest.mark.parametrize("plan", ["trw", "flip_h"])
def test_device_jpeg_off_byte_identical_across_strips(monkeypatch, plan):
    """IMAGEPROCESSOR_DEVICE_JPEG=0: host-decoded rows split the same way."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    monkeypatch.setenv("IMAGEPROCESSOR_DEVICE_JPEG", "0")
    assert_strips_identical(SOURCES, FORM_PLANS.get(plan) or TRANSFORMS[plan])


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_narrow_image_among_full_width_ones(monkeypatch, fmt):
    """A 64 x 64 bucket's group: a 10-wide JPEG and a 12-wide PNG beside
    images as wide as the bucket (strips 32, 16 and 16 columns wide)."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    assert_strips_identical(NARROW, MIXED, fmt)


@pytest.fixture()
def wrapper_calls(monkeypatch):
    """Calls of B1-B4's wrappers as the engine and the strip step make
    them (the plain versions count no launch)."""
    calls = dict.fromkeys(("B1", "B2", "B3", "B4"), 0)
    for key, mod, name in (("B1", engine_mod, "decode_coefs"),
                           ("B3", engine_mod, "encode_420"),
                           ("B2", strips_mod, "fused_resample"),
                           ("B4", strips_mod, "planar_resample")):
        inner = getattr(mod, name)

        def counted(*a, _inner=inner, _key=key, **k):
            calls[_key] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("space", [2, 3])
def test_each_kernel_runs_once_per_strip(monkeypatch, wrapper_calls, space):
    """Three 4:2:0 sources in one 128 x 256 group: B1 decodes each strip,
    B2 serves the thumbnail + resize pair and B4 the other resize on each
    strip, B3 encodes each output strip of the flip."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    ops = DEFAULT + [P(T.RESIZE, {"width": 100, "height": 50}),
                     P(T.FLIP, {"direction": "horizontal"})]
    run(SOURCES[:3], ops, space_axis=space)
    assert wrapper_calls == dict.fromkeys(("B1", "B2", "B3", "B4"), space)


# --- against the reference's spatial engine ----------------------------------

@pytest.mark.parametrize("space", [2, 3])
@pytest.mark.parametrize("fh,fw", [(2, 2), (1, 2), (2, 1), (1, 1)])
def test_strip_decode_matches_the_reference_decode(fh, fw, space):
    """B1's plain version per strip, each strip's own columns stitched:
    the one-strip decode to the bit, and within 1 LSB of the reference's
    batched_decode_ycbcr inside each valid region, on a 200-wide bucket
    (a 208-wide 4:2:0 canvas) with a 10-wide image among wide ones."""
    import types

    from imageprocessor_tpu.ops.jpeg_decode import batched_decode_ycbcr
    from imageprocessor_tpu_torch.ops.jpeg_decode import decode_ycbcr
    from imageprocessor_tpu_torch.runtime.batcher import coef_canvas, coef_layout
    from tests.test_pallas_jpeg import _case

    dims = [(64, 200), (50, 10), (60, 133), (64, 190)]
    hb, wb = 64, 200
    ch, cw = coef_canvas((hb, wb), fh, fw)
    yc, cbc, crc, qt, cv = _case(dims, ch, cw, seed=5, fh=fh, fw=fw)
    group = types.SimpleNamespace(bucket=(hb, wb), layout=coef_layout(fh, fw))
    eng = TorchProcessingEngine(CaptureStore(), device="cpu")
    try:
        strips = eng._upload_strips((yc, cbc, crc, qt, cv), np.array(dims), group,
                                    (torch.device("cpu"),) * space)
    finally:
        eng.close()
    assert len(strips.parts) == space
    got = torch.cat([strips.own(k) for k in range(space)], dim=3).numpy()
    one = decode_ycbcr(*(torch.from_numpy(a) for a in (yc, cbc, crc, qt, cv)),
                       fh=fh, fw=fw, out_h=hb, out_w=wb).numpy()
    ref = np.asarray(batched_decode_ycbcr(yc, cbc, crc, qt, cv, fh=fh, fw=fw,
                                          out_h=hb, out_w=wb))
    for i, (h, w) in enumerate(dims):
        assert np.array_equal(got[i, :, :h, :w], one[i, :, :h, :w]), i
        diff = np.abs(got[i, :, :h, :w].astype(int) - ref[i, :, :h, :w].astype(int))
        assert diff.max() <= 1, i


def _ref_run(blobs, ops, fmt):
    import jax

    from imageprocessor_tpu.domain import OperationParams, OperationType
    from imageprocessor_tpu.domain import ProcessingTask as RefTask
    from imageprocessor_tpu.runtime.engine import ProcessingEngine

    if len(jax.devices()) < 2:
        pytest.skip("needs the conftest's virtual devices")
    store = CaptureStore()
    eng = ProcessingEngine(store, data_axis=1, space_axis=2, use_pallas=False,
                           compute_dtype="float32")
    assert eng._mesh is not None and eng._mesh_spatial
    ref_ops = [OperationParams(OperationType(op.type.value), dict(op.parameters))
               for op in ops]
    try:
        res = eng.process_tasks([(RefTask(id=f"img{k}", image_id=f"img{k}",
                                          original_path="o", bucket="b",
                                          operations=ref_ops, format=fmt), b)
                                 for k, b in enumerate(blobs)])
    finally:
        eng.close()
    for r in res:
        assert r.result.status.value == "completed", r.result.error
    return store.blobs


def test_png_renditions_match_the_reference_and_the_oracle():
    """PNG sources, PNG renditions: every artifact within 1 LSB of the
    reference's spatial engine, and the resize and the thumbnail within
    1 LSB and above 45 dB of the float64 Go oracle."""
    from tests import oracle

    ops = [P(T.THUMBNAIL, {"size": 64, "crop_to_fit": True}),
           P(T.RESIZE, {"width": 160, "height": 120, "keep_aspect": True}),
           P(T.FLIP, {"direction": "horizontal"}), P(T.GRAYSCALE, {}),
           P(T.CROP, {"x": 20, "y": 10, "width": 120, "height": 60})]
    srcs = [photo(90, 230), photo(128, 200), photo(100, 256)]
    blobs = [cv2.imencode(".png", a)[1].tobytes() for a in srcs]
    ref = _ref_run(blobs, ops, "png")
    port = run(blobs, ops, "png", space_axis=2)
    assert ref.keys() == port.keys()
    for path in ref:
        a = cv2.imdecode(np.frombuffer(ref[path], np.uint8), cv2.IMREAD_COLOR)
        b = cv2.imdecode(np.frombuffer(port[path], np.uint8), cv2.IMREAD_COLOR)
        assert a.shape == b.shape, path
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, path
    for k, src in enumerate(srcs):
        rgb = src[:, :, ::-1]   # cv2 encoded BGR
        for op, want in (("thumbnail", oracle.thumbnail_go(rgb, 64, crop_to_fit=True)),
                         ("resize", oracle.resize_go(rgb, 160, 120, keep_aspect=True))):
            [path] = [p for p in port if f"img{k}" in p and op in p]
            got = cv2.imdecode(np.frombuffer(port[path], np.uint8),
                               cv2.IMREAD_COLOR)[:, :, ::-1]
            assert got.shape == want.shape, path
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, path
            assert psnr(got, want) > 45.0, path


def test_jpeg_renditions_match_the_reference():
    """JPEG sources with a spliced watermark: equal paths, the watermark
    byte for byte (shared host code), every other artifact above 45 dB
    (the reference decodes these sources on the host, so its pixels are
    libjpeg's: smooth photos, as tests/test_torch_device_jpeg.py uses)."""
    ops = DEFAULT + [WATERMARK]
    blobs = [jpeg(120, 250, noise=12), jpeg(100, 256, noise=12),
             jpeg(110, 240, "422", noise=12), jpeg(100, 230, "440", noise=12),
             jpeg(125, 200, "444", noise=12)]
    ref = _ref_run(blobs, ops, "jpeg")
    port = run(blobs, ops, space_axis=2)
    assert ref.keys() == port.keys()
    for path in ref:
        if "watermark" in path:
            assert ref[path] == port[path], path
            continue
        a = cv2.imdecode(np.frombuffer(ref[path], np.uint8), cv2.IMREAD_COLOR)
        b = cv2.imdecode(np.frombuffer(port[path], np.uint8), cv2.IMREAD_COLOR)
        assert a.shape == b.shape, path
        assert psnr(a, b) > 45.0, path


# --- the service ----------------------------------------------------------------

def _ops():
    return [P(T.THUMBNAIL, {"size": 64, "crop_to_fit": True}),
            P(T.RESIZE, {"width": 128, "height": 96, "keep_aspect": True}),
            P(T.FLIP, {"direction": "horizontal"})]


def test_worker_serves_two_replicas_of_two_strips(tmp_path):
    from imageprocessor_tpu_torch.broker.memory import MemoryBroker
    from imageprocessor_tpu_torch.config import load
    from imageprocessor_tpu_torch.service.usecase import ImageUsecase
    from imageprocessor_tpu_torch.service.worker import Worker
    from imageprocessor_tpu_torch.storage import LocalFSObjectStore, SQLiteMetadataStore
    from imageprocessor_tpu_torch.utils import RetryStrategy

    cfg = load({"DEVICE_SPACE_AXIS": "2", "DEVICE_DATA_AXIS": "2",
                "DEVICE_PLATFORM": "cpu"})
    meta = SQLiteMetadataStore(":memory:")
    store = LocalFSObjectStore(str(tmp_path / "objects"))
    broker = MemoryBroker()
    uc = ImageUsecase(meta, store, broker,
                      retries=RetryStrategy(attempts=2, delay_ms=1))
    worker = Worker(cfg, meta=meta, store=store, broker=broker)
    try:
        assert worker.engine.replicas == [(torch.device("cpu"),) * 2] * 2
        imgs = [uc.upload_image(png(80, 100 + 20 * i), f"{i}.png", "image/png", _ops())
                for i in range(3)]
        assert worker.run_once() == 3
        for img in imgs:
            assert meta.get_image(img.id).status is d.ImageStatus.COMPLETED
            assert len(meta.list_processed(img.id)) == 3
    finally:
        worker.engine.close()


def test_pipelined_worker_serves_two_replicas_of_two_strips(tmp_path):
    from tests.test_torch_worker import PORT, Stack

    stack = Stack(PORT, "pipelined", tmp_path,
                  env={"DEVICE_SPACE_AXIS": "2", "DEVICE_DATA_AXIS": "2"},
                  batch_deadline_ms=5)
    try:
        assert stack.worker.engine.replicas == [(torch.device("cpu"),) * 2] * 2
        ids = [stack.uc.upload_image(png(80, 100 + 20 * k), f"{k}.png", "image/png",
                                     _ops()).id for k in range(3)]
        stack.drive(ids)
        assert {stack.status(i) for i in ids} == {"completed"}
    finally:
        stack.close()


@pytest.fixture()
def eight_cards(monkeypatch):
    """torch.cuda as a host with eight cards would report it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("env", [
    {"DEVICE_DATA_AXIS": "3", "DEVICE_SPACE_AXIS": "3"},
    {"DEVICE_DATA_AXIS": "1", "DEVICE_SPACE_AXIS": "9"},
    {"DEVICE_PLATFORM": "cuda:1", "DEVICE_SPACE_AXIS": "2"}],
    ids=["9_of_8", "space_9", "named_card"])
@pytest.mark.parametrize("kind", ["batch", "pipelined"])
def test_worker_refuses_a_mesh_the_cards_cannot_hold(eight_cards, monkeypatch,
                                                     kind, env):
    from imageprocessor_tpu_torch.config import load
    from imageprocessor_tpu_torch.service import pipelined, worker

    def no_backend(*a, **k):
        raise AssertionError("a backend was opened")

    monkeypatch.setattr(worker, "build_metadata_store", no_backend)
    cls = worker.Worker if kind == "batch" else pipelined.PipelinedWorker
    with pytest.raises(ValueError, match="DEVICE_DATA_AXIS=.*this host has 8 "
                                         ".*DEVICE_SPACE_AXIS="):
        cls(load({"DEVICE_PLATFORM": "", **env}))


def test_space_replicas_take_consecutive_cards(eight_cards):
    from imageprocessor_tpu_torch.parallel import replica_devices

    cuda = [torch.device("cuda", i) for i in range(8)]
    assert replica_devices("cuda", 2, 3) == [tuple(cuda[0:3]), tuple(cuda[3:6])]
    assert replica_devices("cuda", None, 2) == [tuple(cuda[0:2])]
    assert replica_devices("cpu", 2, 2) == [(torch.device("cpu"),) * 2] * 2
    with pytest.raises(ValueError, match="not divisible by space=3"):
        make_devices(8, space=3)
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        replica_devices("cuda", 3, 3)
    with pytest.raises(ValueError, match="the one card cuda:1"):
        replica_devices("cuda:1", None, 2)


def test_engine_names_strips_on_one_device():
    """``devices`` entries: a device (space_axis strips on it) or one
    device per strip."""
    cpu = torch.device("cpu")
    eng = TorchProcessingEngine(CaptureStore(), device="cpu", devices=["cpu"],
                                space_axis=3)
    assert eng.replicas == [(cpu,) * 3] and eng.space_axis == 3
    eng.close()
    eng = TorchProcessingEngine(CaptureStore(), device="cpu",
                                devices=[("cpu", "cpu"), ("cpu", "cpu")])
    assert eng.replicas == [(cpu, cpu)] * 2 and eng.devices == [cpu, cpu]
    eng.close()
    with pytest.raises(ValueError, match="as many strips"):
        TorchProcessingEngine(CaptureStore(), device="cpu",
                              devices=[("cpu",), ("cpu", "cpu")])
