"""The port's one device path on the CPU: each group whole on one device,
coefficient groups staged (``_stage_coefs``), HWC groups packed
(``Group.pack``), over one replica or several (DEVICE_DATA_AXIS).

* artifacts through two CPU replicas are byte-identical to one
  replica's: the seven upload-form plans with the splice on and off, the
  flip, crop, grayscale and rotate plans with JPEG and PNG renditions,
  and the device JPEG switch at 0, on 4:2:0, 4:2:2, 4:4:0 and 4:4:4 JPEGs
  and a PNG, a 200-wide bucket among them;
* a 10-wide JPEG among images as wide as their 64 x 64 bucket: each slot
  of the staged canvases holds its planes and zeros elsewhere, equal to
  Group.pack's canvases, and every artifact equals the one a call with
  that upload alone gives;
* the staged path's B1 output within 1 LSB of the reference's
  ``batched_decode_ycbcr`` on the same operands, for every sampling, in a
  group as wide as its bucket and in one with a narrow image;
* against the reference's engine on one device
  (ProcessingEngine(use_pallas=False), float32): the engine contracts of
  ROADMAP's table, the port through two replicas;
* each of B1-B4 runs once per group, whichever replica runs it;
* DEVICE_SPACE_AXIS above 1 is refused by name by both workers before
  any backend opens, and ``devices=`` takes one device per replica.
"""

import cv2
import numpy as np
import pytest
import torch

from imageprocessor_tpu_torch import domain as d
from imageprocessor_tpu_torch.models import pipeline as pipeline_mod
from imageprocessor_tpu_torch.models.plan import normalize_operations
from imageprocessor_tpu_torch.runtime import batcher
from imageprocessor_tpu_torch.runtime import engine as engine_mod
from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
from tests.oracle import psnr

RNG = np.random.default_rng(1212)
P, T = d.OperationParams, d.OperationType

# cv2's sampling factors: 4:2:0, 4:2:2, 4:4:0, 4:4:4
SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
# kernel B1's chroma factors (fh, fw) of each sampling
FACTORS = {"420": (2, 2), "422": (1, 2), "440": (2, 1), "444": (1, 1)}


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
# the 64 x 64 bucket: a 10-wide image among images as wide as the bucket
NARROW = [jpeg(50, 10), jpeg(60, 64), jpeg(40, 64), png(64, 12), png(33, 64)]

WATERMARK = P(T.WATERMARK, {"text": "© replicas", "opacity": 0.5,
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


def run(blobs, ops, fmt="jpeg", first=0, **kw):
    """The same tasks (ids img{first}, img{first + 1}, ...) through a port
    engine on the CPU; -> the artifacts by path."""
    store = CaptureStore()
    eng = TorchProcessingEngine(store, device="cpu", **kw)
    try:
        res = eng.process_tasks([(_task(ops, fmt, f"img{first + k}"), b)
                                 for k, b in enumerate(blobs)])
    finally:
        eng.close()
    for r in res:
        assert r.result.status is d.ImageStatus.COMPLETED, r.result.error
    assert len(store.blobs) == len(blobs) * len(ops)
    return store.blobs


def assert_replicas_identical(blobs, ops, fmt="jpeg"):
    one = run(blobs, ops, fmt)
    two = run(blobs, ops, fmt, data_axis=2)
    assert two.keys() == one.keys()
    assert [p for p in one if two[p] != one[p]] == []


def decode_group(eng, ops, blobs, fmt="jpeg"):
    """The uploads decoded by ``eng`` into one group, as process_tasks
    groups them."""
    plan = normalize_operations(ops)
    items = []
    for k, blob in enumerate(blobs):
        arr, _det, layout, hw, sctx = eng.decode_for_plan_ex(blob, plan, fmt)
        items.append(batcher.BatchItem(
            item_id=str(k), image=arr, plan_key=plan.group_key(),
            payload=(k, _task(ops, fmt, f"img{k}"), fmt, plan), layout=layout,
            valid_hw=hw, splice=sctx))
    [group] = batcher.group_items(items)
    return group


@pytest.fixture()
def b1_calls(monkeypatch):
    """Kernel B1's operands (as host arrays) and output at each call."""
    seen = []
    inner = engine_mod.decode_coefs

    def decode(*args):
        out = inner(*args)
        seen.append(([a.numpy().copy() for a in args[:5]], out.numpy().copy()))
        return out

    monkeypatch.setattr(engine_mod, "decode_coefs", decode)
    return seen


# --- artifacts, two replicas against one --------------------------------------

@pytest.mark.parametrize("splice", ["1", "0"], ids=["splice", "nosplice"])
@pytest.mark.parametrize("flags", sorted(FORM_PLANS))
def test_form_plans_byte_identical_across_replicas(monkeypatch, flags, splice):
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", splice)
    assert_replicas_identical(SOURCES, FORM_PLANS[flags])


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_plans_byte_identical_across_replicas(monkeypatch, name, fmt):
    """The splice off: a JPEG rendition of flip and grayscale goes through
    B3; PNG renditions leave as pixels."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    assert_replicas_identical(SOURCES, TRANSFORMS[name], fmt)


@pytest.mark.parametrize("plan", ["trw", "flip_h"])
def test_device_jpeg_off_byte_identical_across_replicas(monkeypatch, plan):
    """IMAGEPROCESSOR_DEVICE_JPEG=0: every JPEG decoded on the host and
    packed as an HWC group."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    monkeypatch.setenv("IMAGEPROCESSOR_DEVICE_JPEG", "0")
    assert_replicas_identical(SOURCES, FORM_PLANS.get(plan) or TRANSFORMS[plan])


# --- the staged path ------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["jpeg", "png"])
def test_narrow_image_among_full_width_ones(monkeypatch, b1_calls, fmt):
    """The 64 x 64 bucket's JPEG group, a 10-wide upload beside two as wide
    as the bucket and a pad row: B1 reads Group.pack's canvases, each slot
    its planes and zeros past them; each artifact of the group's call is
    the one a call with that upload alone gives."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    eng = TorchProcessingEngine(CaptureStore(), device="cpu")
    try:
        group = decode_group(eng, MIXED, NARROW[:3], fmt)
        assert group.layout == "coef:22" and group.bucket == (64, 64)
        planes = [[np.array(p) for p in it.image[:3]] for it in group.items]
        want = group.pack(pad_batch_to=4)[0]
        eng.device_group(group)
    finally:
        eng.close()
    [(operands, _out)] = b1_calls
    for got, ref in zip(operands, want):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    for canvas, slots in zip(operands[:3], zip(*planes)):
        assert canvas.shape[0] == 4 and not canvas[3].any()   # the pad row
        for i, p in enumerate(slots):
            slot = np.zeros_like(canvas[i])
            slot[:p.shape[0], :p.shape[1]] = p
            assert np.array_equal(canvas[i], slot), i
    together = run(NARROW, MIXED, fmt)
    alone = {}
    for k, blob in enumerate(NARROW):
        alone.update(run([blob], MIXED, fmt, first=k))
    assert together.keys() == alone.keys()
    assert [p for p in together if together[p] != alone[p]] == []


@pytest.mark.parametrize("width", ["full", "narrow"])
@pytest.mark.parametrize("sampling", sorted(FACTORS))
def test_staged_decode_matches_the_reference_decode(b1_calls, sampling, width):
    """Kernel B1's plain version on the operands ``_stage_coefs`` built,
    within 1 LSB of the reference's batched_decode_ycbcr inside each valid
    region: three uploads as wide as the 200 bucket (a 208-wide canvas in
    4:2:0 and 4:2:2), or a 10-wide one among 64-wide ones."""
    from imageprocessor_tpu.ops.jpeg_decode import batched_decode_ycbcr

    dims = ([(64, 200), (60, 200), (50, 200)] if width == "full"
            else [(50, 10), (60, 64), (40, 64)])
    fh, fw = FACTORS[sampling]
    eng = TorchProcessingEngine(CaptureStore(), device="cpu")
    try:
        group = decode_group(eng, DEFAULT, [jpeg(h, w, sampling) for h, w in dims])
        assert group.layout == batcher.coef_layout(fh, fw)
        assert all(eng._slabs.owns(it.image[0]) for it in group.items)
        eng.device_group(group)
    finally:
        eng.close()
    [(operands, got)] = b1_calls
    hb, wb = group.bucket
    ref = np.asarray(batched_decode_ycbcr(*operands, fh=fh, fw=fw,
                                          out_h=hb, out_w=wb))
    assert got.shape == ref.shape == (4, 3, hb, wb)
    for i, (h, w) in enumerate(dims):
        diff = np.abs(got[i, :, :h, :w].astype(int) - ref[i, :, :h, :w].astype(int))
        assert diff.max() <= 1, i


@pytest.fixture()
def wrapper_calls(monkeypatch):
    """Calls of B1-B4's wrappers as the engine and the device step make
    them (the plain versions count no launch)."""
    calls = dict.fromkeys(("B1", "B2", "B3", "B4"), 0)
    for key, mod, name in (("B1", engine_mod, "decode_coefs"),
                           ("B3", engine_mod, "encode_420"),
                           ("B2", pipeline_mod, "fused_resample"),
                           ("B4", pipeline_mod, "planar_resample")):
        inner = getattr(mod, name)

        def counted(*a, _inner=inner, _key=key, **k):
            calls[_key] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("replicas", [1, 2])
def test_each_kernel_runs_once_per_group(monkeypatch, wrapper_calls, replicas):
    """Two staged 4:2:0 groups (the 128 x 256 and the 64 x 64 buckets): B1
    decodes each, B2 serves the thumbnail + resize pair and B4 the other
    resize of each, B3 encodes each group's flip."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    ops = DEFAULT + [P(T.RESIZE, {"width": 100, "height": 50}),
                     P(T.FLIP, {"direction": "horizontal"})]
    run(SOURCES[:3] + NARROW[:3], ops, data_axis=replicas)
    assert wrapper_calls == dict.fromkeys(("B1", "B2", "B3", "B4"), 2)


# --- against the reference's engine on one device -------------------------------

def _ref_run(blobs, ops, fmt):
    from imageprocessor_tpu.domain import OperationParams, OperationType
    from imageprocessor_tpu.domain import ProcessingTask as RefTask
    from imageprocessor_tpu.runtime.engine import ProcessingEngine

    store = CaptureStore()
    eng = ProcessingEngine(store, data_axis=1, use_pallas=False,
                           compute_dtype="float32")
    assert eng._mesh is None
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
    reference's engine, and the resize and the thumbnail within 1 LSB and
    above 45 dB of the float64 Go oracle."""
    from tests import oracle

    ops = [P(T.THUMBNAIL, {"size": 64, "crop_to_fit": True}),
           P(T.RESIZE, {"width": 160, "height": 120, "keep_aspect": True}),
           P(T.FLIP, {"direction": "horizontal"}), P(T.GRAYSCALE, {}),
           P(T.CROP, {"x": 20, "y": 10, "width": 120, "height": 60})]
    srcs = [photo(90, 230), photo(128, 200), photo(100, 256)]
    blobs = [cv2.imencode(".png", a)[1].tobytes() for a in srcs]
    ref = _ref_run(blobs, ops, "png")
    port = run(blobs, ops, "png", data_axis=2)
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
    (the reference decodes these sources on the host on the CPU, so its
    pixels are libjpeg's: smooth photos, as tests/test_torch_device_jpeg.py
    uses)."""
    ops = DEFAULT + [WATERMARK]
    blobs = [jpeg(120, 250, noise=12), jpeg(100, 256, noise=12),
             jpeg(110, 240, "422", noise=12), jpeg(100, 230, "440", noise=12),
             jpeg(125, 200, "444", noise=12)]
    ref = _ref_run(blobs, ops, "jpeg")
    port = run(blobs, ops, data_axis=2)
    assert ref.keys() == port.keys()
    for path in ref:
        if "watermark" in path:
            assert ref[path] == port[path], path
            continue
        a = cv2.imdecode(np.frombuffer(ref[path], np.uint8), cv2.IMREAD_COLOR)
        b = cv2.imdecode(np.frombuffer(port[path], np.uint8), cv2.IMREAD_COLOR)
        assert a.shape == b.shape, path
        assert psnr(a, b) > 45.0, path


# --- the refusals -----------------------------------------------------------------

@pytest.fixture()
def eight_cards(monkeypatch):
    """torch.cuda as a host with eight cards would report it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("env", [
    {"DEVICE_SPACE_AXIS": "2"}, {"DEVICE_SPACE_AXIS": "9"},
    {"DEVICE_PLATFORM": "cuda:1", "DEVICE_SPACE_AXIS": "2"}],
    ids=["space_2", "space_9", "named_card"])
@pytest.mark.parametrize("kind", ["batch", "pipelined"])
def test_worker_refuses_the_space_axis_by_name(eight_cards, monkeypatch, kind, env):
    """Eight cards would hold any of these meshes: the space axis is refused
    all the same, by name, before any backend opens."""
    from imageprocessor_tpu_torch.config import load
    from imageprocessor_tpu_torch.service import pipelined, worker

    def no_backend(*a, **k):
        raise AssertionError("a backend was opened")

    monkeypatch.setattr(worker, "build_metadata_store", no_backend)
    cls = worker.Worker if kind == "batch" else pipelined.PipelinedWorker
    want = env["DEVICE_SPACE_AXIS"]
    with pytest.raises(ValueError, match=f"DEVICE_SPACE_AXIS={want}: the space "
                                         "axis is not served"):
        cls(load({"DEVICE_PLATFORM": "", **env}))


def test_devices_takes_one_device_per_replica():
    cpu = torch.device("cpu")
    eng = TorchProcessingEngine(CaptureStore(), device="cpu", devices=["cpu", cpu])
    assert eng.devices == [cpu, cpu] and eng.device == cpu
    eng.close()
    with pytest.raises(ValueError, match="one device each"):
        TorchProcessingEngine(CaptureStore(), device="cpu",
                              devices=[("cpu", "cpu")])
