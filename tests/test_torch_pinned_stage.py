"""The device stage's staging slabs (runtime/staging.py) and the engine's
``_stage_coefs`` against the path they replace, ``Group.pack`` and a copy
of each of its canvases, on the CPU (the slabs are plain numpy memory here; the recycling is the
card's).

* for every coefficient layout B1 decodes (coef:22, coef:12, coef:21,
  coef:11), kernel B1's operands and the group's outputs are byte-equal to
  the packed path's on the same items: mixed sizes in one bucket with a pad
  row, the 200 rung (canvas 208, not MCU-aligned), and a watermark group
  where one upload rides with its splice context (scanned outside the
  slabs) beside pooled ones;
* a slab scanned with a dense image and then, reused, with a sparse one
  holds a fresh scan's planes (the used extent is zeroed);
* an exhausted pool falls back to planes of their own, counts
  ``engine_stage_pool_misses`` and gives the same results; a slab never
  given back is freed with its planes and the pool allocates in its place;
* the HWC path still packs: what it uploads is ``Group.pack``'s;
* ``process_tasks`` counts each plane byte in ``engine_h2d_bytes`` and
  ``engine_h2d_pinned_bytes`` and returns every slab;
* the pool under many threads hands no slab to two holders at once.
"""

import gc
import sys
import threading

import cv2
import numpy as np
import pytest
import torch

from imageprocessor_tpu_torch.domain import (
    ImageStatus,
    OperationParams,
    OperationType,
    ProcessingTask,
)
from imageprocessor_tpu_torch.models.plan import normalize_operations
from imageprocessor_tpu_torch.runtime import batcher, hostcodec
from imageprocessor_tpu_torch.runtime import engine as engine_mod
from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
from imageprocessor_tpu_torch.runtime.staging import SlabPool
from imageprocessor_tpu_torch.utils.metrics import METRICS
from imageprocessor_tpu_torch.utils.tracing import span

P, T = OperationParams, OperationType
DEFAULT = [P(T.THUMBNAIL, {"size": 64, "crop_to_fit": True}),
           P(T.RESIZE, {"width": 128, "height": 96, "keep_aspect": True})]
MARK = P(T.WATERMARK, {"text": "© ImageProcessor", "opacity": 0.5,
                       "position": "bottom-right"})
# luma (fh, fw) of each layout -> OpenCV's sampling factor
SAMPLING = {"coef:22": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "coef:12": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "coef:21": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "coef:11": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
# each case's uploads: (h, w), the task's format; all in one bucket
CASES = {
    # bucket (384, 512), three uploads: one pad row
    "mixed sizes and a pad row": [((300, 400), "jpeg"), ((290, 390), "jpeg"),
                                  ((257, 385), "jpeg")],
    # bucket (200, 200): the canvas is 208, past the bucket
    "the 200 rung": [((190, 200), "jpeg"), ((200, 193), "jpeg"),
                     ((180, 170), "jpeg")],
    # the jpeg rendition splices (its planes are the splice context's),
    # the png ones are pooled; the watermark is blended for all on device
    "a splice context beside pooled planes": [
        ((300, 400), "png"), ((290, 390), "jpeg"), ((257, 385), "png")],
}


def jpeg(h, w, seed, layout="coef:22", noise=40):
    rng = np.random.default_rng(seed)
    img = np.clip(np.linspace(0, 200, h)[:, None, None]
                  + np.linspace(0, 50, w)[None, :, None]
                  + rng.integers(0, noise + 1, (h, w, 3)), 0, 255).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         SAMPLING[layout]])
    assert ok
    return buf.tobytes()


def png(h, w, seed):
    rng = np.random.default_rng(seed)
    ok, buf = cv2.imencode(".png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    assert ok
    return buf.tobytes()


class Store:
    def __init__(self):
        self.blobs = {}

    def save_processed(self, path, data, mime=None):
        self.blobs[path] = data


def task(k, ops, fmt="jpeg"):
    return ProcessingTask(id=f"t{k}", image_id=f"i{k}", original_path="o",
                          bucket="images", operations=ops, format=fmt)


def decode_group(eng, ops, blobs, fmts=None):
    """The uploads decoded by ``eng`` into one group, as process_tasks
    groups them."""
    plan = normalize_operations(ops)
    items = []
    for k, blob in enumerate(blobs):
        fmt = fmts[k] if fmts else "jpeg"
        arr, _det, layout, hw, sctx = eng.decode_for_plan_ex(blob, plan, fmt)
        items.append(batcher.BatchItem(
            item_id=str(k), image=arr, plan_key=plan.group_key(),
            payload=(k, task(k, ops, fmt), fmt, plan), layout=layout,
            valid_hw=hw, splice=sctx))
    [group] = batcher.group_items(items)
    return group


def packed(group, b, device):
    """The path the staging replaces: Group.pack's host canvases, each
    copied to ``device`` in an ``h2d`` span of its own."""
    with span("pack", images=len(group.items)):
        imgs, src_hw = group.pack(pad_batch_to=b)
    return [engine_mod._h2d(a, device) for a in imgs], src_hw


def b1_operands(monkeypatch):
    """Record kernel B1's operands (as host arrays) at each launch."""
    seen = []
    inner = engine_mod.decode_coefs

    def decode(*args):
        seen.append([a.numpy().copy() for a in args[:5]])
        return inner(*args)

    monkeypatch.setattr(engine_mod, "decode_coefs", decode)
    return seen


def assert_outputs_equal(got, want):
    (plan_a, outs_a, hws_a, lay_a), (plan_b, outs_b, hws_b, lay_b) = got, want
    assert plan_a == plan_b and lay_a == lay_b and hws_a.keys() == hws_b.keys()
    assert all(np.array_equal(hws_a[k], hws_b[k]) for k in hws_b)
    assert len(outs_a) == len(outs_b)
    for a, b in zip(outs_a, outs_b):
        if isinstance(a, tuple):
            assert a[0] == b[0] and all(
                np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)


def counter(name):
    return METRICS.snapshot()["counters"].get(name, 0)


@pytest.fixture
def splice_on(monkeypatch):
    monkeypatch.delenv("IMAGEPROCESSOR_JPEG_SPLICE", raising=False)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("layout", sorted(SAMPLING))
def test_staged_operands_and_outputs_equal_the_packed_paths(
        monkeypatch, splice_on, layout, case):
    uploads = CASES[case]
    ops = DEFAULT + [MARK] if "splice" in case else DEFAULT
    blobs = [jpeg(h, w, k, layout) for k, ((h, w), _f) in enumerate(uploads)]
    eng = TorchProcessingEngine(Store(), device="cpu", codec_threads=1)
    try:
        group = decode_group(eng, ops, blobs, [f for _hw, f in uploads])
        assert group.layout == layout and len(group.items) == 3
        pooled = [eng._slabs.owns(it.image[0]) for it in group.items]
        assert pooled == [it.splice is None for it in group.items]
        assert pooled == [f == "png" for _hw, f in uploads] if "splice" in case \
            else all(pooled)
        seen = b1_operands(monkeypatch)
        METRICS.reset()
        staged = eng.device_group(group)
        plane_bytes = sum(p.nbytes for it in group.items for p in it.image[:3])
        assert counter("engine_h2d_pinned_bytes") == sum(
            p.nbytes for it, own in zip(group.items, pooled) if own
            for p in it.image[:3])
        assert counter("engine_h2d_bytes") > plane_bytes
        assert counter("engine_pack_images") == 3
        assert eng._slabs.slabs() == (sum(pooled), 0)   # all given back
        monkeypatch.setattr(eng, "_stage_coefs", packed)
        want = eng.device_group(group)
    finally:
        eng.close()
    assert len(seen) == 2
    for got, ref in zip(*seen):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert seen[0][0].shape[0] == 4          # three uploads and a pad row
    assert_outputs_equal(staged, want)


def test_a_reused_slab_holds_a_fresh_scan(splice_on):
    """Dense coefficients, then a sparse image of the same size in the same
    slab: every coefficient the dense scan left is zeroed."""
    dense = jpeg(240, 320, 1, noise=255)
    sparse = jpeg(240, 320, 2, noise=0)
    eng = TorchProcessingEngine(Store(), device="cpu", batch_size=1)
    plan = normalize_operations(DEFAULT)
    try:
        first = eng.decode_for_plan_ex(dense, plan)[0]
        slab, dense_nonzero = first[0].ctypes.data, np.count_nonzero(first[0])
        eng._slabs.give(first[0])
        again = eng.decode_for_plan_ex(sparse, plan)[0]
    finally:
        eng.close()
    assert again[0].ctypes.data == slab
    fresh, qt, _size, _samp = hostcodec.scan_jpeg_coefficients(sparse)
    assert dense_nonzero > 4 * np.count_nonzero(fresh[0])
    for got, want in zip(again[:3], fresh):
        assert np.array_equal(got, want)
    assert np.array_equal(again[3], qt)


def test_an_exhausted_pool_falls_back_and_counts_the_misses(monkeypatch):
    """batch_size 1: two slabs. A third upload scanned while both are out
    gets planes of its own, counted as a miss; its group's B1 operands and
    outputs equal the packed path's. A slab never given back is freed with
    its planes, and the pool allocates again."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    blobs = [jpeg(300, 400, k) for k in range(3)]
    eng = TorchProcessingEngine(Store(), device="cpu", batch_size=1)
    try:
        METRICS.reset()
        group = decode_group(eng, DEFAULT, blobs)
        assert counter("engine_stage_pool_misses") == 1
        assert [eng._slabs.owns(it.image[0]) for it in group.items] == [
            True, True, False]
        seen = b1_operands(monkeypatch)
        staged = eng.device_group(group)
        assert eng._slabs.slabs() == (2, 0)
        monkeypatch.setattr(eng, "_stage_coefs", packed)
        want = eng.device_group(group)
        for got, ref in zip(*seen):
            assert np.array_equal(got, ref)
        assert_outputs_equal(staged, want)
        # two uploads scanned into the two slabs the group gave back, and
        # dropped without a device stage (with the old group, whose planes
        # were views of the same slabs)
        monkeypatch.undo()
        lost = decode_group(eng, DEFAULT, blobs[:2])
        assert eng._slabs.slabs() == (0, 2)
        del lost, group
        gc.collect()
        assert eng._slabs.slabs() == (0, 0)
        METRICS.reset()
        assert decode_group(eng, DEFAULT, blobs[:2])
        assert counter("engine_stage_pool_misses") == 0
    finally:
        eng.close()


def test_streams_b1_does_not_decode_take_no_slab():
    """4:1:1 and grayscale scans take the pixel decode: no slab is out."""
    gray = cv2.imencode(".jpg", np.full((64, 80), 90, np.uint8))[1].tobytes()
    eng = TorchProcessingEngine(Store(), device="cpu")
    try:
        for blob in (gray, cv2.imencode(".jpg", np.zeros((64, 80, 3), np.uint8), [
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])[1].tobytes()):
            assert eng.decode_for_plan_ex(blob, normalize_operations(DEFAULT))[2] == "hwc"
        assert eng._slabs.slabs() == (0, 0)
    finally:
        eng.close()


@pytest.mark.parametrize("path", ["hwc"])
def test_the_strip_and_hwc_paths_upload_what_group_pack_packs(monkeypatch, path):
    """An HWC group is not staged: it uploads Group.pack's canvas (the
    parent's bytes), and holds no slab."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    blobs = [png(300, 400, k) for k in range(3)]
    eng = TorchProcessingEngine(Store(), device="cpu")
    uploaded = []

    def stage(*_a):
        raise AssertionError("an HWC group was staged")

    monkeypatch.setattr(eng, "_stage_coefs", stage)
    inner = eng._upload
    monkeypatch.setattr(eng, "_upload", lambda imgs, *a: uploaded.append(imgs) or inner(imgs, *a))
    try:
        group = decode_group(eng, DEFAULT + [MARK], blobs)
        assert group.layout == "hwc"
        eng.device_group(group)
        assert eng._slabs.slabs() == (0, 0)
        assert np.array_equal(uploaded[0], group.pack(pad_batch_to=4)[0])
    finally:
        eng.close()


def test_process_tasks_stages_every_plane_from_a_slab(monkeypatch):
    """The batched path end to end: each plane byte is counted as copied
    from a slab, one h2d span carries the group, every slab comes back, and
    the artifacts equal the packed path's byte for byte."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    blobs = [jpeg(300, 400, k) for k in range(3)] + [png(120, 160, 9)]
    work = [(task(k, DEFAULT + [MARK]), b) for k, b in enumerate(blobs)]
    arts = []
    for staged in (True, False):
        eng = TorchProcessingEngine(Store(), device="cpu")
        if not staged:
            monkeypatch.setattr(eng, "_stage_coefs", packed)
        try:
            METRICS.reset()
            res = eng.process_tasks(work)
            snap = METRICS.snapshot()
            assert eng._slabs.slabs()[1] == 0
        finally:
            eng.close()
        assert all(r.result.status is ImageStatus.COMPLETED for r in res)
        arts.append(eng.store.blobs)
        planes = sum(s[0] * s[1] for b in blobs[:3]
                     for s in hostcodec.scan_jpeg_layout(b)[0]) * 2
        pinned = snap["counters"].get("engine_h2d_pinned_bytes", 0)
        assert pinned == (planes if staged else 0)
        # the coefficient group's copies: one span staged, five packed;
        # the png group's one
        assert snap["timings"]["span_h2d_ms"]["count"] == (2 if staged else 6)
    assert arts[0] == arts[1] and len(arts[0]) == 12


def test_the_pool_hands_no_slab_to_two_holders():
    """Many threads take, write, check and give back slabs of a pool of
    four: no slab is held twice at once, no more than four are ever out,
    and every one is free at the end."""
    pool = SlabPool(4, pinned=False)
    held, lock, errors = set(), threading.Lock(), []
    shapes = [[(16, 16), (8, 8), (8, 8)], [(32, 48), (16, 24), (16, 24)]]

    def work(k):
        try:
            for i in range(300):
                planes = pool.take(shapes[(k + i) % 2])
                if planes is None:
                    continue
                addr = planes[0].ctypes.data
                with lock:
                    assert addr not in held and len(held) < 4
                    held.add(addr)
                assert not any(p.any() for p in planes)
                for p in planes:
                    p[...] = k + 1
                assert all((p == k + 1).all() for p in planes)
                with lock:
                    held.discard(addr)
                pool.give(planes[0])
        except AssertionError as exc:  # pragma: no cover - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    free, out = pool.slabs()
    assert out == 0 and 1 <= free <= 4


@pytest.mark.gpu
def test_staged_path_on_the_card_equals_the_packed_path(monkeypatch):
    """On a card the slabs are page-locked; a group staged from them gives
    B1 the packed path's operands and the same outputs, every plane byte
    from a slab. Skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    blobs = [jpeg(h, w, k) for k, ((h, w), _f) in enumerate(
        CASES["mixed sizes and a pad row"])]
    eng = TorchProcessingEngine(Store(), device="cuda:0")
    eng._card_entropy = False   # the host scans into the slabs here
    seen = []
    inner = engine_mod.decode_coefs

    def decode(*args):
        seen.append([a.cpu().numpy() for a in args[:5]])
        return inner(*args)

    monkeypatch.setattr(engine_mod, "decode_coefs", decode)
    try:
        group = decode_group(eng, DEFAULT, blobs)
        assert eng._slabs.pinned and all(
            torch.from_numpy(it.image[0]).is_pinned() for it in group.items)
        METRICS.reset()
        staged = eng.device_group(group)
        plane_bytes = sum(p.nbytes for it in group.items for p in it.image[:3])
        assert counter("engine_h2d_pinned_bytes") == plane_bytes
        monkeypatch.setattr(eng, "_stage_coefs", packed)
        want = eng.device_group(group)
    finally:
        eng.close()
    for got, ref in zip(*seen):
        assert np.array_equal(got, ref)
    assert_outputs_equal(staged, want)
