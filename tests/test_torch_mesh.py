"""Data-parallel serving on the port (parallel/mesh.py, the replicas of
TorchProcessingEngine) on CPU replicas, against one replica and against
the reference's sharded engine.

The counterparts of tests/test_parallel.py's mesh shapes and of
tests/test_engine_sharded.py. Where the reference splits each group's
batch across its chips, the port runs each group whole on the next free
replica, the groups of a call side by side (a thread each; the pipelined
worker has a device thread per replica). Contracts:

* artifacts over several replicas: byte-identical to one replica's (a
  group's device work is the same whichever replica runs it);
* against the reference's sharded engine (8 virtual CPU devices,
  interpret-mode Pallas, float32): the engine contracts of
  tests/test_torch_engine.py — equal paths, spliced watermarks
  byte-identical, every other JPEG artifact PSNR > 45 dB;
* a corrupt upload fails alone in a sharded group; a Worker built from
  DEVICE_PLATFORM=cpu, DEVICE_DATA_AXIS=4 serves through four replicas.

Which cards exist is decided inside the tests (``torch.cuda`` patched
where a test needs several), never at import.
"""

import io
import uuid

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from imageprocessor_tpu.domain import ImageStatus
from imageprocessor_tpu.runtime.codecs import decode_image
from imageprocessor_tpu.runtime.engine import ProcessingEngine
from imageprocessor_tpu_torch import domain as d
from imageprocessor_tpu_torch.parallel import make_devices, replica_devices
from imageprocessor_tpu_torch.runtime import engine as engine_mod
from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
from imageprocessor_tpu_torch.storage import LocalFSObjectStore as PortLocalFS
from tests.oracle import psnr

RNG = np.random.default_rng(31)


class CaptureStore:
    def __init__(self):
        self.blobs: dict[str, bytes] = {}

    def save_processed(self, path, data, mime=None):
        self.blobs[path] = data


def _blob(h, w, fmt="PNG", quality=92):
    arr = RNG.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    bio = io.BytesIO()
    kw = {"quality": quality} if fmt == "JPEG" else {}
    PILImage.fromarray(arr).save(bio, format=fmt, **kw)
    return bio.getvalue()


def _task(ops, fmt="png", iid=None):
    iid = iid or str(uuid.uuid4())
    return d.ProcessingTask(id=iid, image_id=iid, original_path=f"o/{iid}",
                            bucket="b", operations=ops, format=fmt)


def _ops(domain):
    P, T = domain.OperationParams, domain.OperationType
    return [P(T.THUMBNAIL, {"size": 64, "crop_to_fit": True}),
            P(T.RESIZE, {"width": 128, "height": 96, "keep_aspect": True}),
            P(T.WATERMARK, {"text": "dp"})]


def _flip_gray(domain):
    P, T = domain.OperationParams, domain.OperationType
    return [P(T.FLIP, {"direction": "horizontal"}), P(T.GRAYSCALE, {}),
            P(T.ROTATE, {"angle": 90}),
            P(T.CROP, {"x": 8, "y": 4, "width": 50, "height": 40})]


PNGS = [_blob(100, 140), _blob(120, 150), _blob(60, 70), _blob(100, 140),
        _blob(90, 130)]   # two buckets: a group of four, a group of one
JPEGS = [_blob(110, 150, "JPEG"), _blob(120, 140, "JPEG"),
         _blob(100, 150, "JPEG"), _blob(115, 145, "JPEG"),
         _blob(60, 80, "JPEG")]


def _run(blobs, fmt, ops, **kw):
    """The same tasks (same ids) through a port engine; -> (results, blobs)."""
    store = CaptureStore()
    eng = TorchProcessingEngine(store, device="cpu", **kw)
    try:
        res = eng.process_tasks([(_task(ops, fmt, iid=f"img{k}"), b)
                                 for k, b in enumerate(blobs)])
    finally:
        eng.close()
    for r in res:
        assert r.result.status is d.ImageStatus.COMPLETED, r.result.error
    return res, store.blobs


# --- parallel/mesh.py ---------------------------------------------------------

@pytest.fixture()
def eight_cards(monkeypatch):
    """torch.cuda as a host with eight cards would report it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def test_make_devices_shapes(eight_cards):
    assert make_devices() == [torch.device("cuda", i) for i in range(8)]
    assert make_devices(3) == [torch.device("cuda", i) for i in range(3)]
    assert make_devices(None) == make_devices(8)


@pytest.mark.parametrize("n,message", [
    (0, "must be positive"), (-2, "must be positive"),
    (999, "requested 999 devices, have 8")])
def test_make_devices_refusals(eight_cards, n, message):
    with pytest.raises(ValueError, match=message):
        make_devices(n)


def test_make_devices_counts_the_hosts_cards():
    """Without the patch: this host's own count, whatever it is."""
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {have + 1} devices, have {have}"):
        make_devices(have + 1)


@pytest.mark.parametrize("device,axis,want", [
    ("cuda", None, 1), ("cuda", 0, 1), ("cuda", 2, 2), ("cuda", 8, 8),
    ("cuda:3", None, 1), ("cuda:3", 1, 1), ("cpu", None, 1), ("cpu", 4, 4)])
def test_replica_devices(eight_cards, device, axis, want):
    got = replica_devices(device, axis)
    assert len(got) == want
    if device == "cuda:3":
        assert got == [torch.device("cuda", 3)]
    elif device == "cpu":
        assert got == [torch.device("cpu")] * want
    else:
        assert got == [torch.device("cuda", i) for i in range(want)]


@pytest.mark.parametrize("device,axis,message", [
    ("cuda", 9, "requested 9 devices, have 8"),
    ("cuda:1", 2, "data_axis=2 with the one card cuda:1"),
    ("cpu", -1, "must not be negative"), ("cuda", -3, "must not be negative")])
def test_replica_devices_refusals(eight_cards, device, axis, message):
    with pytest.raises(ValueError, match=message):
        replica_devices(device, axis)


# --- the engine on CPU replicas ----------------------------------------------

@pytest.mark.parametrize("axis", [3, 4])
def test_png_groups_sharded_match_one_replica(axis):
    """Mixed sizes in two buckets, their groups on two of the replicas
    side by side; nothing is padded for the replicas."""
    ops = _ops(d)
    one, blobs_1 = _run(PNGS, "png", ops)
    many, blobs_n = _run(PNGS, "png", ops, data_axis=axis)
    assert blobs_n == blobs_1
    for a, b in zip(one, many):
        assert [vars(x) for x in a.artifacts] == [vars(x) for x in b.artifacts]
        assert len(b.artifacts) == 3


@pytest.mark.parametrize("splice", ["1", "0"], ids=["splice", "nosplice"])
@pytest.mark.parametrize("axis", [3, 4])
def test_jpeg_groups_sharded_match_one_replica(monkeypatch, axis, splice):
    """The coefficient route (B1's plain version on each replica); with
    the splice off the watermark is blended and encoded by B3's plain
    version, and the transforms of the second plan leave as pixels (crop,
    rotate) or through B3 (flip, grayscale)."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", splice)
    for ops in (_ops(d), _flip_gray(d)):
        _, blobs_1 = _run(JPEGS, "jpeg", ops)
        _, blobs_n = _run(JPEGS, "jpeg", ops, data_axis=axis)
        assert blobs_n == blobs_1


def test_sharded_device_group_layout(monkeypatch):
    """A group of four on an engine of three replicas runs whole on one
    of them, at one replica's batch (four rows: nothing padded for the
    replicas), and its outputs are one replica's."""
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "0")
    seen = []
    eng = TorchProcessingEngine(CaptureStore(), device="cpu", data_axis=3)
    one = TorchProcessingEngine(CaptureStore(), device="cpu")
    inner = eng._upload
    monkeypatch.setattr(eng, "_upload", lambda imgs, group, device: seen.append(
        (imgs[0].shape[0], device)) or inner(imgs, group, device))
    from imageprocessor_tpu_torch.runtime import batcher
    plan = engine_mod.normalize_operations(_ops(d))
    items = []
    for k, blob in enumerate(JPEGS[:4]):
        arr, _f, layout, hw, sctx = eng.decode_for_plan_ex(blob, plan, "jpeg")
        items.append(batcher.BatchItem(item_id=str(k), image=arr,
                                       plan_key=plan.group_key(),
                                       payload=(k, _task(_ops(d), "jpeg"), "jpeg",
                                                plan),
                                       layout=layout, valid_hw=hw, splice=sctx))
    [group] = batcher.group_items(items)
    try:
        _plan, outs, out_hws, _ = eng.device_group(group)
        _, want, want_hws, _ = one.device_group(group)
    finally:
        eng.close()
        one.close()
    assert seen == [(4, torch.device("cpu"))]
    assert sorted(eng.replica_groups) == [0, 0, 1]
    assert outs[0].shape[0] == 4 and out_hws[1].shape == (4, 2)
    assert outs[2][0] == "coef420" and outs[2][1].shape[0] == 4
    assert np.array_equal(outs[0], want[0]) and np.array_equal(outs[1], want[1])
    assert all(np.array_equal(a, b) for a, b in zip(outs[2][1:], want[2][1:]))
    assert all(np.array_equal(out_hws[k], want_hws[k]) for k in want_hws)


def test_groups_run_side_by_side_on_distinct_replicas(monkeypatch):
    """process_tasks runs its groups at once, each on a replica no other
    group holds: two groups on two replicas meet inside the device stage
    (a barrier both must reach), and each replica ran one of them."""
    import threading
    eng = TorchProcessingEngine(CaptureStore(), device="cpu", data_axis=2)
    inner = eng._device_group
    met = threading.Barrier(2, timeout=30)
    held = []

    def device_group(group, device):
        held.append(threading.current_thread().name)
        met.wait()
        return inner(group, device)

    monkeypatch.setattr(eng, "_device_group", device_group)
    try:
        res = eng.process_tasks([(_task(_ops(d)), b) for b in PNGS])
    finally:
        eng.close()
    assert all(r.result.status is d.ImageStatus.COMPLETED for r in res)
    assert eng.replica_groups == [1, 1] and len(set(held)) == 2


def test_one_replica_runs_in_the_callers_thread():
    """One replica (the default): no replica threads, no queue, no side
    stream; the group runs in the caller's thread."""
    eng = TorchProcessingEngine(CaptureStore(), device="cpu")
    try:
        assert eng.devices == [torch.device("cpu")]
        assert eng._replicas is None and eng._free is None
        res = eng.process_tasks([(_task(_ops(d)), b) for b in PNGS])
    finally:
        eng.close()
    assert all(r.result.status is d.ImageStatus.COMPLETED for r in res)
    assert eng.replica_groups == [2]


@pytest.fixture(scope="module")
def ref_sharded():
    """The reference's sharded engine on its coefficient route, as
    tests/test_engine_sharded.py builds it (float32 resampling, the port's
    contract)."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    store = CaptureStore()
    eng = ProcessingEngine(store, data_axis=4, device_jpeg=True, use_pallas=True,
                           pallas_interpret=True, compute_dtype="float32")
    assert eng._mesh is not None
    yield eng, store
    eng.close()


@pytest.mark.parametrize("axis", [3, 4])
def test_jpeg_groups_sharded_match_reference(ref_sharded, axis):
    """Port sharded over `axis` CPU replicas against the reference sharded
    over 4 virtual devices: equal paths, the spliced watermark byte for
    byte, the resamples PSNR > 45 dB."""
    from imageprocessor_tpu.domain import OperationParams, OperationType
    from imageprocessor_tpu.domain import ProcessingTask as RefTask
    ref, s_ref = ref_sharded
    ref_ops = [OperationParams(OperationType.THUMBNAIL, {"size": 64, "crop_to_fit": True}),
               OperationParams(OperationType.RESIZE,
                               {"width": 128, "height": 96, "keep_aspect": True}),
               OperationParams(OperationType.WATERMARK, {"text": "dp"})]
    ids = [str(uuid.uuid4()) for _ in JPEGS]
    r_ref = ref.process_tasks([(RefTask(id=i, image_id=i, original_path="o",
                                        bucket="b", operations=ref_ops,
                                        format="jpeg"), b)
                               for i, b in zip(ids, JPEGS)])
    store = CaptureStore()
    port = TorchProcessingEngine(store, device="cpu", data_axis=axis)
    try:
        r_port = port.process_tasks([(_task(_ops(d), "jpeg", iid=i), b)
                                     for i, b in zip(ids, JPEGS)])
    finally:
        port.close()
    for a, b in zip(r_ref, r_port):
        assert a.result.status is ImageStatus.COMPLETED, a.result.error
        assert b.result.status is d.ImageStatus.COMPLETED, b.result.error
        assert a.result.processed_paths == b.result.processed_paths
        for op, path in a.result.processed_paths.items():
            x, y = s_ref.blobs[path], store.blobs[path]
            if op == "watermark":
                assert x == y, path
            else:
                u, _ = decode_image(x)
                v, _ = decode_image(y)
                assert u.shape == v.shape
                assert psnr(u, v) > 45.0, path


def test_sharded_per_image_failure_isolation():
    ops = _ops(d)
    store = CaptureStore()
    eng = TorchProcessingEngine(store, device="cpu", data_axis=4)
    try:
        res = eng.process_tasks([(_task(ops), PNGS[0]),
                                 (_task(ops), b"not an image at all"),
                                 (_task(ops), PNGS[4]),
                                 (_task(ops, "jpeg"), JPEGS[0][:500])])
    finally:
        eng.close()
    status = [r.result.status for r in res]
    assert status == [d.ImageStatus.COMPLETED, d.ImageStatus.FAILED,
                      d.ImageStatus.COMPLETED, d.ImageStatus.FAILED]
    assert res[1].error_kind == engine_mod.PERMANENT


def test_a_failing_shard_fails_its_group_transient(monkeypatch):
    """A device error on one replica fails its group, TRANSIENT (the
    worker nacks it for redelivery); the other replica's group completes,
    and the failing replica is free again for the next call."""
    eng = TorchProcessingEngine(CaptureStore(), device="cpu", data_axis=2)
    inner = eng._upload

    def upload(imgs, group, device):
        if len(group.items) == 1:   # the lone 60x70 image's group
            raise torch.OutOfMemoryError("replica out of memory")
        return inner(imgs, group, device)

    monkeypatch.setattr(eng, "_upload", upload)
    try:
        res = eng.process_tasks([(_task(_ops(d)), b) for b in PNGS])
        monkeypatch.setattr(eng, "_upload", inner)
        again = eng.process_tasks([(_task(_ops(d)), b) for b in PNGS])
    finally:
        eng.close()
    for k, r in enumerate(res):
        if k == 2:
            assert r.result.status is d.ImageStatus.FAILED
            assert r.error_kind == engine_mod.TRANSIENT
            assert "out of memory" in r.result.error
        else:
            assert r.result.status is d.ImageStatus.COMPLETED, r.result.error
    assert all(r.result.status is d.ImageStatus.COMPLETED for r in again)
    assert sum(eng.replica_groups) == 4


def test_worker_serves_through_four_replicas(tmp_path):
    """A Worker built from config with DEVICE_DATA_AXIS=4 (the real
    serving path) serves three uploads through four CPU replicas."""
    from imageprocessor_tpu_torch.broker.memory import MemoryBroker
    from imageprocessor_tpu_torch.config import load
    from imageprocessor_tpu_torch.service.usecase import ImageUsecase
    from imageprocessor_tpu_torch.service.worker import Worker
    from imageprocessor_tpu_torch.storage import SQLiteMetadataStore
    from imageprocessor_tpu_torch.utils import RetryStrategy

    cfg = load({"DEVICE_DATA_AXIS": "4", "DEVICE_PLATFORM": "cpu"})
    cfg.worker.batch_size = 4
    meta = SQLiteMetadataStore(":memory:")
    store = PortLocalFS(str(tmp_path / "objects"))
    broker = MemoryBroker()
    uc = ImageUsecase(meta, store, broker,
                      retries=RetryStrategy(attempts=2, delay_ms=1))
    worker = Worker(cfg, meta=meta, store=store, broker=broker)
    try:
        assert worker.engine.devices == [torch.device("cpu")] * 4
        imgs = [uc.upload_image(_blob(80, 100), f"{i}.png", "image/png", _ops(d))
                for i in range(3)]
        assert worker.run_once() == 3
        for img in imgs:
            assert meta.get_image(img.id).status is d.ImageStatus.COMPLETED
            assert len(meta.list_processed(img.id)) == 3
    finally:
        worker.engine.close()


def test_pipelined_worker_runs_a_device_thread_per_replica(tmp_path):
    """The pipelined worker with DEVICE_DATA_AXIS=3 streams through three
    device threads, one per replica; its groups spread over the replicas,
    and stop() ends every stage thread."""
    import threading

    from tests.test_torch_worker import PORT, Stack

    stack = Stack(PORT, "pipelined", tmp_path, env={"DEVICE_DATA_AXIS": "3"},
                  batch_deadline_ms=5)
    try:
        assert stack.worker.engine.devices == [torch.device("cpu")] * 3
        ids = [stack.uc.upload_image(blob, f"{k}.png", "image/png", _ops(d)).id
               for k, blob in enumerate(PNGS)]
        stack.drive(ids)
        assert {stack.status(i) for i in ids} == {"completed"}
        names = {t.name for t in threading.enumerate()}
        assert {"device0", "device1", "device2"} <= names
        assert sum(stack.worker.engine.replica_groups) >= 2
    finally:
        stack.close()
    assert not {"device0", "device1", "device2"} & {
        t.name for t in threading.enumerate()}


@pytest.mark.parametrize("platform,axis,message", [
    ("", 2, "DEVICE_DATA_AXIS=2: this host has 1 CUDA card"),
    ("cuda", 3, "DEVICE_DATA_AXIS=3: this host has 1 CUDA card"),
    ("cuda:0", 2, "DEVICE_DATA_AXIS=2: .* DEVICE_PLATFORM=cuda:0 names one"),
    ("", None, "DEVICE_SPACE_AXIS=2")])
@pytest.mark.parametrize("kind", ["batch", "pipelined"])
def test_worker_refuses_axes_by_name_before_any_backend(monkeypatch, kind,
                                                        platform, axis, message):
    """On a one-card host (torch.cuda patched so): a data axis above the
    card count, or beside one named card, and any space axis above 1."""
    from imageprocessor_tpu_torch.config import load
    from imageprocessor_tpu_torch.service import pipelined, worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def no_backend(*a, **k):
        raise AssertionError("a backend was opened")

    monkeypatch.setattr(worker, "build_metadata_store", no_backend)
    env = {"DEVICE_PLATFORM": platform}
    env.update({"DEVICE_DATA_AXIS": str(axis)} if axis else {"DEVICE_SPACE_AXIS": "2"})
    cls = worker.Worker if kind == "batch" else pipelined.PipelinedWorker
    with pytest.raises(ValueError, match=message):
        cls(load(env))


def test_launch_passes_the_card_and_counts_it_under_threads(monkeypatch):
    """kernels.launch hands the C entry its operands' card index and that
    card's stream last, raises on a nonzero return, and counts every card's
    launches without losing one when replicas launch from many threads
    (the library, the stream and the device switch stubbed: no card here)."""
    import contextlib
    import sys
    import threading
    import types

    from imageprocessor_tpu_torch import kernels

    seen = []

    def entry(*args):
        seen.append(args[-2:])
        return 0 if args[0] != "fail" else 700

    monkeypatch.setattr(kernels, "library", lambda: types.SimpleNamespace(ip_x=entry))
    monkeypatch.setattr(kernels, "stream_ptr", lambda d: 1000 + d.index)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "card_launches", {})
    kernels.launch("ip_x", torch.device("cuda", 3), "ok")
    assert seen == [(3, 1003)] and kernels.card_launches == {3: 1}
    with pytest.raises(kernels.KernelError, match="cudaError 700"):
        kernels.launch("ip_x", torch.device("cuda", 1), "fail")
    assert kernels.card_launches == {3: 1}

    monkeypatch.setattr(kernels, "card_launches", {})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [
            kernels.launch("ip_x", torch.device("cuda", k % 4), "ok")
            for _ in range(300)]) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.card_launches == {0: 1200, 1: 1200, 2: 1200, 3: 1200}
