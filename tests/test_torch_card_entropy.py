"""The engine's card route for baseline uploads (kernel B0 in the device
stage, runtime/engine.py ``_stage_entropy`` and ``_stage_coefs``), on the
CPU, where B0's wrapper runs its plain version: the tests switch the route
on (``engine._card_entropy``, which only a card's engine sets itself).

* a routed baseline upload renders byte-identical variants to the host
  scan's route, in every layout kernel B1 decodes, with restart markers,
  in mixed-size groups and through kernel B3's plans; the counters count
  each upload and each group's sync rounds;
* an upload B0 flags ends as the host route ends it: a cut entropy
  segment (the host scan zero-fills it), an invalid Huffman code (the
  host scanner refuses it and the pixel decode takes it), and one whose
  pixel decode fails too; each counts in ``engine_card_entropy_fallbacks``;
* progressive uploads keep the host scan and watermarked uploads on the
  splice route the transcode scan;
* every staging slab comes back; a stream's byte slab is reused once
  given back.
"""

import cv2
import numpy as np
import pytest

from imageprocessor_tpu_torch.domain import (
    OperationParams,
    OperationType,
    ProcessingTask,
)
from imageprocessor_tpu_torch.errors import DecodeError
from imageprocessor_tpu_torch.models.plan import normalize_operations
from imageprocessor_tpu_torch.runtime import engine as engine_mod
from imageprocessor_tpu_torch.runtime import hostcodec
from imageprocessor_tpu_torch.runtime.engine import (
    CardUpload,
    TorchProcessingEngine,
)
from imageprocessor_tpu_torch.utils.metrics import METRICS
from jpeg_streams import bad_code, cut

P, T = OperationParams, OperationType
DEFAULT = [P(T.THUMBNAIL, {"size": 64, "crop_to_fit": True}),
           P(T.RESIZE, {"width": 128, "height": 96, "keep_aspect": True})]
GRAY = DEFAULT + [P(T.GRAYSCALE, {})]
MARK = P(T.WATERMARK, {"text": "© ImageProcessor", "opacity": 0.5,
                       "position": "bottom-right"})
SAMPLING = {"coef:22": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "coef:12": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "coef:21": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "coef:11": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}


def jpeg(h, w, seed, layout="coef:22", restart=0, progressive=False):
    rng = np.random.default_rng(seed)
    img = np.clip(np.linspace(0, 200, h)[:, None, None]
                  + np.linspace(0, 50, w)[None, :, None]
                  + rng.integers(0, 41, (h, w, 3)), 0, 255).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        SAMPLING[layout], cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
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


def counters():
    return METRICS.snapshot()["counters"]


def serve(blobs, ops, card, fmt="jpeg"):
    """process_tasks over ``blobs`` with the card route on or off ->
    (what each result says, the stored renditions, the counters)."""
    store = Store()
    eng = TorchProcessingEngine(store, device="cpu", device_jpeg=True)
    eng._card_entropy = card
    METRICS.reset()
    try:
        res = eng.process_tasks([(task(k, ops, fmt), b)
                                 for k, b in enumerate(blobs)])
        assert eng._slabs.slabs()[1] == 0
    finally:
        eng.close()
    said = [(r.result.status, r.result.error, r.error_kind,
             sorted(r.result.processed_paths.items())) for r in res]
    return said, store.blobs, counters()


def assert_same_as_host_route(blobs, ops, fmt="jpeg"):
    said, stored, c = serve(blobs, ops, True, fmt)
    want_said, want_stored, _ = serve(blobs, ops, False, fmt)
    assert said == want_said
    assert stored.keys() == want_stored.keys()
    for k in stored:
        assert stored[k] == want_stored[k], k
    return c


@pytest.mark.parametrize("ops", [DEFAULT, GRAY], ids=["default", "b3"])
@pytest.mark.parametrize("layout", list(SAMPLING))
def test_routed_uploads_render_as_the_host_route(layout, ops):
    blobs = [jpeg(300, 400, 1, layout), jpeg(290, 390, 2, layout, restart=3),
             jpeg(257, 385, 3, layout)]
    c = assert_same_as_host_route(blobs, ops)
    assert c["engine_card_entropy_uploads"] == 3
    assert c["engine_card_entropy_fallbacks"] == 0
    assert c["engine_entropy_sync_rounds"] >= 1


def test_groups_of_several_buckets_and_layouts():
    blobs = [jpeg(100, 140, 4), jpeg(300, 400, 5, "coef:11"),
             jpeg(96, 128, 6, restart=1), jpeg(290, 390, 7, "coef:11")]
    c = assert_same_as_host_route(blobs, DEFAULT, fmt="png")
    assert c["engine_card_entropy_uploads"] == 4


@pytest.mark.parametrize("corrupt", [cut, bad_code], ids=["cut", "bad_code"])
def test_a_flagged_upload_ends_as_the_host_route_ends_it(corrupt):
    blobs = [jpeg(300, 400, 8), corrupt(jpeg(290, 390, 9)), jpeg(257, 385, 10)]
    if corrupt is bad_code:   # the host route then decodes pixels
        with pytest.raises(hostcodec.HostCodecError):
            hostcodec.scan_jpeg_coefficients(blobs[1])
    c = assert_same_as_host_route(blobs, DEFAULT)
    assert c["engine_card_entropy_fallbacks"] == 1
    assert c["engine_card_entropy_uploads"] == 2


def test_an_upload_no_decoder_takes_fails_as_on_the_host_route(monkeypatch):
    bad = bad_code(jpeg(290, 390, 11))
    real = engine_mod.decode_image

    def decode_image(data):
        if data == bad:
            raise DecodeError("not a picture")
        return real(data)

    monkeypatch.setattr(engine_mod, "decode_image", decode_image)
    blobs = [jpeg(300, 400, 12), bad]
    c = assert_same_as_host_route(blobs, DEFAULT)
    assert c["engine_card_entropy_fallbacks"] == 1
    said, _, _ = serve(blobs, DEFAULT, True)
    assert said[1][1] == "Failed to decode image: not a picture"


def test_progressive_and_spliced_uploads_keep_the_host_scans(monkeypatch):
    monkeypatch.setenv("IMAGEPROCESSOR_JPEG_SPLICE", "1")
    eng = TorchProcessingEngine(Store(), device="cpu", device_jpeg=True)
    eng._card_entropy = True
    try:
        prog = eng.decode_for_plan_ex(jpeg(64, 96, 13, progressive=True),
                                      normalize_operations(DEFAULT))
        assert prog[2] == "coef:22" and not isinstance(prog[0], CardUpload)
        marked = eng.decode_for_plan_ex(jpeg(64, 96, 14),
                                        normalize_operations(DEFAULT + [MARK]))
        assert marked[4] is not None and not isinstance(marked[0], CardUpload)
        routed = eng.decode_for_plan_ex(jpeg(64, 96, 15),
                                        normalize_operations(DEFAULT))
        assert isinstance(routed[0], CardUpload) and routed[2] == "coef:22"
        assert routed[3] == (64, 96)
        assert eng._slabs.owns(routed[0].stream.data)
        planes = hostcodec.scan_jpeg_coefficients(jpeg(64, 96, 15))[0]
        assert all(np.array_equal(a, b) for a, b in
                   zip(routed[0].host_scan()[:3], planes))
    finally:
        eng.close()


def test_the_route_is_a_cards_alone():
    eng = TorchProcessingEngine(Store(), device="cpu", device_jpeg=True)
    try:
        assert not eng._card_entropy
        out = eng.decode_for_plan_ex(jpeg(64, 96, 16), normalize_operations(DEFAULT))
        assert isinstance(out[0], tuple)
    finally:
        eng.close()


def test_a_stream_slab_goes_back_and_is_reused():
    from imageprocessor_tpu_torch.runtime.staging import SlabPool

    pool = SlabPool(2, pinned=False)
    a = pool.take_bytes(1000)
    assert a.dtype == np.uint8 and a.size == 1000 and pool.owns(a)
    planes = pool.take([(8, 16)])
    assert pool.take_bytes(10) is None   # both slabs are out
    pool.give(a)
    b = pool.take_bytes(900)
    assert b.ctypes.data == a.ctypes.data   # the freed slab, reused
    pool.give(b)
    pool.give(planes[0])
    assert pool.slabs() == (2, 0)
