"""The processing engine on PyTorch/CUDA — counterpart of the device half of
imageprocessor_tpu/runtime/engine.py, with the same surface
(``process_tasks``, ``decode_for_plan_ex``, ``device_group``,
``finish_item``, ``close``) that service/worker.py and
service/pipelined.py call. It takes and returns the port's copies of the
domain types (imageprocessor_tpu_torch.domain): the port's own workers
(service/worker.py, service/pipelined.py) call it directly, a reference
worker drives it through the tasks' and results' JSON, their wire format.

The path of one task:

1. host: a complete JPEG with 3 components in a supported sampling
   (4:2:0, 4:2:2, 4:4:0, 4:4:4) becomes coefficient planes: on a card a
   baseline stream's entropy-coded bytes are staged for kernel B0
   (ops/jpeg_entropy.py), which decodes them on the card in the device
   stage; any other such stream (progressive, or on the CPU) is
   entropy-scanned on the host into int16 planes (runtime/hostcodec.py).
   Anything else is decoded to HWC pixels by runtime/codecs.decode_image.
   A plan with a watermark whose rendition is a JPEG scans a JPEG for the
   splice instead (runtime/splice.py, when IMAGEPROCESSOR_JPEG_SPLICE is
   not 0). A plan made only of watermarks and of the transforms the
   coefficient domain
   expresses (crop, flip, rotation by a multiple of 90 degrees:
   runtime/coeftx.py), all with JPEG renditions, then needs no pixels at
   all (layout "splice");
   With IMAGEPROCESSOR_DEVICE_JPEG=0 (or device_jpeg=False) every JPEG
   that needs pixels is decoded on the host instead, as the reference's
   switch does;
2. items are grouped by (bucket, plan, layout) and padded to a power-of-
   two batch (runtime/batcher, a copy of the reference's);
3. device, on the engine's next free replica (one card and its stream,
   parallel/mesh.py; with several, process_tasks runs its groups side
   by side from a thread each): kernel B0 entropy-decodes the staged
   streams into the group's coefficient canvases, kernel B1 decodes the
   canvases into the planar bucket (HWC groups are uploaded and permuted
   instead); the plan's
   resamples run through kernel B2 (the first thumbnail + resize pair)
   and kernel B4 (every other one); crop, flip, rotate and grayscale are
   the tensor ops of ops/extra.py; a watermark the splice does not serve
   is blended into the bucket in place. Each output with per-image valid
   dims (resample, crop, rotate) is cropped on the device to the group's
   largest valid extent (rounded up to /64) before it is copied to the
   host; a full-bucket output (watermark, flip, grayscale) whose
   renditions are all JPEGs goes through kernel B3 (the encode front
   half) at the group's largest valid extent rounded up to /16, and its
   int16 coefficient canvases are copied instead (not with the device
   JPEG switch off);
4. host: a spliced watermark is emitted by region transcode, a
   coefficient-domain transform by permuting the scanned blocks and
   re-symbolizing them, B3's coefficients by the entropy emitter
   (runtime/hostcodec.py), every other output is encoded by
   runtime/codecs.encode_image; all are saved under the reference's
   deterministic paths.

All seven operation types of the domain are served; normalize_operations
is the single gate. ``process_single`` is the reference-sequential path:
one decoded image through each op in turn (the resamples as one-image
launches of kernel B4), the baseline of the batched path and the
fallback of the coefficient routes. Failures are classified like the
reference: PERMANENT (bad input; acked) or TRANSIENT (storage, OS,
device; nacked for redelivery).

A coefficient group is staged without a host bucket canvas: each upload's
stream (or, where the host scans, its planes) sits in a reused slab
(runtime/staging.py; page-locked on a card) and is copied from there
straight into the group's stream buffer (or its slots of the group's
canvases), zeroed on the card. An upload B0 flags is scanned on the host
into its slot, as the host route would have scanned it; one the host
scanner refuses too is decoded to pixels and takes its row of the bucket,
as an HWC group would have given it. An HWC group is packed into a host
canvas (runtime/batcher.py ``Group.pack``) and copied.

The stages are spans (utils/tracing.py): ``decode`` and ``encode`` per
upload, ``save`` per stored rendition inside ``encode``; ``device`` per
group, with ``pack`` (the group's layout: its canvases and tables),
``h2d`` (one per host-to-device copy; for a staged group one for all its
copies, ended once the card has them), ``entropy`` (B0's launches and
the read of its status), ``launch`` and one ``d2h`` per device-to-host
copy (which first waits for the kernels) inside it.
``engine_h2d_bytes`` and ``engine_d2h_bytes`` count the bytes copied,
``engine_h2d_pinned_bytes`` those copied from the slabs,
``engine_pack_images`` the images laid out and
``engine_stage_pool_misses`` the coefficient uploads staged outside the
slabs because every slab was out. ``engine_card_entropy_uploads`` counts
the uploads B0 decoded, ``engine_card_entropy_fallbacks`` those it
flagged and ``engine_entropy_sync_rounds`` its sync rounds, summed over
groups.
"""

from __future__ import annotations

import logging
import os
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from imageprocessor_tpu_torch.device import resolve_device
from imageprocessor_tpu_torch.domain import (
    DEFAULT_JPEG_QUALITY,
    ImageStatus,
    OperationType,
    ProcessingResult,
    ProcessingTask,
)
from imageprocessor_tpu_torch.errors import (
    DecodeError,
    StorageError,
    UnsupportedOperationError,
)
from imageprocessor_tpu_torch.kernels import KernelError
from imageprocessor_tpu_torch.models.pipeline import plan_output_specs, step_chw
from imageprocessor_tpu_torch.models.plan import (
    InvalidParamsError,
    NormalizedOp,
    OperationPlan,
    normalize_operations,
)
from imageprocessor_tpu_torch.ops import jpeg_entropy
from imageprocessor_tpu_torch.ops.coords import keep_aspect_dims, thumbnail_dims
from imageprocessor_tpu_torch.ops.extra import (
    crop_image,
    flip_image,
    grayscale_image,
    rotate_image,
)
from imageprocessor_tpu_torch.ops.jpeg_encode import quality_qtables
from imageprocessor_tpu_torch.ops.jpeg_kernels import decode_coefs, encode_420
from imageprocessor_tpu_torch.ops.resize import resize_image
from imageprocessor_tpu_torch.ops.thumbnail import thumbnail_image
from imageprocessor_tpu_torch.ops.watermark import watermark_image
from imageprocessor_tpu_torch.parallel.mesh import replica_devices
from imageprocessor_tpu_torch.runtime import coeftx, hostcodec, splice
from imageprocessor_tpu_torch.runtime.batcher import (
    MAX_BATCH,
    BatchItem,
    bucket_for,
    coef_canvas,
    coef_factors,
    coef_layout,
    group_items,
    quantize_batch,
)
from imageprocessor_tpu_torch.runtime.codecs import (
    decode_image,
    detect_content_type,
    encode_image,
    jpeg_stream_complete,
    mime_from_path,
    negotiate_format,
)
from imageprocessor_tpu_torch.runtime.paths import generate_path
from imageprocessor_tpu_torch.runtime.staging import SlabPool
from imageprocessor_tpu_torch.utils.metrics import METRICS
from imageprocessor_tpu_torch.utils.tracing import span

log = logging.getLogger("imageprocessor_tpu_torch.engine")

PERMANENT = "permanent"
TRANSIENT = "transient"

# ops whose device output is the whole bucket canvas, valid over each image's
# own (h, w): kernel B3 encodes them when every item wants a JPEG
FULL_BUCKET_OPS = (OperationType.WATERMARK, OperationType.FLIP,
                   OperationType.GRAYSCALE)

# The auto policy of IMAGEPROCESSOR_DEVICE_JPEG, as the reference's: the
# device codec serves a host with fewer usable cores than this
# (IMAGEPROCESSOR_DEVICE_JPEG_CORES, read at engine construction; the
# reference's default, its TPU crossover)
DEVICE_JPEG_CORE_THRESHOLD = 127


def usable_cores() -> int:
    """Cores this PROCESS may use: cgroup/affinity-aware (a container
    pinned to 4 of 64 cores must count 4 — it is exactly the
    core-starved host the device-JPEG offload targets)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):  # non-Linux
        return os.cpu_count() or 1


def _h2d(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of ``a``, in an ``h2d`` span; its bytes
    count in ``engine_h2d_bytes``."""
    with span("h2d", bytes=a.nbytes):
        t = torch.from_numpy(a).to(device)
    METRICS.inc("engine_h2d_bytes", a.nbytes)
    return t


def _b1_mode(shapes, size, sampling) -> tuple[int, int] | None:
    """(fh, fw) of scanned planes kernel B1 decodes (three components, the
    chroma 1x1 and the luma at most 2x2, the planes inside their bucket's
    canvas); None for planes that take the pixel decode."""
    if len(shapes) != 3:
        return None
    (hy, vy), (hc, vc), (hr, vr) = (tuple(s) for s in sampling)
    fh, fw = vy, hy
    if not ((hc, vc) == (hr, vr) == (1, 1) and fh in (1, 2) and fw in (1, 2)):
        return None
    (yh, yw), c1, c2 = (tuple(s) for s in shapes)
    w, h = size
    ch, cw = coef_canvas(bucket_for(h, w), fh, fw)
    if (yh <= ch and yw <= cw and c1 == c2
            and c1[0] * fh == yh and c1[1] * fw == yw):
        return fh, fw
    return None


def _d2h(copy) -> np.ndarray:
    """``copy()``, a device-to-host copy (which first waits for the work
    queued before it), in a ``d2h`` span; its bytes count in
    ``engine_d2h_bytes``."""
    with span("d2h") as attrs:
        out = copy()
        attrs["bytes"] = out.nbytes
    METRICS.inc("engine_d2h_bytes", out.nbytes)
    return out


@dataclass
class CardUpload:
    """A coefficient upload whose entropy decode kernel B0 runs: its staged
    stream and its bytes. If B0 flags it, the device stage records what the
    host route makes of it instead: pixels (the host scanner refused the
    stream too) or the pixel decode's error."""

    stream: jpeg_entropy.Stream
    data: bytes
    pixels: np.ndarray | None = None
    error: Exception | None = None

    def host_scan(self):
        """(y, cb, cr, qtabs): what the host route scans from the bytes."""
        planes, qt, _size, _sampling = hostcodec.scan_jpeg_coefficients(self.data)
        return (*planes, qt)


def _slab_of(image):
    """The array whose slab a coefficient item's operand holds."""
    return image.stream.data if isinstance(image, CardUpload) else image[0]


@dataclass
class Artifact:
    operation: str
    path: str
    size: int
    mime_type: str
    format: str


@dataclass
class EngineResult:
    """ProcessingResult plus the artifact metadata the DB rows need.
    error_kind: "" on success, else PERMANENT or TRANSIENT."""

    result: ProcessingResult
    artifacts: list[Artifact] = field(default_factory=list)
    error_kind: str = ""


class TorchProcessingEngine:
    def __init__(self, object_store, *, device: str | torch.device = "cuda",
                 codec_threads: int = 3, batch_size: int = 32,
                 jpeg_quality: int = DEFAULT_JPEG_QUALITY,
                 device_jpeg: bool | None = None,
                 data_axis: int | None = None,
                 devices: list[torch.device] | None = None):
        self.store = object_store
        # Data-parallel serving: one engine drives every replica, each
        # group whole on the next free one. ``devices`` names them
        # outright, one device per replica: two replicas may share a card,
        # each with its stream
        if devices is not None:
            if not devices or any(not isinstance(d, (str, torch.device))
                                  for d in devices):
                raise ValueError("devices must name at least one replica, "
                                 f"one device each, got {devices!r}")
            self.devices = [resolve_device(d) for d in devices]
        else:
            self.devices = replica_devices(device, data_axis)
        self.device = self.devices[0]
        # groups each replica ran (how evenly the groups spread)
        self.replica_groups = [0] * len(self.devices)
        # several replicas: a stream each on a card, the free ones in a
        # queue, and a thread each for process_tasks' groups; one replica
        # runs in the caller's thread on its current stream
        self._free = self._replicas = None
        self._streams: list = [None]
        if len(self.devices) > 1:
            self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                             else None for d in self.devices]
            self._free = queue.SimpleQueue()
            for k in range(len(self.devices)):
                self._free.put(k)
            self._replicas = ThreadPoolExecutor(max_workers=len(self.devices),
                                                thread_name_prefix="replica")
        # group_items must never emit a group larger than quantize_batch's
        # cap, or Group.pack would index past its canvas
        self.batch_size = max(1, min(batch_size, MAX_BATCH))
        # staging slabs for the coefficient scans: one group being scanned
        # and one in the device stage
        self._slabs = SlabPool(2 * self.batch_size, pinned=any(
            d.type == "cuda" for d in self.devices))
        self.jpeg_quality = jpeg_quality
        # IMAGEPROCESSOR_DEVICE_JPEG, read once as the reference reads it:
        # 0 keeps JPEG decode and encode on the host, 1 puts them on the
        # device. Its auto policy (unset or any other value) is the
        # reference's: the device codec serves a host with fewer usable
        # cores than IMAGEPROCESSOR_DEVICE_JPEG_CORES (default 127)
        if device_jpeg is None:
            env_flag = os.environ.get("IMAGEPROCESSOR_DEVICE_JPEG", "")
            if env_flag in ("1", "true", "yes"):
                device_jpeg = True
            elif env_flag in ("0", "false", "no"):
                device_jpeg = False
            else:
                device_jpeg = usable_cores() < int(os.environ.get(
                    "IMAGEPROCESSOR_DEVICE_JPEG_CORES",
                    str(DEVICE_JPEG_CORE_THRESHOLD)))
        self.device_jpeg = device_jpeg
        # kernel B0 entropy-decodes the baseline streams of a card's
        # coefficient groups; elsewhere the host scans them
        self._card_entropy = device_jpeg and all(
            d.type == "cuda" for d in self.devices)
        hostcodec.library()   # build the scan library up front
        self._pool = ThreadPoolExecutor(max_workers=max(codec_threads, 1),
                                        thread_name_prefix="codec")

    # ------------------------------------------------------------------ utils

    def _failed(self, task: ProcessingTask, error: str,
                kind: str = PERMANENT) -> EngineResult:
        return EngineResult(result=ProcessingResult(
            id=task.id, image_id=task.image_id, status=ImageStatus.FAILED,
            error=error), error_kind=kind)

    @staticmethod
    def _is_infra_failure(exc: Exception) -> bool:
        """Storage, OS and device errors are transient (redeliver);
        compute/encode/params errors are permanent."""
        if isinstance(exc, (StorageError, OSError, TimeoutError, KernelError)):
            return True
        mod = type(exc).__module__ or ""
        return isinstance(exc, RuntimeError) and mod.startswith("torch")

    def _save(self, path: str, data: bytes, mime: str) -> None:
        with span("save", bytes=len(data)):
            try:
                self.store.save_processed(path, data, mime)
            except Exception as exc:
                raise StorageError(f"save {path}: {exc}") from exc

    def _encode_and_save(self, task: ProcessingTask, op: NormalizedOp,
                         arr: np.ndarray, fmt: str) -> Artifact:
        """arr: one valid u8 output, (h, w, 3)."""
        out_fmt = negotiate_format(fmt,
                                   watermark=op.type is OperationType.WATERMARK)
        data = encode_image(np.ascontiguousarray(arr), out_fmt,
                            quality=self.jpeg_quality)
        return self._save_artifact(task, op, data, out_fmt)

    def _save_artifact(self, task: ProcessingTask, op: NormalizedOp,
                       data: bytes, out_fmt: str) -> Artifact:
        path = generate_path(task.image_id, op, out_fmt)
        mime = mime_from_path(path)
        self._save(path, data, mime)
        return Artifact(operation=op.type.value, path=path, size=len(data),
                        mime_type=mime, format=out_fmt)

    def _emit_and_save(self, task: ProcessingTask, op: NormalizedOp,
                       coef, i: int, h: int, w: int) -> Artifact:
        """Save one device-encoded output: slice the image's MCU grid out
        of the group's coefficient canvases (strided views, no copy) and
        run the host entropy emitter."""
        _tag, yc, cbc, crc, qt = coef
        gh, gw = -(-h // 16) * 16, -(-w // 16) * 16
        data = hostcodec.emit_jpeg_from_coefficients(
            [yc[i, :gh, :gw], cbc[i, :gh // 2, :gw // 2],
             crc[i, :gh // 2, :gw // 2]], qt, w, h, (2, 2))
        return self._save_artifact(task, op, data, "jpeg")

    def _splice_and_save(self, task: ProcessingTask, op: NormalizedOp,
                         ctx) -> Artifact:
        """Watermark rendition by JPEG splice transcode: edit only the MCU
        band the text touches and copy every other MCU's bits verbatim
        (runtime/splice.py). Fallback, as the reference: decode the
        scanned coefficients on the host, blend if the band edit never
        landed, and re-encode at the engine quality."""
        t0 = time.monotonic()
        try:
            data = splice.watermark_splice(ctx, op)
        except hostcodec.HostCodecError:
            # watermark_splice restores the context in a finally, so
            # decode_rgb sees pristine source coefficients here
            arr = splice.decode_rgb(ctx)
            if not ctx.edited:
                arr = watermark_image(arr, op)
            return self._encode_and_save(task, op, arr, "jpeg")
        METRICS.observe("engine_splice_emit_ms",
                        (time.monotonic() - t0) * 1000.0)
        METRICS.inc("engine_splice_images", 1)
        return self._save_artifact(task, op, data, "jpeg")

    def _coef_tx_and_save(self, task: ProcessingTask, op: NormalizedOp,
                          ctx) -> Artifact:
        """Crop, rotate or flip rendition by a lossless coefficient-domain
        transform (runtime/coeftx.py, jpegtran-style): permute the
        quantized blocks and re-symbolize them with the source's own
        tables — no pixel decode, no generation loss. Fallback, as
        _splice_and_save: decode the scanned coefficients on the host,
        run the single-image op, re-encode at the engine quality."""
        t0 = time.monotonic()
        try:
            prims = coeftx.eligible_prims(op, ctx.size, ctx.sampling)
            if prims is None or not splice.coef_reencodable(ctx):
                raise hostcodec.HostCodecError(
                    "transform not expressible in the coefficient domain")
            data = splice.reencode(coeftx.apply(ctx, prims))
        except hostcodec.HostCodecError:
            arr = self._apply_single(splice.decode_rgb(ctx), op)
            return self._encode_and_save(task, op, arr, "jpeg")
        METRICS.observe("engine_coeftx_emit_ms",
                        (time.monotonic() - t0) * 1000.0)
        METRICS.inc("engine_coeftx_images", 1)
        return self._save_artifact(task, op, data, "jpeg")

    # ------------------------------------------------------ single-image path

    def _apply_single(self, arr: np.ndarray, op: NormalizedOp) -> np.ndarray:
        """One op on one (h, w, 3) u8 image, on the engine's device."""
        t = op.type
        if t is OperationType.WATERMARK:   # host blend, as the splice fallback
            return watermark_image(arr, op)
        img = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if t is OperationType.RESIZE:
            out = resize_image(img, op.width, op.height, op.keep_aspect)
        elif t is OperationType.THUMBNAIL:
            out = thumbnail_image(img, op.size, op.crop_to_fit)
        elif t is OperationType.CROP:
            out = crop_image(img, op.x, op.y, op.width, op.height)
        elif t is OperationType.ROTATE:
            out = rotate_image(img, op.angle)
        elif t is OperationType.FLIP:
            out = flip_image(img, op.direction)
        elif t is OperationType.GRAYSCALE:
            out = grayscale_image(img)
        else:
            raise UnsupportedOperationError(f"unsupported operation type: {t}")
        return out.cpu().numpy()

    def process_single(self, task: ProcessingTask, data: bytes) -> EngineResult:
        """Reference-sequential path: decode once, then each op on the
        decoded image and its encode, fail-fast. The baseline of the
        batched path."""
        try:
            arr, detected_fmt = decode_image(data)
        except DecodeError as exc:
            return self._failed(task, f"Failed to decode image: {exc}")
        fmt = (task.format or detected_fmt or "jpeg").lower()
        try:
            plan = normalize_operations(task.operations)
        except (InvalidParamsError, UnsupportedOperationError, ValueError) as exc:
            return self._failed(task, f"Operation failed: {exc}")
        return self._process_decoded_single(task, arr, fmt, plan)

    def _process_decoded_single(self, task, arr, fmt, plan) -> EngineResult:
        out = EngineResult(result=ProcessingResult(
            id=task.id, image_id=task.image_id, status=ImageStatus.COMPLETED))
        for op in plan:
            try:
                artifact = self._encode_and_save(
                    task, op, self._apply_single(arr, op), fmt)
            except Exception as exc:
                self._classify_op_failure(out, op, exc)
                return out
            out.artifacts.append(artifact)
            out.result.processed_paths[op.type.value] = artifact.path
        return out

    @classmethod
    def _classify_op_failure(cls, out: EngineResult, op: NormalizedOp,
                             exc: Exception) -> None:
        """Fail-fast bookkeeping for one op failure: infra errors are
        TRANSIENT, everything else (compute, encode, params) PERMANENT."""
        out.result.status = ImageStatus.FAILED
        out.result.error = f"Operation {op.type.value} failed: {exc}"
        out.error_kind = TRANSIENT if cls._is_infra_failure(exc) else PERMANENT

    # ---------------------------------------------------------------- decode

    def decode_for_plan_ex(self, data: bytes, plan: OperationPlan | None,
                           task_format: str | None = None,
                           image_id: str | None = None):
        """``_decode_for_plan`` in a ``decode`` span: the upload's
        ``image_id`` where the caller passes it, and the layout."""
        with span("decode", image_id=image_id) as attrs:
            out = self._decode_for_plan(data, plan, task_format)
            attrs["layout"] = out[2]
        return out

    def _decode_for_plan(self, data: bytes, plan: OperationPlan | None,
                         task_format: str | None = None):
        """Decode one blob for the device path: (image, detected_format,
        layout, valid_hw, splice_ctx).

        Complete JPEGs with 3 components in a supported sampling become
        coefficient planes (layout "coef:FhFw"): on a card, where the plan
        asks no splice scan, a baseline one is staged for kernel B0 (a
        CardUpload, ``_stage_entropy``) and decoded in the device stage;
        any other is scanned on the host. Everything else decodes to
        (h, w, 3) pixels (layout "hwc"). When the plan has a watermark
        whose rendition negotiates to JPEG and the splice is enabled, the
        JPEG is scanned for the splice (runtime/splice.py) and its context
        rides along as the fifth element. A plan whose every op the
        coefficient domain serves — watermarks (the splice) and crop,
        flip and rotate (runtime/coeftx.py) — with every rendition a JPEG
        returns the "splice" placeholder (no pixels: each rendition is
        emitted from the scanned coefficients at finish time).
        task_format=None keeps the splice scan (the source is a JPEG, so
        the detected format negotiates to JPEG)."""
        jpeg_type = detect_content_type(data[:512]) == "image/jpeg"
        ops = plan.ops if plan is not None else ()
        fmt0 = task_format or "jpeg"
        has_wm = any(op.type is OperationType.WATERMARK for op in ops)
        tx_ops = [op for op in ops if op.type in coeftx.TX_TYPES]
        all_coef_types = len(ops) > 0 and all(
            op.type is OperationType.WATERMARK or op.type in coeftx.TX_TYPES
            for op in ops)
        # a rendition that can never negotiate to JPEG (format=png) would
        # discard the context at finish time
        fmt_ok_all = all(
            negotiate_format(fmt0, watermark=op.type is OperationType.WATERMARK)
            == "jpeg" for op in ops)
        coef_only = all_coef_types and fmt_ok_all
        splice_plan = splice.enabled() and (
            (has_wm and negotiate_format(fmt0, watermark=True) == "jpeg")
            or coef_only)
        if jpeg_type and self._card_entropy and not splice_plan:
            # the card's route, before the host's completeness test: the
            # staging tests it (an EOI after the scan) in the library
            staged = self._stage_entropy(data)
            if staged is not None:
                card, layout = staged
                w, h = card.stream.size
                return card, "jpeg", layout, (h, w), None
        is_jpeg = jpeg_type and jpeg_stream_complete(data)
        wants_splice = is_jpeg and splice_plan

        def coef_scan():
            """The plain coefficient scan and its context for the
            coefficient routes (a grayscale source promoted to colour),
            None where the stream cannot be re-symbolized."""
            scanned = hostcodec.scan_jpeg_coefficients(data)
            make = (splice.promote_grayscale if len(scanned[0]) == 1
                    else splice.coef_context)
            c = make(*scanned)
            return scanned, (c if splice.coef_reencodable(c) else None)

        # one scan, shared by the splice context and the coefficient decode
        sctx = None
        scanned = None   # (planes, qtabs, (w, h), sampling)
        if wants_splice and has_wm:
            try:
                c = hostcodec.scan_jpeg_for_transcode(data)
                scanned = (c.planes, c.qtabs, c.size, c.sampling)
                if splice.supports(c):
                    sctx = c
                elif len(c.planes) == 1:
                    # grayscale: Y kept bit-exact, neutral chroma synthesized
                    sctx = splice.promote_grayscale(
                        c.planes, c.qtabs, c.size, c.sampling)
            except hostcodec.HostCodecError:
                # The transcode scan refuses progressive AND truncated or
                # exotic streams; only a progressive header takes the
                # coefficient-domain path (band edit + baseline
                # re-symbolization), the rest fall to the pixel decoders.
                try:
                    if hostcodec.is_progressive(data):
                        scanned, sctx = coef_scan()
                except hostcodec.HostCodecError:
                    pass   # unparseable/truncated: pixel decode below
        elif wants_splice:
            # a transform-only plan re-symbolizes every MCU, so the
            # transcode scan's bit offsets buy nothing: take the plain
            # coefficient scan (it also covers progressive sources)
            try:
                scanned, sctx = coef_scan()
            except hostcodec.HostCodecError:
                pass   # exotic stream: pixel decode below
        # A group of "splice" items never packs: it is either all-splice
        # (device_group returns before the pack) or all-pixels.
        if coef_only and sctx is not None:
            tx_ok = all(coeftx.eligible_prims(op, sctx.size, sctx.sampling)
                        is not None for op in tx_ops)
            if tx_ok and (not tx_ops or splice.coef_reencodable(sctx)):
                w, h = sctx.size
                return (np.empty((0, 0, 3), dtype=np.uint8), "jpeg", "splice",
                        (h, w), sctx)
        if is_jpeg and self.device_jpeg:
            try:
                if scanned is None:
                    scanned = self._scan_staged(data)
            except hostcodec.HostCodecError:
                scanned = None   # exotic stream: pixel decode below
            mode = scanned and _b1_mode([p.shape for p in scanned[0]],
                                        *scanned[2:])
            if mode:
                planes, qt, (w, h), _samp = scanned
                return ((planes[0], planes[1], planes[2],
                         np.asarray(qt, dtype=np.float32)), "jpeg",
                        coef_layout(*mode), (h, w), sctx)
        arr, detected = decode_image(data)
        return arr, detected, "hwc", None, sctx

    def _stage_entropy(self, data: bytes):
        """(CardUpload, layout) for a stream kernel B0 decodes into a
        layout kernel B1 takes: its entropy-coded bytes destuffed into a
        slab of the staging pool (outside it, counted in
        ``engine_stage_pool_misses``, when every slab is out). None for any
        other stream: the host scan takes it, as it would without B0."""
        try:
            shapes, size, sampling = hostcodec.scan_jpeg_layout(data)
        except hostcodec.HostCodecError:
            return None
        mode = _b1_mode(shapes, size, sampling)
        if not mode:
            return None
        out = self._slabs.take_bytes(len(data) + 32)
        if out is None:
            METRICS.inc("engine_stage_pool_misses", 1)
        try:
            stream = jpeg_entropy.stage(data, out,
                                        layout=(shapes, size, sampling))
        except hostcodec.HostCodecError:
            if out is not None:
                self._slabs.give(out)
            return None
        return CardUpload(stream=stream, data=data), coef_layout(*mode)

    def _scan_staged(self, data: bytes):
        """``hostcodec.scan_jpeg_coefficients``, the planes of a stream
        kernel B1 decodes scanned into a slab of the staging pool (outside
        it, counted in ``engine_stage_pool_misses``, when every slab is
        out)."""
        shapes, size, sampling = hostcodec.scan_jpeg_layout(data)
        planes = None
        if _b1_mode(shapes, size, sampling):
            planes = self._slabs.take(shapes)
            if planes is None:
                METRICS.inc("engine_stage_pool_misses", 1)
        if planes is None:
            planes = [np.zeros(s, dtype=np.int16) for s in shapes]
        try:
            qt = hostcodec.scan_jpeg_coefficients_into(data, planes)
        except hostcodec.HostCodecError:
            self._slabs.give(planes[0])
            raise
        return planes, qt, size, sampling

    # ----------------------------------------------------------- batched path

    def process_tasks(self, tasks_with_data: list[tuple[ProcessingTask, bytes]],
                      device_section=None) -> list[EngineResult]:
        """Decode pool -> bucket groups -> device -> encode pool. Returns
        results in input order. device_section: optional context-manager
        factory (e.g. Watchdog.armed) wrapped around each group's device
        stage."""
        n = len(tasks_with_data)
        results: list[EngineResult | None] = [None] * n
        plans: dict[int, OperationPlan] = {}
        for i, (task, _data) in enumerate(tasks_with_data):
            try:
                plans[i] = normalize_operations(task.operations)
            except (InvalidParamsError, UnsupportedOperationError,
                    ValueError) as exc:
                results[i] = self._failed(task, f"Operation failed: {exc}")

        def _dec(i):
            task, data = tasks_with_data[i]
            fmt = task.format
            try:
                return self.decode_for_plan_ex(
                    data, plans[i],
                    task_format=fmt if isinstance(fmt, str) else None,
                    image_id=task.image_id)
            except Exception as exc:  # noqa: BLE001 — isolated per image
                return exc

        pending = [i for i in range(n) if results[i] is None]
        t_dec = time.monotonic()
        decoded = list(self._pool.map(_dec, pending))
        METRICS.observe("engine_decode_ms", (time.monotonic() - t_dec) * 1000.0)
        METRICS.inc("engine_decoded_images", len(pending))

        items: list[BatchItem] = []
        for i, dec in zip(pending, decoded):
            task = tasks_with_data[i][0]
            if isinstance(dec, Exception):
                results[i] = self._failed(task, f"Failed to decode image: {dec}")
                continue
            arr, detected, layout, valid_hw, sctx = dec
            try:
                fmt = (task.format or detected or "jpeg").lower()
                items.append(BatchItem(item_id=str(i), image=arr,
                                       plan_key=plans[i].group_key(),
                                       payload=(i, task, fmt, plans[i]),
                                       layout=layout, valid_hw=valid_hw,
                                       splice=sctx))
            except Exception as exc:  # e.g. a non-string Format
                results[i] = self._failed(task, f"Operation failed: {exc}")

        def _group(group):
            try:
                self._run_group(group, results, device_section)
            except Exception as exc:
                kind = TRANSIENT if self._is_infra_failure(exc) else PERMANENT
                log.error("device group of %d failed (%s): %s",
                          len(group.items), kind, exc, exc_info=True)
                for it in group.items:
                    i, task = it.payload[0], it.payload[1]
                    if results[i] is None:
                        results[i] = self._failed(task, f"device error: {exc}",
                                                  kind=kind)

        groups = group_items(items, max_batch=self.batch_size)
        if self._replicas is None:
            for group in groups:
                _group(group)
        else:   # the groups run side by side, each on a free replica
            list(self._replicas.map(_group, groups))
        return [r if r is not None else self._failed(
            tasks_with_data[i][0], "internal: no result produced",
            kind=TRANSIENT) for i, r in enumerate(results)]

    def _upload(self, imgs, group, device: torch.device) -> torch.Tensor:
        """A group's rows on ``device`` as a planar (B, 3, Hb, Wb) u8
        bucket: kernel B1 for the coefficient operands ``_stage_coefs``
        left there, a copy and a permute for Group.pack's HWC canvas."""
        if group.layout.startswith("coef"):
            fh, fw = coef_factors(group.layout)
            yc, cbc, crc, qt, cv = imgs
            with span("launch"):
                return decode_coefs(yc, cbc, crc, qt, cv, fh, fw, group.bucket)
        x = _h2d(imgs, device)
        with span("launch"):
            return x.permute(0, 3, 1, 2).contiguous()

    def _stage_coefs(self, group, b: int, device: torch.device):
        """A coefficient group's operands of kernel B1 on ``device`` with no
        host canvas: the (b, ch, cw) and two (b, ch/fh, cw/fw) int16
        canvases zeroed on the card; each host-scanned upload's three
        planes copied into its slot [i, :ph, :pw] without blocking (from
        its slab, or from wherever it was scanned); each CardUpload's
        stream copied into the group's stream buffer the same way and
        decoded into its slot by kernel B0; the tables (pad rows' qt[:, :,
        0, 0] = 1) and the chroma extents as Group.pack builds them. B1
        reads what it reads after Group.pack and ``_h2d``, byte for byte.
        -> ((yc, cbc, crc, qt, cv) on the device, src_hw). The ``h2d``
        span holds every copy and ends once the card has them; the
        ``entropy`` span holds B0's launches and the read of its status.
        An upload B0 flags is scanned on the host into its slot; where the
        host scanner refuses it too, the pixel decode's image or error is
        left on its CardUpload (``_device_group``, ``_finish_item``)."""
        fh, fw = coef_factors(group.layout)
        ch, cw = coef_canvas(group.bucket, fh, fw)
        n = len(group.items)
        cards = [i for i, it in enumerate(group.items)
                 if isinstance(it.image, CardUpload)]
        with span("pack", images=n):
            canvases = [torch.zeros(shape, dtype=torch.int16, device=device)
                        for shape in ((b, ch, cw), (b, ch // fh, cw // fw),
                                      (b, ch // fh, cw // fw))]
            qt = np.zeros((b, 3, 8, 8), dtype=np.float32)
            qt[:, :, 0, 0] = 1.0   # benign tables for pad rows
            cv = np.ones((b, 2), dtype=np.int32)   # chroma plane extents
            src_hw = np.zeros((b, 2), dtype=np.int32)
            for i, it in enumerate(group.items):
                if isinstance(it.image, CardUpload):
                    s = it.image.stream
                    qt[i] = s.qtabs
                    mx, my = s.geometry()[:2]
                    cv[i] = (my * 8, mx * 8)
                else:
                    qt[i] = it.image[3]
                    cv[i] = it.image[1].shape
                src_hw[i] = it.hw
            src_hw[n:] = src_hw[n - 1]
        nbytes = pinned = 0
        with span("h2d") as attrs:
            for i, it in enumerate(group.items):
                if isinstance(it.image, CardUpload):
                    continue
                planes = it.image[:3]
                for canvas, p in zip(canvases, planes):
                    canvas[i, :p.shape[0], :p.shape[1]].copy_(
                        torch.from_numpy(p), non_blocking=True)
                size = sum(p.nbytes for p in planes)
                nbytes += size
                if self._slabs.owns(planes[0]):
                    pinned += size
            ops = None
            if cards:
                streams = [group.items[i].image.stream for i in cards]
                ops = jpeg_entropy.upload(streams, cards, device)
                nbytes += ops.nbytes
                pinned += sum(s.data.nbytes for s in streams
                              if self._slabs.owns(s.data))
            tables = [torch.from_numpy(a).to(device) for a in (qt, cv)]
            nbytes += qt.nbytes + cv.nbytes
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
            attrs["bytes"] = nbytes
        METRICS.inc("engine_h2d_bytes", nbytes)
        METRICS.inc("engine_h2d_pinned_bytes", pinned)
        if ops is not None:
            with span("entropy", images=len(cards)) as attrs:
                status, rounds = jpeg_entropy.decode(ops, canvases)
                attrs["rounds"] = rounds
            del ops
            flagged = [i for i, st in zip(cards, status) if st]
            METRICS.inc("engine_card_entropy_uploads", len(cards) - len(flagged))
            METRICS.inc("engine_card_entropy_fallbacks", len(flagged))
            METRICS.inc("engine_entropy_sync_rounds", rounds)
            for i in flagged:
                self._host_fallback(group.items[i].image, i, canvases)
        return (*canvases, *tables), src_hw

    @staticmethod
    def _host_fallback(card: CardUpload, i: int, canvases) -> None:
        """An upload B0 flagged ends as the host route ends it: its slot
        zeroed and filled from the host scan; where the host scanner
        refuses the stream, the pixel decode's image (or its error) is
        kept on ``card`` for the device and finish stages."""
        for canvas in canvases:
            canvas[i].zero_()
        try:
            planes = card.host_scan()[:3]
        except hostcodec.HostCodecError:
            try:
                arr, _fmt = decode_image(card.data)
                w, h = card.stream.size
                if arr.shape[:2] != (h, w):
                    raise DecodeError(f"decoded {arr.shape[1]}x{arr.shape[0]}, "
                                      f"the frame is {w}x{h}")
                card.pixels = arr
            except Exception as exc:  # noqa: BLE001 — as the host route's decode
                card.error = exc
            return
        with span("h2d", bytes=sum(p.nbytes for p in planes)):
            for canvas, p in zip(canvases, planes):
                canvas[i, :p.shape[0], :p.shape[1]].copy_(torch.from_numpy(p))
        METRICS.inc("engine_h2d_bytes", sum(p.nbytes for p in planes))

    def device_group(self, group):
        """Stage 2: one packed group through the device. Returns (plan,
        per-op host outputs, out_hws, layout). An output is a (B, 3, h, w)
        u8 array, ("coef420", yc, cbc, crc, qt) for B3's canvases, or
        ("splice", op) for a rendition the finish stage emits from the
        scanned coefficients (a spliced watermark, a coefficient-domain
        transform). With several replicas the group runs whole on the
        next free one, on its stream; callers on several threads keep
        every replica busy. A ``device`` span covers the call, the
        wait for a replica included; inside it ``pack``, ``h2d``,
        ``launch`` and ``d2h`` spans. The group's staging slabs go back to
        the pool when it returns: the copies from them are complete."""
        try:
            with span("device", images=len(group.items), layout=group.layout,
                      hw=[tuple(int(v) for v in it.hw) for it in group.items]):
                if self._free is None:
                    self.replica_groups[0] += 1
                    return self._device_group(group, self.device)
                k = self._free.get()
                try:
                    self.replica_groups[k] += 1
                    with torch.cuda.stream(self._streams[k]):
                        return self._device_group(group, self.devices[k])
                finally:
                    self._free.put(k)
        finally:
            if group.layout.startswith("coef"):
                for it in group.items:
                    self._slabs.give(_slab_of(it.image))

    def _device_group(self, group, device: torch.device):
        plan: OperationPlan = group.items[0].payload[3]
        n_real = len(group.items)

        # Watermark renditions every item splices (runtime/splice.py) leave
        # the device plan: no blend, no encode, no copy. A group where
        # every op splices (the "splice" layout) has nothing to run.
        splice_skip: set[int] = set()
        if group.layout == "splice":
            splice_skip = set(range(len(plan.ops)))
        elif all(it.splice is not None
                 and negotiate_format(it.payload[2], watermark=True) == "jpeg"
                 for it in group.items):
            splice_skip = {oi for oi, op in enumerate(plan.ops)
                           if op.type is OperationType.WATERMARK}
        if splice_skip and len(splice_skip) == len(plan.ops):
            METRICS.inc("engine_device_images", n_real)
            return plan, [("splice", op) for op in plan.ops], {}, group.layout

        b = quantize_batch(n_real)
        # per-op, per-image valid output dims (Go-exact host arithmetic);
        # a resample's pad rows mirror the last real image, a crop's and
        # a rotate's are (1, 1)
        out_hws: dict[int, np.ndarray] = {}
        aspect_long: dict[int, int] = {}
        for oi, op in enumerate(plan.ops):
            if op.type is OperationType.RESIZE:
                hw = np.zeros((b, 2), dtype=np.int32)
                for i, it in enumerate(group.items):
                    h, w = it.hw
                    if op.keep_aspect:
                        tw, th = keep_aspect_dims(w, h, op.width, op.height)
                        hw[i] = (max(th, 1), max(tw, 1))
                    else:
                        hw[i] = (op.height, op.width)
                hw[n_real:] = hw[n_real - 1]
                out_hws[oi] = hw
            elif op.type is OperationType.THUMBNAIL and not op.crop_to_fit:
                hw = np.zeros((b, 2), dtype=np.int32)
                long_side = op.size
                for i, it in enumerate(group.items):
                    h, w = it.hw
                    tw, th = thumbnail_dims(w, h, op.size)
                    hw[i] = (th, tw)
                    long_side = max(long_side, th, tw)
                hw[n_real:] = hw[n_real - 1]
                out_hws[oi] = hw
                aspect_long[oi] = long_side
            elif op.type is OperationType.CROP:
                # the same per-image clamping as the single-image op
                hw = np.ones((b, 2), dtype=np.int32)
                for i, it in enumerate(group.items):
                    h, w = it.hw
                    cx = max(0, min(op.x, w - 1))
                    cy = max(0, min(op.y, h - 1))
                    hw[i] = (max(1, min(op.height, h - cy)),
                             max(1, min(op.width, w - cx)))
                out_hws[oi] = hw
            elif op.type is OperationType.ROTATE:
                hw = np.ones((b, 2), dtype=np.int32)
                swap = (op.angle % 180.0) == 90.0
                for i, it in enumerate(group.items):
                    h, w = it.hw
                    hw[i] = (w, h) if swap else (h, w)
                out_hws[oi] = hw
        # plan op index -> its index in the device plan (spliced ops left out)
        run = {oi: k for k, oi in enumerate(
            oi for oi in range(len(plan.ops)) if oi not in splice_skip)}
        run_plan = OperationPlan(ops=tuple(plan.ops[oi] for oi in run))
        specs = plan_output_specs(run_plan, {run[oi]: v
                                             for oi, v in aspect_long.items()
                                             if oi in run})
        if group.layout.startswith("coef"):
            imgs, src_hw = self._stage_coefs(group, b, device)
        else:
            with span("pack", images=n_real):
                imgs, src_hw = group.pack(pad_batch_to=b)
        METRICS.inc("engine_pack_images", n_real)
        x = self._upload(imgs, group, device)
        del imgs   # a staged group's canvases: free on the card before the step
        for i, it in enumerate(group.items):
            # an upload neither B0 nor the host scanner decoded: its pixels
            # take its row, as an HWC group's pack and permute would give it
            px = getattr(it.image, "pixels", None)
            if px is not None:
                h, w = it.hw
                x[i].zero_()
                x[i, :, :h, :w] = torch.from_numpy(
                    np.ascontiguousarray(px[:h, :w, :3])).to(device).permute(2, 0, 1)
        with span("launch"):
            outs = step_chw(x, src_hw, {run[oi]: v for oi, v in out_hws.items()
                                        if oi in run}, specs)

        # each output with valid dims leaves the device cropped to the
        # group's largest valid extent, rounded up to /64
        def _q64(v: int) -> int:
            return -(-v // 64) * 64

        max_h = max(it.hw[0] for it in group.items)
        max_w = max(it.hw[1] for it in group.items)
        outs_np = []
        for oi, op in enumerate(plan.ops):
            if oi in splice_skip:   # spliced on the host at finish time
                outs_np.append(("splice", op))
                continue
            o = outs[run[oi]]
            oh, ow = o.shape[2:]
            if oi in out_hws:
                vh, vw = out_hws[oi][:n_real].max(axis=0)
                oh, ow = min(_q64(int(vh)), oh), min(_q64(int(vw)), ow)
            elif op.type in FULL_BUCKET_OPS:
                # a full-bucket output that every item wants as a JPEG: the
                # encode front half runs on the device and the finish stage
                # keeps the entropy emit (not with the device JPEG switch off)
                is_wm = op.type is OperationType.WATERMARK
                if self.device_jpeg and all(
                        negotiate_format(it.payload[2], watermark=is_wm) == "jpeg"
                        for it in group.items):
                    outs_np.append(self._encode_coefs(o, group, max_h, max_w))
                    continue
                oh, ow = min(_q64(max_h), oh), min(_q64(max_w), ow)
            outs_np.append(_d2h(lambda: o[:, :, :oh, :ow].cpu().numpy()))
        METRICS.inc("engine_device_images", n_real)
        return plan, outs_np, out_hws, "chw"

    def _encode_coefs(self, canvas: torch.Tensor, group, max_h: int,
                      max_w: int):
        """A full-bucket output every item wants as a JPEG: kernel B3 over
        the group's largest valid extent rounded up to /16 (edges past each
        image's valid dims replicate; a bucket narrower than that extent is
        padded, the pad never read), then the int16 canvases to the host.
        Pad rows get valid (1, 1)."""
        mh, mw = -(-max_h // 16) * 16, -(-max_w // 16) * 16
        rgb = canvas[:, :, :mh, :mw]
        if tuple(rgb.shape[2:]) != (mh, mw):
            rgb = torch.nn.functional.pad(
                rgb, (0, mw - rgb.shape[3], 0, mh - rgb.shape[2]))
        vh = np.ones((canvas.shape[0], 2), dtype=np.int32)
        vh[:len(group.items)] = [it.hw for it in group.items]
        qt = quality_qtables(self.jpeg_quality)
        vh_t = torch.from_numpy(vh).to(canvas.device)
        qt_t = torch.from_numpy(qt.astype(np.float32)).to(canvas.device)
        with span("launch"):
            coefs = encode_420(rgb, vh_t, qt_t)
        return ("coef420", *(_d2h(lambda c=c: c.cpu().numpy()) for c in coefs), qt)

    def finish_item(self, group, i: int, plan, outs_np, out_hws,
                    layout: str = "chw") -> EngineResult:
        """``_finish_item`` in an ``encode`` span, with the upload's
        ``image_id``; each store save inside is a ``save`` span."""
        with span("encode", image_id=group.items[i].payload[1].image_id):
            return self._finish_item(group, i, plan, outs_np, out_hws)

    def _finish_item(self, group, i: int, plan, outs_np, out_hws) -> EngineResult:
        """Stage 3 for one image: crop the valid regions, then splice, emit
        or encode each output, and save. Fail-fast across the image's op
        list (reference semantics). Pixel outputs are always planar here."""
        it = group.items[i]
        _task_idx, task, fmt, _plan = it.payload
        error = getattr(it.image, "error", None)
        if error is not None:   # as a failed decode fails on the host route
            return self._failed(task, f"Failed to decode image: {error}")
        out = EngineResult(result=ProcessingResult(
            id=task.id, image_id=task.image_id, status=ImageStatus.COMPLETED))
        h, w = it.hw
        for oi, op in enumerate(plan.ops):
            o = outs_np[oi]
            try:
                if isinstance(o, tuple) and o[0] == "splice":
                    artifact = (
                        self._splice_and_save(task, op, it.splice)
                        if op.type is OperationType.WATERMARK
                        else self._coef_tx_and_save(task, op, it.splice))
                elif (op.type is OperationType.WATERMARK
                        and it.splice is not None
                        and negotiate_format(fmt, watermark=True) == "jpeg"):
                    # a mixed group computed the blend for batchmates; this
                    # item still splices (with its own fallback)
                    artifact = self._splice_and_save(task, op, it.splice)
                elif isinstance(o, tuple):
                    artifact = self._emit_and_save(task, op, o, i, h, w)
                else:
                    if oi in out_hws:
                        oh, ow = out_hws[oi][i]
                    elif op.type in FULL_BUCKET_OPS:   # crop to the valid extent
                        oh, ow = h, w
                    else:   # crop thumbnail: the (size, size) canvas is all valid
                        oh, ow = o.shape[2:]
                    artifact = self._encode_and_save(
                        task, op, o[i][:, :oh, :ow].transpose(1, 2, 0), fmt)
            except Exception as exc:
                self._classify_op_failure(out, op, exc)
                return out
            out.artifacts.append(artifact)
            out.result.processed_paths[op.type.value] = artifact.path
        return out

    def _run_group(self, group, results: list, device_section=None) -> None:
        if device_section is not None:
            with device_section("device_group"):
                plan, outs_np, out_hws, layout = self.device_group(group)
        else:
            plan, outs_np, out_hws, layout = self.device_group(group)

        def _finish(i):
            return group.items[i].payload[0], self.finish_item(
                group, i, plan, outs_np, out_hws, layout)

        t_enc = time.monotonic()
        for task_idx, res in self._pool.map(_finish, range(len(group.items))):
            results[task_idx] = res
        METRICS.observe("engine_encode_ms", (time.monotonic() - t_enc) * 1000.0)

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        if self._replicas is not None:
            self._replicas.shutdown(wait=True)
