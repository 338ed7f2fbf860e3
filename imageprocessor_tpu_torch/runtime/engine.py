"""The processing engine on PyTorch/CUDA — counterpart of the device half of
imageprocessor_tpu/runtime/engine.py, with the same surface
(``process_tasks``, ``decode_for_plan_ex``, ``device_group``,
``finish_item``, ``close``) that service/worker.py and
service/pipelined.py call. It takes and returns the port's copies of the
domain types (imageprocessor_tpu_torch.domain), so a reference worker
drives it through the tasks' and results' JSON, their wire format.

The path of one task:

1. host: a complete JPEG is entropy-scanned into int16 coefficient planes
   (runtime/hostcodec.py) when it has 3 components in a supported
   sampling (4:2:0, 4:2:2, 4:4:0, 4:4:4); anything else is decoded to
   HWC pixels by runtime/codecs.decode_image. A plan with a watermark
   whose rendition is a JPEG scans a JPEG for the splice instead
   (runtime/splice.py, when IMAGEPROCESSOR_JPEG_SPLICE is not 0). A plan
   made only of watermarks and of the transforms the coefficient domain
   expresses (crop, flip, rotation by a multiple of 90 degrees:
   runtime/coeftx.py), all with JPEG renditions, then needs no pixels at
   all (layout "splice");
2. items are grouped by (bucket, plan, layout) and padded to a power-of-
   two batch (runtime/batcher, a copy of the reference's);
3. device: kernel B1 decodes the coefficient canvases into the planar
   bucket (HWC groups are uploaded and permuted instead); the plan's
   resamples run through kernel B2 (the first thumbnail + resize pair)
   and kernel B4 (every other one); crop, flip, rotate and grayscale are
   the tensor ops of ops/extra.py; a watermark the splice does not serve
   is blended into the bucket in place. Each output with per-image valid
   dims (resample, crop, rotate) is cropped on the device to the group's
   largest valid extent (rounded up to /64) before it is copied to the
   host; a full-bucket output (watermark, flip, grayscale) whose
   renditions are all JPEGs goes through kernel B3 (the encode front
   half) at the group's largest valid extent rounded up to /16, and its
   int16 coefficient canvases are copied instead;
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
"""

from __future__ import annotations

import logging
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
from imageprocessor_tpu_torch.utils.metrics import METRICS

log = logging.getLogger("imageprocessor_tpu_torch.engine")

PERMANENT = "permanent"
TRANSIENT = "transient"

# ops whose device output is the whole bucket canvas, valid over each image's
# own (h, w): kernel B3 encodes them when every item wants a JPEG
FULL_BUCKET_OPS = (OperationType.WATERMARK, OperationType.FLIP,
                   OperationType.GRAYSCALE)


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
                 jpeg_quality: int = DEFAULT_JPEG_QUALITY):
        self.store = object_store
        self.device = resolve_device(device)
        # group_items must never emit a group larger than quantize_batch's
        # cap, or Group.pack would index past its canvas
        self.batch_size = max(1, min(batch_size, MAX_BATCH))
        self.jpeg_quality = jpeg_quality
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
                           task_format: str | None = None):
        """Decode one blob for the device path: (image, detected_format,
        layout, valid_hw, splice_ctx).

        Complete JPEGs with 3 components in a supported sampling become
        coefficient planes (layout "coef:FhFw"); everything else decodes to
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
        is_jpeg = (detect_content_type(data[:512]) == "image/jpeg"
                   and jpeg_stream_complete(data))
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
        wants_splice = (is_jpeg and splice.enabled()
                        and ((has_wm and negotiate_format(
                            fmt0, watermark=True) == "jpeg") or coef_only))

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
        if is_jpeg:
            try:
                if scanned is None:
                    scanned = hostcodec.scan_jpeg_coefficients(data)
                planes, qt, (w, h), samp = scanned
            except hostcodec.HostCodecError:
                planes = ()   # exotic stream: pixel decode below
            if len(planes) == 3:
                (hy, vy), (hc, vc), (hr, vr) = (tuple(s) for s in samp)
                fh, fw = vy, hy
                if (hc, vc) == (hr, vr) == (1, 1) and fh in (1, 2) \
                        and fw in (1, 2):
                    ch, cw = coef_canvas(bucket_for(h, w), fh, fw)
                    if (planes[0].shape[0] <= ch and planes[0].shape[1] <= cw
                            and planes[1].shape == planes[2].shape
                            and planes[1].shape[0] * fh == planes[0].shape[0]
                            and planes[1].shape[1] * fw == planes[0].shape[1]):
                        return ((planes[0], planes[1], planes[2],
                                 np.asarray(qt, dtype=np.float32)), "jpeg",
                                coef_layout(fh, fw), (h, w), sctx)
        arr, detected = decode_image(data)
        return arr, detected, "hwc", None, sctx

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
            fmt = tasks_with_data[i][0].format
            try:
                return self.decode_for_plan_ex(
                    tasks_with_data[i][1], plans[i],
                    task_format=fmt if isinstance(fmt, str) else None)
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

        for group in group_items(items, max_batch=self.batch_size):
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
        return [r if r is not None else self._failed(
            tasks_with_data[i][0], "internal: no result produced",
            kind=TRANSIENT) for i, r in enumerate(results)]

    def _upload(self, group, b: int):
        """Pack a group and put its planar (B, 3, Hb, Wb) u8 bucket on the
        device: kernel B1 for coefficient groups, a permute for HWC."""
        t_pack = time.monotonic()
        imgs, src_hw = group.pack(pad_batch_to=b)
        METRICS.observe("engine_pack_ms", (time.monotonic() - t_pack) * 1000.0)
        if group.layout.startswith("coef"):
            fh, fw = coef_factors(group.layout)
            yc, cbc, crc, qt, cv = (torch.from_numpy(a).to(self.device)
                                    for a in imgs)
            return decode_coefs(yc, cbc, crc, qt, cv, fh, fw, group.bucket), src_hw
        x = torch.from_numpy(imgs).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous(), src_hw

    def device_group(self, group):
        """Stage 2: one packed group through the device. Returns (plan,
        per-op host outputs, out_hws, layout). An output is a (B, 3, h, w)
        u8 array, ("coef420", yc, cbc, crc, qt) for B3's canvases, or
        ("splice", op) for a rendition the finish stage emits from the
        scanned coefficients (a spliced watermark, a coefficient-domain
        transform)."""
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
            METRICS.observe("engine_device_ms", 0.0)
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

        t_dev = time.monotonic()
        imgs, src_hw = self._upload(group, b)
        outs = step_chw(imgs, src_hw, {run[oi]: v for oi, v in out_hws.items()
                                       if oi in run}, specs)

        # crop on the device to the group's largest valid output (rounded
        # up to /64) before the copy to the host
        def _q64(v: int, cap: int) -> int:
            return min(-(-v // 64) * 64, cap)

        max_h = max(it.hw[0] for it in group.items)
        max_w = max(it.hw[1] for it in group.items)
        outs_np = []
        for oi, op in enumerate(plan.ops):
            if oi in splice_skip:   # spliced on the host at finish time
                outs_np.append(("splice", op))
                continue
            o = outs[run[oi]]
            if oi in out_hws:
                o = o[:, :, :_q64(int(out_hws[oi][:n_real, 0].max()), o.shape[2]),
                      :_q64(int(out_hws[oi][:n_real, 1].max()), o.shape[3])]
            elif op.type in FULL_BUCKET_OPS:
                # a full-bucket output that every item wants as a JPEG: the
                # encode front half runs on the device and the finish stage
                # keeps the entropy emit
                is_wm = op.type is OperationType.WATERMARK
                if all(negotiate_format(it.payload[2], watermark=is_wm) == "jpeg"
                       for it in group.items):
                    outs_np.append(self._encode_coefs(o, group, max_h, max_w))
                    continue
                o = o[:, :, :_q64(max_h, o.shape[2]), :_q64(max_w, o.shape[3])]
            outs_np.append(o.cpu().numpy())
        METRICS.observe("engine_device_ms", (time.monotonic() - t_dev) * 1000.0)
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
        yc, cbc, crc = encode_420(
            rgb, torch.from_numpy(vh).to(self.device),
            torch.from_numpy(qt.astype(np.float32)).to(self.device))
        return ("coef420", yc.cpu().numpy(), cbc.cpu().numpy(),
                crc.cpu().numpy(), qt)

    def finish_item(self, group, i: int, plan, outs_np, out_hws,
                    layout: str = "chw") -> EngineResult:
        """Stage 3 for one image: crop the valid regions, then splice, emit
        or encode each output, and save. Fail-fast across the image's op
        list (reference semantics)."""
        del layout  # pixel outputs are always planar here
        it = group.items[i]
        _task_idx, task, fmt, _plan = it.payload
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
