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
   HWC pixels by runtime/codecs.decode_image;
2. items are grouped by (bucket, plan, layout) and padded to a power-of-
   two batch (runtime/batcher, a copy of the reference's);
3. device: kernel B1 decodes the coefficient canvases into the planar
   bucket (HWC groups are uploaded and permuted instead), kernel B2
   writes the resize and the thumbnail in one launch, and each output is
   cropped on the device to the group's largest valid extent (rounded up
   to /64) before it is copied to the host;
4. host: each image's outputs are encoded by runtime/codecs.encode_image
   and saved under the reference's deterministic paths.

This slice serves plans made only of thumbnail and resize ops — the
service's default upload. Any other op fails the task PERMANENTLY with
UnsupportedOperationError. Failures are classified like the reference:
PERMANENT (bad input; acked) or TRANSIENT (storage, OS, device; nacked
for redelivery).
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
from imageprocessor_tpu_torch.errors import StorageError, UnsupportedOperationError
from imageprocessor_tpu_torch.kernels import KernelError
from imageprocessor_tpu_torch.models.pipeline import (
    RESAMPLE_OPS,
    plan_output_specs,
    step_chw,
)
from imageprocessor_tpu_torch.models.plan import (
    InvalidParamsError,
    NormalizedOp,
    OperationPlan,
    normalize_operations,
)
from imageprocessor_tpu_torch.ops.coords import keep_aspect_dims, thumbnail_dims
from imageprocessor_tpu_torch.ops.jpeg_kernels import decode_coefs
from imageprocessor_tpu_torch.runtime import hostcodec
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


def check_supported(plan: OperationPlan) -> None:
    """Raise UnsupportedOperationError for ops outside this slice."""
    for op in plan.ops:
        if op.type not in RESAMPLE_OPS:
            raise UnsupportedOperationError(
                f"operation {op.type.value} is not served by the torch "
                "engine yet")


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
        """arr: planar (3, h, w) u8 valid output."""
        out_fmt = negotiate_format(fmt)
        data = encode_image(np.ascontiguousarray(arr.transpose(1, 2, 0)),
                            out_fmt, quality=self.jpeg_quality)
        path = generate_path(task.image_id, op, out_fmt)
        mime = mime_from_path(path)
        self._save(path, data, mime)
        return Artifact(operation=op.type.value, path=path, size=len(data),
                        mime_type=mime, format=out_fmt)

    # ---------------------------------------------------------------- decode

    def decode_for_plan_ex(self, data: bytes, plan: OperationPlan | None,
                           task_format: str | None = None):
        """Decode one blob for the device path: (image, detected_format,
        layout, valid_hw, None). Complete JPEGs with 3 components in a
        supported sampling become coefficient planes (layout "coef:FhFw");
        everything else decodes to (h, w, 3) pixels (layout "hwc"). The
        fifth element (the reference's splice context) is always None."""
        del task_format  # no splice path in this slice
        if plan is not None:
            check_supported(plan)
        if (detect_content_type(data[:512]) == "image/jpeg"
                and jpeg_stream_complete(data)):
            try:
                planes, qt, (w, h), samp = hostcodec.scan_jpeg_coefficients(data)
            except hostcodec.HostCodecError:
                planes = None   # exotic stream: pixel decode below
            if planes is not None and len(planes) == 3:
                (hy, vy), (hc, vc), (hr, vr) = (tuple(s) for s in samp)
                fh, fw = vy, hy
                if (hc, vc) == (hr, vr) == (1, 1) and fh in (1, 2) \
                        and fw in (1, 2):
                    ch, cw = coef_canvas(bucket_for(h, w), fh, fw)
                    if (planes[0].shape[0] <= ch and planes[0].shape[1] <= cw
                            and planes[1].shape == planes[2].shape
                            and planes[1].shape[0] * fh == planes[0].shape[0]
                            and planes[1].shape[1] * fw == planes[0].shape[1]):
                        return ((planes[0], planes[1], planes[2], qt), "jpeg",
                                coef_layout(fh, fw), (h, w), None)
        arr, detected = decode_image(data)
        return arr, detected, "hwc", None, None

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
                check_supported(plans[i])
            except (InvalidParamsError, UnsupportedOperationError,
                    ValueError) as exc:
                results[i] = self._failed(task, f"Operation failed: {exc}")

        def _dec(i):
            try:
                return self.decode_for_plan_ex(tasks_with_data[i][1], plans[i])
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
            arr, detected, layout, valid_hw, _ = dec
            try:
                fmt = (task.format or detected or "jpeg").lower()
                items.append(BatchItem(item_id=str(i), image=arr,
                                       plan_key=plans[i].group_key(),
                                       payload=(i, task, fmt, plans[i]),
                                       layout=layout, valid_hw=valid_hw))
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
        per-op host outputs (B, 3, h, w) u8, out_hws, layout)."""
        plan: OperationPlan = group.items[0].payload[3]
        n_real = len(group.items)
        b = quantize_batch(n_real)

        # per-op, per-image valid output dims (Go-exact host arithmetic);
        # pad rows mirror the last real image
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
        specs = plan_output_specs(plan, aspect_long)

        t_dev = time.monotonic()
        imgs, src_hw = self._upload(group, b)
        outs = step_chw(imgs, src_hw, out_hws, specs)

        # crop on the device to the group's largest valid output (rounded
        # up to /64) before the copy to the host
        def _q64(v: int, cap: int) -> int:
            return min(-(-v // 64) * 64, cap)

        outs_np = []
        for oi, o in enumerate(outs):
            if oi in out_hws:
                mh = _q64(int(out_hws[oi][:n_real, 0].max()), o.shape[2])
                mw = _q64(int(out_hws[oi][:n_real, 1].max()), o.shape[3])
                o = o[:, :, :mh, :mw]
            outs_np.append(o.cpu().numpy())
        METRICS.observe("engine_device_ms", (time.monotonic() - t_dev) * 1000.0)
        METRICS.inc("engine_device_images", n_real)
        return plan, outs_np, out_hws, "chw"

    def finish_item(self, group, i: int, plan, outs_np, out_hws,
                    layout: str = "chw") -> EngineResult:
        """Stage 3 for one image: crop the valid regions, encode, save.
        Fail-fast across the image's op list (reference semantics)."""
        del layout  # outputs are always planar here
        it = group.items[i]
        _task_idx, task, fmt, _plan = it.payload
        out = EngineResult(result=ProcessingResult(
            id=task.id, image_id=task.image_id, status=ImageStatus.COMPLETED))
        for oi, op in enumerate(plan.ops):
            if oi in out_hws:
                oh, ow = out_hws[oi][i]
                arr = outs_np[oi][i][:, :oh, :ow]
            else:   # crop thumbnail: the (size, size) canvas is all valid
                arr = outs_np[oi][i]
            try:
                artifact = self._encode_and_save(task, op, arr, fmt)
            except Exception as exc:
                out.result.status = ImageStatus.FAILED
                out.result.error = f"Operation {op.type.value} failed: {exc}"
                out.error_kind = (TRANSIENT if self._is_infra_failure(exc)
                                  else PERMANENT)
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
