"""The port's bench: the reference bench's keys, measured on the port.

Counterpart of the repository's bench.py (the JAX package's bench) on
imageprocessor_tpu_torch: the same functions, flags and JSON keys, timed
through the port's modules and kernels B1-B4. Run from the repository root:

    python3 -m imageprocessor_tpu_torch.bench [--smoke] [--latency]
        [--batch B] [--iters N] [--lat-arrival R] [--lat-big-every N]
        [--lat-n N]

DEVICE_PLATFORM is honoured as the service honours it
(config.apply_device_platform): empty means the card, and the bench raises
without one; ``cpu`` (tests only) runs every kernel's plain PyTorch
version, and every time is then the CPU's (``platform`` and ``card`` read
"cpu"). ``--smoke`` runs every step at a small shape: 480 x 640 sources,
thumbnail 64, resize 128 x 96, batch 2.

Device times come from ``time_ms``: CUDA events around ``iters`` calls on a
stream first held busy, so the host's launch time is not counted unless a
call synchronizes (a pageable copy). Host times are the host clock.

Without --latency it prints ONE JSON line with these keys (``KEYS``):

  metric, unit       what ``value`` counts; "images/sec"
  value              device_splice_step_images_per_sec when the splice is
                     on (runtime/splice.enabled(), the default), else
                     device_jpeg_step_images_per_sec
  vs_baseline        value over the same key of the port's first full run
                     on the card (``BASELINE``)
  device_splice_step_images_per_sec
                     images/s; bench_device_jpeg_step(splice_mode=True):
                     B1 (jpeg_kernels.decode_coefs) -> B2
                     (fused_resample) on the scanned coefficients of
                     ``batch`` seeded q85 JPEGs, tap tables built once
  device_jpeg_step_images_per_sec
                     images/s; bench_device_jpeg_step(splice_mode=False):
                     B1 -> B2 -> blend (watermark_planar_) -> B3
                     (jpeg_kernels.encode_420, q85 tables)
  fused_pipeline_images_per_sec, device_step_images_per_sec_slope
                     images/s, one value under both names;
                     bench_device_pipeline: models/pipeline.step_chw
                     (thumbnail 200 crop + resize 1024 x 768 keep-aspect
                     through B2, then the watermark blend) on a decoded
                     bucket on the device, tap tables built and uploaded
                     in every call as the engine does per group
  stream_images_per_sec
                     images/s; bench_device_pipeline: a fresh pageable
                     host-to-device copy of the bucket, step_chw, and the
                     thumbnail and resize copied back, host clock
  h2d_mb_per_s, d2h_mb_per_s
                     MB/s; one 4 MB pageable copy each way, host clock
  engine_images_per_sec
                     images/s; bench_engine: host clock around a warm
                     TorchProcessingEngine.process_tasks of the ``batch``
                     seeded JPEGs, thumbnail + resize (the empty-flag
                     plan), artifacts saved to a LocalFSObjectStore
  engine_stages_ms   ms; the p50 of each engine_* and span_* timing of
                     that run
  end_to_end_one_host_core_images_per_sec, end_to_end_path
                     images/s and the path it prices; end_to_end_model:
                     the reference's model of one host core plus the
                     device step, on the splice path when the splice is on
  end_to_end_one_host_core_host_codec_images_per_sec
                     images/s; the same with OpenCV decode and encode on
                     the host around fused_pipeline_images_per_sec
  host_decode_images_per_sec_per_core, host_encode_images_per_sec_per_core,
  host_png_encode_images_per_sec_per_core,
  host_entropy_scan_images_per_sec_per_core,
  host_entropy_emit_images_per_sec_per_core
                     images/s on one host thread, best of n; bench_host_codecs:
                     runtime/codecs decode_image / encode_image (JPEG q85,
                     PNG at png_compression_level), runtime/hostcodec
                     scan_jpeg_coefficients / emit_jpeg_from_coefficients
  host_splice_scan_ms, host_splice_edit_ms, host_splice_emit_ms,
  host_splice_total_ms
                     ms, best of n; hostcodec.scan_jpeg_for_transcode,
                     splice.watermark_band, hostcodec.emit_jpeg_transcode
  splice_emit_speedup_vs_full
                     ratio; the full entropy emit over the splice's
                     edit + emit
  host_coeftx_rot90_ms
                     ms, best of n; coeftx.apply of a rotation by 90
  jpeg_bytes_12mp, png_bytes, png_compression_level
                     bytes of the q85 JPEG and of the PNG; zlib level
  psnr_db_vs_oracle  dB; quick_psnr_check: a 600 x 800 image on a
                     640 x 1024 bucket resized to 300 x 400 by
                     make_taps + planar_resample (B4 on the card) against
                     tests/oracle.py resize_go (capped at 99.99)
  compile_s          s; the first kernels.library() (nvcc, the card only)
                     and hostcodec.library() (g++) calls: ~0 when the
                     hash-named libraries are already built
  batch, bucket, layout
                     images per step; the (h, w) bucket; "chw"
  platform, card     "cuda" or "cpu"; nvidia-smi's name and power limit,
                     or "cpu"
  note               how the numbers were taken

With --latency it prints ONE JSON line (``LATENCY_KEYS``): the reference's
latency keys for the batch Worker (metric, value = p99 in ms, unit,
vs_baseline = 500 / p99, p50_ms, p90_ms, p99_ms, max_ms, small_p50_ms,
small_p99_ms, n, stages_ms, note) plus p95_ms and images_per_sec, and
each per-run key again under ``pipelined_`` for the PipelinedWorker
(bench_latency: uploads through ImageUsecase -> MemoryBroker -> worker ->
engine -> results topic, host clock from produce to result).
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from imageprocessor_tpu_torch import config as _config
from imageprocessor_tpu_torch import kernels
from imageprocessor_tpu_torch.domain import (
    ImageStatus,
    OperationParams,
    OperationType,
    ProcessingResult,
    ProcessingTask,
)
from imageprocessor_tpu_torch.models.pipeline import (
    plan_output_specs,
    step_chw,
    step_taps,
)
from imageprocessor_tpu_torch.models.plan import NormalizedOp, normalize_operations
from imageprocessor_tpu_torch.ops import watermark as wm
from imageprocessor_tpu_torch.ops.coords import keep_aspect_dims
from imageprocessor_tpu_torch.ops.fused_resample import fused_resample, make_taps
from imageprocessor_tpu_torch.ops.jpeg_encode import quality_qtables
from imageprocessor_tpu_torch.ops.jpeg_kernels import decode_coefs, encode_420
from imageprocessor_tpu_torch.ops.planar_resample import planar_resample
from imageprocessor_tpu_torch.runtime import coeftx, hostcodec, splice
from imageprocessor_tpu_torch.runtime.batcher import bucket_for
from imageprocessor_tpu_torch.runtime.codecs import (
    PNG_COMPRESSION,
    decode_image,
    encode_image,
)
from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
from imageprocessor_tpu_torch.utils.metrics import METRICS

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRATCH = REPO / "build" / "bench"
WATERMARK_TEXT = "© ImageProcessor"
# the default shapes (the reference bench's 12 MP group) and --smoke's
FULL = {"batch": 8, "iters": 20, "src_hw_px": (3000, 4000), "resize_to": (768, 1024),
        "thumb": 200}
SMOKE = {"batch": 2, "iters": 2, "src_hw_px": (480, 640), "resize_to": (96, 128),
         "thumb": 64}
GEOMETRY = ("src_hw_px", "resize_to", "thumb")
# both device steps of the port's first full run on the card (python3 -m
# imageprocessor_tpu_torch.bench on an NVIDIA H100 80GB HBM3, 700.00 W as
# nvidia-smi gives them): vs_baseline divides value by the one it reports
BASELINE = {"device_splice_step_images_per_sec": 21715.149878812463,
            "device_jpeg_step_images_per_sec": 5265.424903993618}
KEYS = (
    "metric", "value", "unit", "vs_baseline",
    "device_splice_step_images_per_sec", "device_jpeg_step_images_per_sec",
    "fused_pipeline_images_per_sec", "device_step_images_per_sec_slope",
    "stream_images_per_sec", "h2d_mb_per_s", "d2h_mb_per_s",
    "engine_images_per_sec", "engine_stages_ms",
    "end_to_end_one_host_core_images_per_sec", "end_to_end_path",
    "end_to_end_one_host_core_host_codec_images_per_sec",
    "host_decode_images_per_sec_per_core", "host_encode_images_per_sec_per_core",
    "host_png_encode_images_per_sec_per_core",
    "host_entropy_scan_images_per_sec_per_core",
    "host_entropy_emit_images_per_sec_per_core",
    "host_splice_scan_ms", "host_splice_edit_ms", "host_splice_emit_ms",
    "host_splice_total_ms", "splice_emit_speedup_vs_full", "host_coeftx_rot90_ms",
    "jpeg_bytes_12mp", "png_bytes", "png_compression_level",
    "psnr_db_vs_oracle", "compile_s", "batch", "bucket", "layout", "platform",
    "card", "note",
)
RUN_KEYS = ("p50_ms", "p90_ms", "p95_ms", "p99_ms", "max_ms", "small_p50_ms",
            "small_p99_ms", "n", "images_per_sec", "stages_ms")
LATENCY_KEYS = ("metric", "value", "unit", "vs_baseline", "note", *RUN_KEYS,
                *(f"pipelined_{k}" for k in RUN_KEYS))
STAGE_KEYS = ("queue_wait_ms", "batcher_wait_ms", "engine_decode_ms",
              "engine_encode_ms", "span_decode_ms", "span_pack_ms",
              "span_device_ms", "span_encode_ms",
              "worker_batch_ms")

_T0 = time.monotonic()


def _progress(msg: str) -> None:
    print(f"[bench +{time.monotonic() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def make_inputs(batch: int, src_h: int, src_w: int, bucket_h: int,
                bucket_w: int):
    """``batch`` seeded (bucket_h, bucket_w, 3) u8 images, each a src_h x
    src_w gradient plus noise in the top-left, and their (B, 2) valid dims
    (the reference bench's inputs, element for element)."""
    rng = np.random.default_rng(0)
    yy = np.linspace(0, 200, src_h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 55, src_w, dtype=np.float32)[None, :, None]
    base = (yy + xx).astype(np.float32)
    imgs = np.zeros((batch, bucket_h, bucket_w, 3), dtype=np.uint8)
    for i in range(batch):
        noise = rng.integers(0, 24, size=(src_h, src_w, 3), dtype=np.uint8)
        imgs[i, :src_h, :src_w] = np.clip(base + noise, 0, 255).astype(np.uint8)
    src_hw = np.tile(np.asarray([[src_h, src_w]], np.int32), (batch, 1))
    return imgs, src_hw


def time_ms(fn, iters: int = 20, warmup: int = 3, device="cuda") -> float:
    """Device ms per call of fn, by CUDA events. The stream is first held
    busy (~30 ms) so the host enqueues every call before the device
    reaches the first event: a call that never waits on the device is
    timed without the host's launch overhead. A call that synchronizes
    (a pageable host-to-device copy) still waits, so its time includes
    the host's share. On the CPU (tests only) the host clock around the
    calls."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1000.0 / iters
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def percentile(sorted_vals, p: float) -> float:
    """The reference bench's percentile rule (bench.py:633)."""
    return sorted_vals[min(int(len(sorted_vals) * p), len(sorted_vals) - 1)]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def load_oracle():
    """tests/oracle.py: the repo's float64 oracle of the Go reference."""
    spec = importlib.util.spec_from_file_location(
        "ip_oracle", REPO / "tests" / "oracle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ensure_font() -> str:
    """The watermark font: the reference's lookup when it finds one, else
    a TrueType font on the host (DejaVu Sans first), else Pillow's bundled
    default font written under build/. Sets IMAGEPROCESSOR_FONT for the
    last two (a GPU host may have no font the lookup knows)."""
    try:
        path = wm._default_font_path()
    except ImportError:   # no matplotlib: the reference's last fallback
        path = ""
    if os.path.exists(path):
        return path
    import site

    roots = ["/usr/share/fonts", "/usr/local/share/fonts", *site.getsitepackages()]
    found = sorted({f for r in roots
                    for f in glob.glob(os.path.join(r, "**", "*.ttf"), recursive=True)},
                   key=lambda f: (os.path.basename(f) != "DejaVuSans.ttf", f))
    if found:
        path = found[0]
    else:
        from PIL import ImageFont

        path = str(REPO / "build" / "fonts" / "pillow-default.ttf")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(ImageFont.load_default(36).font_bytes)
    os.environ["IMAGEPROCESSOR_FONT"] = path
    wm._DEFAULT_FONT_PATH = None
    return wm._default_font_path()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _scratch(prefix: str) -> str:
    SCRATCH.mkdir(parents=True, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=SCRATCH)


def _plan_ops(thumb: int, resize_to, watermark: bool) -> list[OperationParams]:
    ops = [OperationParams(OperationType.THUMBNAIL, {"size": thumb, "crop_to_fit": True}),
           OperationParams(OperationType.RESIZE, {"width": resize_to[1],
                                                  "height": resize_to[0],
                                                  "keep_aspect": True})]
    if watermark:
        ops.append(OperationParams(OperationType.WATERMARK, {"text": WATERMARK_TEXT}))
    return ops


def _resize_hws(batch: int, src_h: int, src_w: int, resize_to) -> dict:
    """{1: (B, 2)} valid dims of the keep-aspect resize, op index 1."""
    out_w, out_h = keep_aspect_dims(src_w, src_h, resize_to[1], resize_to[0])
    return {1: np.tile(np.asarray([[out_h, out_w]], np.int64), (batch, 1))}


def _blend_args(op: NormalizedOp):
    """(tile, colour, alpha) of a watermark op, as step_chw builds them."""
    tile = wm.quantize_tile(wm.rasterize_text(op.text, op.font_size))
    r, g, b, a = wm.resolve_color(op.font_color, op.opacity)
    return tile, (r, g, b), a / 255.0


def seeded_jpegs(batch: int, src_h: int, src_w: int) -> list[bytes]:
    """make_inputs' images encoded as q85 JPEGs (runtime/codecs: OpenCV)."""
    imgs, _ = make_inputs(batch, src_h, src_w, src_h, src_w)
    return [encode_image(imgs[i], "jpeg", 85) for i in range(batch)]


def bench_device_pipeline(device: torch.device, batch: int, iters: int,
                          src_hw_px=(3000, 4000), resize_to=(768, 1024),
                          thumb=200) -> dict:
    """The production fused step on a device-resident decoded bucket:
    step_chw of thumbnail (crop) + resize (keep-aspect) + watermark, then
    the streaming rate with a fresh pageable upload per batch, and one
    4 MB copy each way."""
    t0 = time.monotonic()
    if device.type == "cuda":
        kernels.library()
    hostcodec.library()
    compile_s = time.monotonic() - t0

    src_h, src_w = src_hw_px
    bucket = bucket_for(src_h, src_w)
    imgs, src_hw = make_inputs(batch, src_h, src_w, *bucket)
    imgs = np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))
    plan = normalize_operations(_plan_ops(thumb, resize_to, watermark=True))
    specs = plan_output_specs(plan)
    out_hws = _resize_hws(batch, src_h, src_w, resize_to)

    _progress("fused pipeline: step_chw on a device-resident bucket")
    imgs_dev = torch.from_numpy(imgs).to(device, copy=True)
    step_ms = time_ms(lambda: step_chw(imgs_dev, src_hw, out_hws, specs),
                      iters=iters, device=device)

    probe = np.zeros((4 << 20,), dtype=np.uint8)
    t0 = time.monotonic()
    probe_dev = torch.from_numpy(probe).to(device, copy=True)
    _sync(device)
    h2d_mb_per_s = 4.0 / max(time.monotonic() - t0, 1e-9)
    t0 = time.monotonic()
    probe_dev.to("cpu", copy=True)
    d2h_mb_per_s = 4.0 / max(time.monotonic() - t0, 1e-9)

    _progress("fused pipeline: streaming")
    n_stream = max(iters // 2, 2)
    t0 = time.monotonic()
    for _ in range(n_stream):
        outs = step_chw(torch.from_numpy(imgs).to(device, copy=True), src_hw, out_hws,
                        specs)
        outs[0].cpu()
        outs[1].cpu()
    stream_s = time.monotonic() - t0
    rate = batch * 1000.0 / step_ms
    return {"fused_pipeline_images_per_sec": rate,
            "device_step_images_per_sec_slope": rate,
            "stream_images_per_sec": batch * n_stream / stream_s,
            "h2d_mb_per_s": h2d_mb_per_s, "d2h_mb_per_s": d2h_mb_per_s,
            "compile_s": compile_s, "batch": batch, "bucket": list(bucket),
            "layout": "chw"}


def bench_device_jpeg_step(device: torch.device, batch: int, splice_mode: bool,
                           src_hw_px=(3000, 4000), resize_to=(768, 1024),
                           thumb=200, iters: int = 20) -> dict:
    """The device-JPEG step of the engine's dispatch (runtime/engine.py
    device_group) on the scanned coefficients of ``batch`` seeded q85
    JPEGs, the tap and quantization tables built once. splice_mode=True (the
    default route: the watermark rendition is spliced on the host): B1 ->
    B2. splice_mode=False: B1 -> B2 -> the watermark blend -> B3 over the
    group's largest valid extent rounded up to /16."""
    src_h, src_w = src_hw_px
    bucket = bucket_for(src_h, src_w)
    _progress(f"device-jpeg step (splice_mode={splice_mode}): scanning coefficients")
    scans = [hostcodec.scan_jpeg_coefficients(d) for d in seeded_jpegs(batch, src_h, src_w)]
    fw, fh = scans[0][3][0]   # the luma's (h, v) sampling factors
    chroma = (batch, bucket[0] // fh, bucket[1] // fw)
    canvases = (np.zeros((batch, *bucket), np.int16), np.zeros(chroma, np.int16),
                np.zeros(chroma, np.int16), np.zeros((batch, 3, 8, 8), np.float32),
                np.ones((batch, 2), np.int32))
    for i, (planes, qtabs, _size, _sampling) in enumerate(scans):
        for canvas, plane in zip(canvases[:3], planes):
            canvas[i, :plane.shape[0], :plane.shape[1]] = plane
        canvases[3][i] = qtabs
        canvases[4][i] = planes[1].shape
    yc, cbc, crc, qt, cv = (torch.from_numpy(a).to(device) for a in canvases)

    plan = normalize_operations(_plan_ops(thumb, resize_to, watermark=not splice_mode))
    src_hw = np.tile(np.asarray([[src_h, src_w]], np.int64), (batch, 1))
    taps = step_taps(bucket, src_hw, _resize_hws(batch, src_h, src_w, resize_to),
                     plan_output_specs(plan), device)

    def decode_resample():
        rgb = decode_coefs(yc, cbc, crc, qt, cv, fh, fw, bucket)
        fused_resample(rgb, taps[0], taps[1])
        return rgb

    if splice_mode:
        step = decode_resample
    else:
        tile, color, alpha = _blend_args(plan.ops[2])
        mh, mw = -(-src_h // 16) * 16, -(-src_w // 16) * 16
        valid = torch.from_numpy(src_hw.astype(np.int32)).to(device)
        eqt = torch.from_numpy(quality_qtables(85).astype(np.float32)).to(device)

        def step():
            rgb = wm.watermark_planar_(decode_resample(), src_hw, tile, color, alpha,
                                       plan.ops[2].position)
            return encode_420(rgb[:, :, :mh, :mw], valid, eqt)

    ms = time_ms(step, iters=iters, device=device)
    key = ("device_splice_step_images_per_sec" if splice_mode
           else "device_jpeg_step_images_per_sec")
    _progress(f"device-jpeg step (splice_mode={splice_mode}): {ms:.4f} ms per batch")
    return {key: batch * 1000.0 / ms, "batch": batch}


def bench_host_codecs(src_hw_px=(3000, 4000), n: int = 4) -> dict:
    """One host thread's codec rates, best of ``n``: OpenCV decode and
    encode, PNG, the entropy scan and emit, the splice's stages and the
    coefficient-domain rotation by 90."""
    src_h, src_w = src_hw_px
    imgs, _ = make_inputs(1, src_h, src_w, src_h, src_w)
    arr = imgs[0]
    jpeg = encode_image(arr, "jpeg", 85)

    def best(fn, reps: int = n) -> float:
        out = float("inf")
        for _ in range(reps):
            t0 = time.monotonic()
            fn()
            out = min(out, time.monotonic() - t0)
        return out

    out = {"host_decode_images_per_sec_per_core": 1.0 / best(lambda: decode_image(jpeg)),
           "host_encode_images_per_sec_per_core":
               1.0 / best(lambda: encode_image(arr, "jpeg", 85)),
           "jpeg_bytes_12mp": len(jpeg)}
    png = encode_image(arr, "png")
    out["host_png_encode_images_per_sec_per_core"] = 1.0 / best(
        lambda: encode_image(arr, "png"), max(n // 2, 1))
    out["png_bytes"] = len(png)
    out["png_compression_level"] = PNG_COMPRESSION

    planes, qt, dims, samp = hostcodec.scan_jpeg_coefficients(jpeg)
    out["host_entropy_scan_images_per_sec_per_core"] = 1.0 / best(
        lambda: hostcodec.scan_jpeg_coefficients(jpeg))
    out["host_entropy_emit_images_per_sec_per_core"] = 1.0 / best(
        lambda: hostcodec.emit_jpeg_from_coefficients(planes, qt, dims[0], dims[1],
                                                      samp[0]))

    # the splice's stages: offset-recording scan, band edit, splice emit
    op = SimpleNamespace(text=WATERMARK_TEXT, opacity=0.5, position="bottom-right",
                         font_size=36.0, font_color="")
    ctx = hostcodec.scan_jpeg_for_transcode(jpeg)
    out["host_splice_scan_ms"] = best(
        lambda: hostcodec.scan_jpeg_for_transcode(jpeg)) * 1000.0
    planes0 = [p.copy() for p in ctx.planes]
    splice.watermark_band(ctx, op)   # warm the raster cache
    edit_s = float("inf")
    for _ in range(n):
        ctx.planes = [p.copy() for p in planes0]   # outside the window
        ctx.edited = False
        t0 = time.monotonic()
        flags = splice.watermark_band(ctx, op)
        edit_s = min(edit_s, time.monotonic() - t0)
    out["host_splice_edit_ms"] = edit_s * 1000.0
    out["host_splice_emit_ms"] = best(
        lambda: hostcodec.emit_jpeg_transcode(ctx, flags)) * 1000.0
    out["host_splice_total_ms"] = (out["host_splice_scan_ms"]
                                   + out["host_splice_edit_ms"]
                                   + out["host_splice_emit_ms"])
    out["splice_emit_speedup_vs_full"] = (
        (1000.0 / out["host_entropy_emit_images_per_sec_per_core"])
        / (out["host_splice_edit_ms"] + out["host_splice_emit_ms"]))

    # the lossless coefficient-domain rotation alone (scan and emit above)
    cctx = splice.coef_context(planes, qt, dims, samp)
    prims = coeftx.eligible_prims(NormalizedOp(type=OperationType.ROTATE, angle=90.0),
                                  cctx.size, cctx.sampling)
    coeftx.apply(cctx, prims)   # warm
    out["host_coeftx_rot90_ms"] = best(lambda: coeftx.apply(cctx, prims)) * 1000.0
    return out


def bench_engine(device: torch.device, batch: int, src_hw_px=(3000, 4000),
                 resize_to=(768, 1024), thumb=200) -> dict:
    """Host clock around a warm TorchProcessingEngine.process_tasks of the
    ``batch`` seeded JPEGs with the empty-flag plan (thumbnail + resize),
    artifacts saved to a LocalFSObjectStore under build/; the p50 of each
    engine_* timing of that run."""
    from imageprocessor_tpu_torch.storage import LocalFSObjectStore

    ops = _plan_ops(thumb, resize_to, watermark=False)
    work = [(ProcessingTask(id=f"task{k}", image_id=f"bench{k}",
                            original_path=f"originals/bench{k}.jpg", bucket="images",
                            operations=ops, format="jpeg"), data)
            for k, data in enumerate(seeded_jpegs(batch, *src_hw_px))]
    root = _scratch("engine-")
    engine = TorchProcessingEngine(LocalFSObjectStore(root), device=device,
                                   batch_size=batch)
    try:
        engine.process_tasks(work)   # warm: the libraries, the first launches
        METRICS.reset()
        t0 = time.monotonic()
        results = engine.process_tasks(work)
        wall = time.monotonic() - t0
        failed = [r.result.error for r in results
                  if r.result.status is not ImageStatus.COMPLETED]
        if failed:
            raise RuntimeError(f"engine run: {len(failed)} tasks failed: {failed[:2]}")
        stages = {k: v["p50"] for k, v in METRICS.snapshot()["timings"].items()
                  if k.startswith(("engine_", "span_"))}
    finally:
        engine.close()
        shutil.rmtree(root, ignore_errors=True)
    return {"engine_images_per_sec": batch / wall, "engine_stages_ms": stages}


def bench_latency(device: torch.device, worker_cls, n_images: int = 60,
                  size=(480, 640), big_every: int = 10, deadline_ms: float = 25.0,
                  arrival_per_sec: float = 200.0, traced: bool = False) -> dict:
    """Queue-to-processed latency through the port's service stack:
    ImageUsecase.upload_image -> MemoryBroker -> ``worker_cls`` (Worker or
    PipelinedWorker) -> TorchProcessingEngine ->
    storage -> the results topic. ``n_images`` uploads of a size[0] x
    size[1] q85 JPEG with a 3000 x 4000 one every ``big_every``th (0:
    none), default plan, batch_size 16, arrivals at ``arrival_per_sec``;
    latency from produce to the result, host clock, after a warm-up of
    every bucket and batch size the load can form. ``traced`` runs the
    load under utils/tracing.profile_capture and adds device_busy_share:
    the share of the window in which the card ran a kernel or a copy
    (None when the trace holds no device time)."""
    from imageprocessor_tpu_torch.broker import MemoryBroker
    from imageprocessor_tpu_torch.service.usecase import ImageUsecase
    from imageprocessor_tpu_torch.storage import LocalFSObjectStore, SQLiteMetadataStore
    from imageprocessor_tpu_torch.utils.tracing import profile_capture

    root = _scratch("latency-")
    cfg = _config.load({"DEVICE_PLATFORM": device.type})
    cfg.worker.batch_size = 16
    cfg.worker.batch_deadline_ms = deadline_ms
    results_topic = cfg.broker.results_topic
    meta = SQLiteMetadataStore(":memory:")
    store = LocalFSObjectStore(os.path.join(root, "objects"))
    broker = MemoryBroker()
    uc = ImageUsecase(meta, store, broker)
    worker = worker_cls(cfg, meta=meta, store=store, broker=broker)
    worker._idle_sleep = 0.002
    ops = _plan_ops(200, (768, 1024), watermark=False)
    small_jpeg = seeded_jpegs(1, *size)[0]
    big_jpeg = seeded_jpegs(1, 3000, 4000)[0] if big_every > 0 else b""
    try:
        _progress(f"latency ({worker_cls.__name__}): warming every bucket and batch size")
        warm = [(small_jpeg, (16, 8, 4, 2, 1))]
        if big_every > 0:
            warm.append((big_jpeg, (4, 2, 1)))
        for data, copies in warm:
            for n in copies:
                for i in range(n):
                    uc.upload_image(data, f"warm{n}-{i}.jpg", "image/jpeg", ops)
                while worker.run_once(max_n=n) > 0:
                    pass
        while broker.poll(results_topic, "bench", max_n=1000):
            pass
        METRICS.reset()
        t_start: dict[str, float] = {}
        t_done: dict[str, float] = {}
        is_big: dict[str, bool] = {}
        stop = threading.Event()

        def timed_done() -> int:
            # list() snapshots the dict the results thread inserts into
            return sum(1 for k in list(t_done) if k in t_start)

        def consume():
            # every result's first completion time: the worker may finish
            # an upload before its t_start is written
            while not stop.is_set() and timed_done() < n_images:
                for msg in broker.poll(results_topic, "bench", max_n=32):
                    res = ProcessingResult.from_json(msg.value)
                    t_done.setdefault(res.image_id, time.monotonic())
                    broker.ack(msg)
                time.sleep(0.001)

        def load_phase():
            worker_t = threading.Thread(target=worker.run, daemon=True)
            results_t = threading.Thread(target=consume, daemon=True)
            worker_t.start()
            results_t.start()
            try:
                for i in range(n_images):
                    big_one = big_every > 0 and (i + 1) % big_every == 0
                    img = uc.upload_image(big_jpeg if big_one else small_jpeg,
                                          f"l{i}.jpg", "image/jpeg", ops)
                    t_start[img.id] = time.monotonic()
                    is_big[img.id] = big_one
                    time.sleep(1.0 / arrival_per_sec)
                deadline = time.monotonic() + 300
                while timed_done() < n_images and time.monotonic() < deadline:
                    time.sleep(0.01)
            finally:
                worker.stop()
                stop.set()
                results_t.join(timeout=30)
                worker_t.join(timeout=120)
            if worker_t.is_alive() or results_t.is_alive():
                raise RuntimeError("the latency run's threads did not stop")
            if timed_done() < n_images:
                raise RuntimeError(f"{timed_done()} of {n_images} results in 300 s")

        busy_share = None
        if traced:
            trace_dir = os.path.join(root, "trace")
            with profile_capture(trace_dir):
                load_phase()
            # the card's own events in the Chrome trace: kernels and copies
            # (one stream, so their durations do not overlap)
            with open(glob.glob(os.path.join(trace_dir, "*.json"))[0]) as f:
                events = json.load(f)["traceEvents"]
            busy_us = sum(e.get("dur", 0) for e in events if e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset"))
            if busy_us > 0:
                busy_share = busy_us / 1e6 / (max(t_done.values()) - min(t_start.values()))
        else:
            load_phase()
        lat = sorted((t_done[k] - t_start[k]) * 1000.0 for k in t_start)
        small = sorted((t_done[k] - t_start[k]) * 1000.0
                       for k in t_start if not is_big[k])
        window = max(t_done[k] for k in t_start) - min(t_start.values())
        snap = METRICS.snapshot()
        completed = snap["counters"].get("worker_completed", 0)
        if completed != n_images:
            raise RuntimeError(f"worker_completed {completed} of {n_images}")
    finally:
        worker.close()
        shutil.rmtree(root, ignore_errors=True)
    out = {"p50_ms": percentile(lat, 0.50), "p90_ms": percentile(lat, 0.90),
           "p95_ms": percentile(lat, 0.95), "p99_ms": percentile(lat, 0.99),
           "max_ms": lat[-1],
           "small_p50_ms": percentile(small, 0.50) if small else 0.0,
           "small_p99_ms": percentile(small, 0.99) if small else 0.0,
           "n": len(lat), "images_per_sec": n_images / window,
           "stages_ms": {k: snap["timings"][k] for k in STAGE_KEYS
                         if k in snap["timings"]}}
    if traced:
        out["device_busy_share"] = busy_share
    return out


def quick_psnr_check(device: torch.device):
    """Fidelity gate: a seeded 600 x 800 image on a 640 x 1024 bucket,
    resized to 300 x 400 by make_taps + planar_resample (kernel B4 on the
    card) against the float64 Go oracle. Returns (PSNR in dB, the (300,
    400, 3) u8 output)."""
    oracle = load_oracle()
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(600, 800, 3), dtype=np.uint8)
    bucket = np.zeros((1, 3, 640, 1024), dtype=np.uint8)
    bucket[0, :, :600, :800] = img.transpose(2, 0, 1)
    taps = make_taps(np.array([[600, 800]]), np.array([[300, 400]]), (300, 400),
                     (640, 1024)).to(device)
    out = planar_resample(torch.from_numpy(bucket).to(device), taps)
    out = out[0].permute(1, 2, 0).cpu().numpy()
    return float(oracle.psnr(out, oracle.resize_go(img, 400, 300))), out


def end_to_end_model(codecs: dict, spl_step: float, djpeg: float,
                     fused_rate: float, splice_on: bool) -> dict:
    """The reference bench's end-to-end model of one host core plus the
    device (bench.py:745-777), in images/s. The port's engine always takes
    the device JPEG route on the card, so the path follows the splice
    switch alone: with the splice on, the host scans and splices the
    watermark (host_splice_* ms) while the device runs the splice step
    (spl_step, images/s); with it off, the host runs the entropy scan and
    the full emit around the splice-off step (djpeg). The host-codec rate
    prices OpenCV decode and encode around the fused step (fused_rate)."""
    host_codec = 1.0 / (1.0 / codecs["host_decode_images_per_sec_per_core"]
                        + 1.0 / codecs["host_encode_images_per_sec_per_core"]
                        + 1.0 / max(fused_rate, 1e-9))
    if splice_on:
        host_ms = (codecs["host_splice_scan_ms"] + codecs["host_splice_edit_ms"]
                   + codecs["host_splice_emit_ms"])
        one_core = 1.0 / (host_ms / 1000.0 + 1.0 / max(spl_step, 1e-9))
        path = "device_jpeg_splice"
    else:
        one_core = 1.0 / (1.0 / codecs["host_entropy_scan_images_per_sec_per_core"]
                          + 1.0 / codecs["host_entropy_emit_images_per_sec_per_core"]
                          + 1.0 / max(djpeg, 1e-9))
        path = "device_jpeg"
    return {"end_to_end_one_host_core_images_per_sec": one_core,
            "end_to_end_path": path,
            "end_to_end_one_host_core_host_codec_images_per_sec": host_codec}


def _latency_line(device: torch.device, args) -> dict:
    from imageprocessor_tpu_torch.service.pipelined import PipelinedWorker
    from imageprocessor_tpu_torch.service.worker import Worker

    runs = {kind: bench_latency(device, cls, n_images=args.lat_n,
                                big_every=args.lat_big_every,
                                arrival_per_sec=args.lat_arrival)
            for kind, cls in (("batch", Worker), ("pipelined", PipelinedWorker))}
    p99 = runs["batch"]["p99_ms"]
    return {"metric": "p99 queue-to-processed latency, batch worker",
            "value": p99, "unit": "ms", "vs_baseline": 500.0 / max(p99, 1e-3),
            **runs["batch"],
            **{f"pipelined_{k}": v for k, v in runs["pipelined"].items()},
            "note": ("full stack: upload -> queue -> worker -> engine on "
                     f"{device.type} -> storage -> results topic; the "
                     "pipelined_ keys are the same run under PipelinedWorker; "
                     "vs_baseline = 500 ms target / p99 (> 1 beats it)")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python3 -m imageprocessor_tpu_torch.bench",
        description="The reference bench's keys, measured on the port.")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny shapes, fast verification run")
    parser.add_argument("--latency", action="store_true",
                        help="p99 queue-to-processed through the full stack")
    parser.add_argument("--lat-arrival", type=float, default=200.0,
                        help="latency run: uploads/sec arrival rate "
                             "(above the host's capacity this measures "
                             "queue growth, not service latency)")
    parser.add_argument("--lat-big-every", type=int, default=10,
                        help="latency run: every Nth upload is 12 MP "
                             "(0 disables)")
    parser.add_argument("--lat-n", type=int, default=60,
                        help="latency run: number of uploads")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--iters", type=int, default=None,
                        help="timed calls per device step (default 20; "
                             "--smoke 2); the streaming run makes half")
    args = parser.parse_args(argv)

    device = _config.apply_device_platform(_config.load())
    card = card_line() if device.type == "cuda" else "cpu"
    _progress(f"device {device} ({card}); watermark font {ensure_font()}")

    if args.latency:
        print(json.dumps(_latency_line(device, args)))
        return 0

    shape = SMOKE if args.smoke else FULL
    batch, iters = args.batch or shape["batch"], args.iters or shape["iters"]
    geo = {k: shape[k] for k in GEOMETRY}

    dev = bench_device_pipeline(device, batch, iters, **geo)
    codecs = bench_host_codecs(shape["src_hw_px"], n=2 if args.smoke else 4)
    spl = bench_device_jpeg_step(device, batch, True, iters=iters, **geo)
    djpeg = bench_device_jpeg_step(device, batch, False, iters=iters, **geo)
    engine = bench_engine(device, batch, **geo)
    psnr_db, _ = quick_psnr_check(device)

    splice_on = splice.enabled()
    key = ("device_splice_step_images_per_sec" if splice_on
           else "device_jpeg_step_images_per_sec")
    value = (spl if splice_on else djpeg)[key]
    model = end_to_end_model(codecs, spl["device_splice_step_images_per_sec"],
                             djpeg["device_jpeg_step_images_per_sec"],
                             dev["fused_pipeline_images_per_sec"], splice_on)
    out = {
        "metric": (f"{shape['src_hw_px'][0]}x{shape['src_hw_px'][1]} images/sec "
                   + ("(B1 decode -> B2 thumbnail+resize on the device; watermark "
                      "by host splice, the default route)" if splice_on else
                      "(B1 decode -> B2 thumbnail+resize -> blend -> B3 encode on "
                      "the device; IMAGEPROCESSOR_JPEG_SPLICE=0)")
                   + "; PSNR vs the Go oracle"),
        "value": value,
        "unit": "images/sec",
        "vs_baseline": value / BASELINE[key],
        "psnr_db_vs_oracle": min(psnr_db, 99.99),
        "device_splice_step_images_per_sec": spl["device_splice_step_images_per_sec"],
        "device_jpeg_step_images_per_sec": djpeg["device_jpeg_step_images_per_sec"],
        **dev,
        **engine,
        **model,
        **codecs,
        "platform": device.type,
        "card": card,
        "note": ("device steps: CUDA events over the timed calls on a busy "
                 "stream (time_ms); stream, engine and host_* keys: host clock; "
                 "host_* are one host thread; on platform cpu every kernel "
                 "ran its plain PyTorch version and every time is the CPU's"),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
