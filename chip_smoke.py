#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (imageprocessor_tpu_torch) once on one card.

Run from the repository root on a host with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile the kernels (csrc/*.cu, nvcc, sm_90a) and the host
   entropy-scan library from this checkout's sources;
3. B1      — the JPEG coefficient-decode kernel against its plain PyTorch
   version: all four subsamplings with mixed valid dims and pad rows, and
   8 x 3072 x 4096 4:2:0 (limit: 1 LSB inside each valid region);
4. B2      — the fused resize+thumbnail kernel against its plain version,
   both thumbnail modes and an upscale (limit: 1 LSB);
5. main path — the worker's own steps on the default (empty-flag) upload
   plan: originals in a LocalFSObjectStore, ProcessingTask JSON on a
   MemoryBroker, TorchProcessingEngine.process_tasks, ProcessedImage rows
   in a SQLiteMetadataStore, ack. Eight seeded 3000 x 4000 q85 4:2:0
   JPEGs plus 1920 x 1080, 640 x 480 (an upscale) and a 4:4:4 source,
   all encoded with OpenCV. It checks every task COMPLETED, the
   artifacts' dims, that both kernels launched during the run, that the
   group outputs match the plain versions, and that the small images
   match the float64 Go oracle; a warm rerun reports host-clock
   throughput and the engine's stage times;
6. timing  — CUDA events after warm-up at 8 x 3072 x 4096: each kernel
   and its plain version, and the composed decode -> resample step; the
   host clock times one group's tap tables (build and upload).

The line before the last is the card's name and power limit as
nvidia-smi gives them, the one before it a JSON summary of the kernels;
the last line is {"ok": true, "device": {...}}. Only imageprocessor_tpu_torch
is imported: neither jax nor the reference package imageprocessor_tpu.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import uuid

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
B, H, W = 8, 3072, 4096          # the main path's 12 MP group
LSB_LIMIT = 1


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def max_err(a: torch.Tensor, b: torch.Tensor, dims) -> int:
    """Max |a - b| over each image's valid (h, w) region."""
    return max(int((a[i, :, :h, :w].int() - b[i, :, :h, :w].int()).abs().max())
               for i, (h, w) in enumerate(dims))


def coef_case(dims, h, w, fh, fw, seed, pad_to=0):
    """Seeded coefficient canvases (the reference's test_pallas_jpeg case)
    plus pad rows the way Group.pack writes them."""
    rng = np.random.default_rng(seed)
    n = len(dims)
    b = max(n, pad_to)
    mh, mw = 8 * fh, 8 * fw
    yc = np.zeros((b, h, w), np.int16)
    cbc = np.zeros((b, h // fh, w // fw), np.int16)
    crc = np.zeros_like(cbc)
    qt = np.zeros((b, 3, 8, 8), np.float32)
    qt[:, :, 0, 0] = 1.0
    cv = np.ones((b, 2), np.int32)
    yc[:n] = rng.integers(-512, 512, (n, h, w))
    cbc[:n] = rng.integers(-256, 256, (n, h // fh, w // fw))
    crc[:n] = rng.integers(-256, 256, (n, h // fh, w // fw))
    qt[:n] = np.abs(rng.normal(6, 2, (n, 3, 8, 8))) + 1
    for i, (vh, vw) in enumerate(dims):
        gh, gw = -(-vh // mh) * mh, -(-vw // mw) * mw
        yc[i, gh:], yc[i, :, gw:] = 0, 0
        for c in (cbc, crc):
            c[i, gh // fh:], c[i, :, gw // fw:] = 0, 0
        cv[i] = (gh // fh, gw // fw)
    return [torch.from_numpy(a).cuda() for a in (yc, cbc, crc, qt, cv)]


def jpeg(img: np.ndarray, subsample: bool) -> bytes:
    """q85 JPEG of a planar RGB image, 4:2:0 or 4:4:4 (OpenCV)."""
    import cv2

    factor = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420 if subsample
              else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img[::-1].transpose(1, 2, 0)),
                           [cv2.IMWRITE_JPEG_QUALITY, 85,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
    if not ok:
        fail("OpenCV could not encode an original")
    return buf.tobytes()


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """Seeded smooth-plus-texture planar RGB test image."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    phase = rng.uniform(0, 6.28, 3)
    chans = [96 + 80 * np.sin(6.0 * xx + 4.0 * yy + phase[c])
             + 40 * np.cos(9.0 * yy - 3.0 * xx + phase[c]) for c in range(3)]
    img = np.stack(chans) + rng.normal(0, 6, (3, h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def load_oracle():
    """tests/oracle.py: the repo's float64 oracle of the Go reference."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ip_oracle", os.path.join(REPO, "tests", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from imageprocessor_tpu_torch import kernels
    from imageprocessor_tpu_torch.broker import MemoryBroker
    from imageprocessor_tpu_torch.domain import (
        KAFKA_GROUP_ID,
        KAFKA_TOPIC_PROCESSING,
        Image,
        ImageStatus,
        OperationParams,
        OperationType,
        ProcessedImage,
        ProcessingTask,
    )
    from imageprocessor_tpu_torch.models.pipeline import (
        plan_output_specs,
        step_taps,
    )
    from imageprocessor_tpu_torch.models.plan import normalize_operations
    from imageprocessor_tpu_torch.ops import fused_resample as fr
    from imageprocessor_tpu_torch.ops import jpeg_kernels
    from imageprocessor_tpu_torch.ops.coords import keep_aspect_dims
    from imageprocessor_tpu_torch.ops.jpeg_decode import decode_ycbcr
    from imageprocessor_tpu_torch.runtime import hostcodec
    from imageprocessor_tpu_torch.runtime.batcher import BatchItem, group_items
    from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
    from imageprocessor_tpu_torch.storage import (
        LocalFSObjectStore,
        SQLiteMetadataStore,
    )
    from imageprocessor_tpu_torch.utils.metrics import METRICS
    oracle = load_oracle()

    # ---- 1. device
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] {name}; nvidia-smi: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---- 2. build
    t0 = time.monotonic()
    kernels.library()
    t1 = time.monotonic()
    hostcodec.library()
    t2 = time.monotonic()
    log(f"[2 build] kernels (nvcc sm_90a) {t1 - t0:.2f} s, host entropy scan "
        f"(g++) {t2 - t1:.2f} s")

    # ---- 3. B1 vs plain
    b1_err = 0
    for fh, fw in ((2, 2), (1, 2), (2, 1), (1, 1)):
        for ch, cw, dims, out_hw in (
                (64, 256, [(60, 250), (64, 256), (40, 130)], (64, 256)),
                (208, 208, [(200, 200), (190, 196)], (200, 200)),
                (384, 512, [(380, 500), (384, 512), (200, 260)], (384, 512))):
            args = coef_case(dims, ch, cw, fh, fw, seed=fh * 10 + fw, pad_to=4)
            got = jpeg_kernels.decode_coefs(*args, fh, fw, out_hw)
            want = decode_ycbcr(*args, fh=fh, fw=fw, out_h=out_hw[0],
                                out_w=out_hw[1])
            torch.cuda.synchronize()
            err = max_err(got, want, dims)
            b1_err = max(b1_err, err)
            if err > LSB_LIMIT:
                fail(f"B1 {fh}x{fw} {ch}x{cw}: {err} LSB")
    big_dims = [(3000, 4000)] * 6 + [(2000, 3000), (3072, 4096)]
    big = coef_case(big_dims, H, W, 2, 2, seed=7)
    got = jpeg_kernels.decode_coefs(*big, 2, 2, (H, W))
    want = decode_ycbcr(*big, fh=2, fw=2)
    err = max_err(got, want, big_dims)
    b1_err = max(b1_err, err)
    if err > LSB_LIMIT:
        fail(f"B1 8x3072x4096 4:2:0: {err} LSB")
    log(f"[3 B1] 12 cases x 4 modes + 8x3072x4096 4:2:0: max |kernel - "
        f"plain| = {b1_err} LSB (limit {LSB_LIMIT})")

    # ---- 4. B2 vs plain
    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.integers(0, 256, (B, 3, H, W), dtype=np.uint8)).cuda()
    src_hw = np.array([[3000, 4000]] * 5 + [[4000, 3000], [1080, 1920],
                                              [480, 640]], np.int64)

    def resize_hw(hw, width=1024, height=768):
        return np.array([[max(keep_aspect_dims(w, h, width, height)[1], 1),
                          max(keep_aspect_dims(w, h, width, height)[0], 1)]
                         for h, w in hw], np.int64)

    crop_yx, crop_hw = fr.center_crop_windows(src_hw)
    taps_r = fr.make_taps(src_hw, resize_hw(src_hw), (768, 1024), (H, W)).to("cuda")
    taps_t = fr.make_taps(src_hw, np.full((B, 2), 200), (200, 200), (H, W),
                          crop_yx, crop_hw).to("cuda")
    aspect = np.array([[200, 266]] * 5 + [[266, 200], [200, 355], [200, 266]])
    taps_a = fr.make_taps(src_hw, aspect, (384, 384), (H, W)).to("cuda")
    b2_err = 0
    for ta, tb in ((taps_t, taps_r), (taps_a, taps_r), (None, taps_a)):
        got = fr.fused_resample(src, ta, tb)
        for g, t in zip(got, (ta, tb)):
            if t is not None:
                err = int((g.int() - fr.resample_plain(src, t).int()).abs().max())
                b2_err = max(b2_err, err)
    if b2_err > LSB_LIMIT:
        fail(f"B2: {b2_err} LSB")
    log(f"[4 B2] crop + aspect thumbnails, resize incl. 480x640 upscale: max "
        f"|kernel - plain| = {b2_err} LSB (limit {LSB_LIMIT})")

    # ---- 5. the main path through the worker's steps
    sources = [(photo(3000, 4000, s), True) for s in range(8)]
    sources += [(photo(1080, 1920, 8), True), (photo(480, 640, 9), True),
                (photo(1200, 1600, 10), False)]        # last: 4:4:4
    t0 = time.monotonic()
    blobs = [jpeg(img, sub) for img, sub in sources]
    log(f"[5 main] {len(blobs)} originals encoded on the host in "
        f"{time.monotonic() - t0:.1f} s")

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke-",
                               dir=os.path.join(REPO, "build"))
    store = LocalFSObjectStore(os.path.join(workdir, "objects"))
    meta = SQLiteMetadataStore(os.path.join(workdir, "meta.db"))
    broker = MemoryBroker()
    broker.create_topic(KAFKA_TOPIC_PROCESSING, 3)
    engine = TorchProcessingEngine(store, device="cuda", batch_size=B)
    try:
        default_ops = [   # service default for an upload with no flags
            OperationParams(OperationType.THUMBNAIL, {"size": 200, "crop_to_fit": True}),
            OperationParams(OperationType.RESIZE, {"width": 1024, "height": 768,
                                                   "keep_aspect": True})]
        image_ids = []
        for k, blob in enumerate(blobs):
            path = store.save_original(f"upload{k}.jpg", blob, "image/jpeg")
            image_id = str(uuid.uuid4())
            meta.save_image(Image(id=image_id, original_filename=f"upload{k}.jpg",
                                  original_size=len(blob), mime_type="image/jpeg",
                                  status=ImageStatus.PROCESSING,
                                  original_path=path, bucket="images"))
            task = ProcessingTask(id=str(uuid.uuid4()), image_id=image_id,
                                  original_path=path, bucket="images",
                                  operations=default_ops, format="jpeg")
            broker.produce(KAFKA_TOPIC_PROCESSING, image_id.encode(), task.to_json())
            image_ids.append(image_id)

        msgs = broker.poll(KAFKA_TOPIC_PROCESSING, KAFKA_GROUP_ID,
                           max_n=len(blobs), lease_s=600)
        if len(msgs) != len(blobs):
            fail(f"polled {len(msgs)} of {len(blobs)} tasks")
        tasks = [ProcessingTask.from_json(m.value) for m in msgs]
        work = [(t, store.get_object(t.original_path)) for t in tasks]

        jpeg_kernels.launches = 0
        fr.launches = 0
        t0 = time.monotonic()
        results = engine.process_tasks(work)
        wall = time.monotonic() - t0
        launches = {"B1": jpeg_kernels.launches, "B2": fr.launches}

        for msg, task, res in zip(msgs, tasks, results):
            for art in res.artifacts:
                meta.save_processed_image(ProcessedImage(
                    id="", image_id=task.image_id, operation=art.operation,
                    path=art.path, size=art.size, mime_type=art.mime_type,
                    format=art.format, status="completed"))
            meta.update_status(task.image_id, res.result.status)
            broker.ack(msg)
        log(f"[5 main] process_tasks: {len(work)} tasks in {wall:.3f} s "
            f"(host clock, scan + device + encode); launches {launches}")
        if any(v == 0 for v in launches.values()):
            fail(f"a kernel of the main path never launched: {launches}")

        by_id = {t.image_id: (t, r) for t, r in zip(tasks, results)}
        for k, image_id in enumerate(image_ids):
            task, res = by_id[image_id]
            if meta.get_image(image_id).status is not ImageStatus.COMPLETED:
                fail(f"task {k}: {res.result.status} {res.result.error}")
            rows = {p.operation.value if hasattr(p.operation, "value")
                    else p.operation for p in meta.list_processed(image_id)}
            if rows != {"thumbnail", "resize"}:
                fail(f"task {k}: processed rows {rows}")
            _, h, w = sources[k][0].shape
            tw, th = keep_aspect_dims(w, h, 1024, 768)
            for op, want_wh in (("thumbnail", (200, 200)), ("resize", (tw, th))):
                data = store.get_object(res.result.processed_paths[op])
                got_wh = hostcodec.scan_jpeg_coefficients(data)[2]
                if tuple(got_wh) != want_wh:
                    fail(f"task {k} {op}: {got_wh} != {want_wh}")
        log(f"[5 main] all {len(image_ids)} tasks COMPLETED, rows written, "
            "artifact dims 200x200 and Go keep-aspect resize dims")

        # group outputs: kernels vs plain versions, small images vs oracle
        plan = normalize_operations(default_ops)
        items = []
        for k, (task, data) in enumerate(work):
            arr, _fmt, layout, hw, _ = engine.decode_for_plan_ex(data, plan)
            items.append(BatchItem(item_id=str(k), image=arr,
                                   plan_key=plan.group_key(),
                                   payload=(k, task, "jpeg", plan),
                                   layout=layout, valid_hw=hw))
        main_err = 0
        oracle_psnr = []
        for group in group_items(items, max_batch=B):
            _, outs, out_hws, _ = engine.device_group(group)
            packed, ghw = group.pack(pad_batch_to=outs[0].shape[0])
            fh, fw = int(group.layout[5]), int(group.layout[6])
            dec = decode_ycbcr(*(torch.from_numpy(a).cuda() for a in packed),
                               fh=fh, fw=fw, out_h=group.bucket[0],
                               out_w=group.bucket[1])
            cy, chw = fr.center_crop_windows(ghw)
            plain_t = fr.resample_plain(dec, fr.make_taps(
                ghw, np.full((len(ghw), 2), 200), (200, 200), group.bucket,
                cy, chw).to("cuda")).cpu().numpy()
            plain_r = fr.resample_plain(dec, fr.make_taps(
                ghw, out_hws[1], (768, 1024), group.bucket).to("cuda")).cpu().numpy()
            for i, it in enumerate(group.items):
                oh, ow = out_hws[1][i]
                pairs = ((outs[0][i], plain_t[i]),
                         (outs[1][i][:, :oh, :ow], plain_r[i][:, :oh, :ow]))
                for a, b in pairs:
                    main_err = max(main_err, int(np.abs(a.astype(int) - b.astype(int)).max()))
                h, w = it.hw
                if h * w <= 1920 * 1080:
                    rgb = dec[i, :, :h, :w].permute(1, 2, 0).cpu().numpy()
                    for a, ref in ((outs[0][i], oracle.thumbnail_go(rgb, 200, crop_to_fit=True)),
                                   (outs[1][i][:, :oh, :ow],
                                    oracle.resize_go(rgb, 1024, 768, keep_aspect=True))):
                        a = a.transpose(1, 2, 0)
                        if np.abs(a.astype(int) - ref.astype(int)).max() > LSB_LIMIT:
                            fail(f"group {group.bucket}: output vs oracle > 1 LSB")
                        oracle_psnr.append(oracle.psnr(a, ref))
        if main_err > LSB_LIMIT:
            fail(f"main-path group outputs vs plain: {main_err} LSB")
        log(f"[5 main] group outputs vs plain versions: {main_err} LSB; "
            f"small images vs float64 Go oracle: <= {LSB_LIMIT} LSB, min PSNR "
            f"{min(oracle_psnr):.2f} dB")

        # a second, warm run of the same tasks: host-clock throughput and
        # the engine's own stage timings (scan pool, device per group,
        # encode pool per group)
        METRICS.reset()
        t0 = time.monotonic()
        rerun = engine.process_tasks(work)
        warm = time.monotonic() - t0
        if any(r.result.status is not ImageStatus.COMPLETED for r in rerun):
            fail("warm rerun did not complete")
        stages = METRICS.snapshot()["timings"]
        log(f"[5 main] warm rerun: {len(work)} images in {warm:.3f} s = "
            f"{len(work) / warm:.2f} images/s (host clock); " + "; ".join(
                f"{k} n={v['count']} max={v['max']} p50={v['p50']}"
                for k, v in sorted(stages.items()) if k.startswith("engine_")))
    finally:
        engine.close()
        meta.close()
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- 6. timing at 8 x 3072 x 4096
    # big: random canvases; src/taps_r/taps_t: the default plan's outputs
    b1_ms = time_ms(lambda: jpeg_kernels.decode_coefs(*big, 2, 2, (H, W)))
    b1_plain = time_ms(lambda: decode_ycbcr(*big, fh=2, fw=2), iters=5)
    b2_ms = time_ms(lambda: fr.fused_resample(src, taps_t, taps_r))
    b2_plain = time_ms(lambda: (fr.resample_plain(src, taps_t),
                                fr.resample_plain(src, taps_r)), iters=5)
    step_ms = time_ms(lambda: fr.fused_resample(
        jpeg_kernels.decode_coefs(*big, 2, 2, (H, W)), taps_t, taps_r))
    log(f"[6 timing] {card}: B1 {b1_ms:.4f} ms (plain {b1_plain:.4f} ms), "
        f"B2 {b2_ms:.4f} ms (plain {b2_plain:.4f} ms) per 8x3072x4096 batch; "
        f"decode->resample step {step_ms:.4f} ms = "
        f"{B * 1000.0 / step_ms:.1f} images/s (CUDA events)")
    # one group's tap tables for the default plan, built on the host and
    # uploaded afresh for every group (the port keeps no cache of them)
    specs = plan_output_specs(plan)

    def taps() -> None:
        step_taps((H, W), src_hw, {1: resize_hw(src_hw)}, specs,
                  torch.device("cuda"))
        torch.cuda.synchronize()

    taps()
    t0 = time.perf_counter()
    for _ in range(50):
        taps()
    tap_ms = (time.perf_counter() - t0) * 1000.0 / 50
    log(f"[6 timing] {card}: tap tables of one 8-image default-plan group, "
        f"host build + upload: {tap_ms:.4f} ms (host clock)")
    log(f"[6 timing] {card}: main path process_tasks {len(work)} images: "
        f"first run {wall:.3f} s = {len(work) / wall:.2f} images/s, warm rerun "
        f"{warm:.3f} s = {len(work) / warm:.2f} images/s (host clock)")

    summary = {"kernels": [
        {"name": "jpeg_decode_b1", "route": "cuda",
         "source": "imageprocessor_tpu_torch/csrc/jpeg_decode.cu",
         "replaces": "imageprocessor_tpu/ops/pallas_jpeg.py:548",
         "launches": launches["B1"], "max_abs_err": max(b1_err, main_err),
         "ms": b1_ms, "plain_ms": b1_plain},
        {"name": "fused_resample_b2", "route": "cuda",
         "source": "imageprocessor_tpu_torch/csrc/fused_resample.cu",
         "replaces": "imageprocessor_tpu/ops/pallas_fused.py:591",
         "launches": launches["B2"], "max_abs_err": max(b2_err, main_err),
         "ms": b2_ms, "plain_ms": b2_plain},
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
