#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (imageprocessor_tpu_torch) once on one card.

Run from the repository root on a host with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile the kernels (csrc/*.cu, nvcc, sm_90a) and the host
   entropy-scan library from this checkout's sources;
3. B1      — the JPEG coefficient-decode kernel against its plain PyTorch
   version, all four subsamplings: mixed valid dims with pad rows (the
   200 rung on a 208 canvas among them), and the edges of its tiling and
   store widths — one MCU row at batch 1, one MCU column, a 16 x 528
   canvas (wider than one 256-wide tile, not a multiple of it), an out_w
   that is not a multiple of 8 (bytewise stores); then 8 x 3072 x 4096 in
   4:2:2, 4:4:0 and 4:2:0 (limit: 1 LSB inside each valid region; each
   case prints its error);
4. B2      — the fused resize+thumbnail kernel against its plain version,
   both thumbnail modes and an upscale (limit: 1 LSB);
5. main path — the worker's own steps on the default (empty-flag) upload
   plan: originals in a LocalFSObjectStore, ProcessingTask JSON on a
   MemoryBroker, TorchProcessingEngine.process_tasks, ProcessedImage rows
   in a SQLiteMetadataStore, ack. Eight seeded 3000 x 4000 q85 4:2:0
   JPEGs plus 1920 x 1080, 640 x 480 (an upscale) and a 4:4:4 source,
   all encoded with OpenCV. It checks every task COMPLETED, the
   artifacts' dims, that B0, B1 and B2 launched during the run, that the
   group outputs match the plain versions, and that the small images
   match the float64 Go oracle; a warm rerun reports host-clock
   throughput and the engine's stage times;
6. timing  — CUDA events after warm-up at 8 x 3072 x 4096: each kernel
   and its plain version, and the composed decode -> resample step; B1's
   and B2's bounds (bytes over 3.35 TB/s or FP32 operations over
   67 TFLOP/s, whichever is larger), what sets each, and each kernel's
   share of it; the host clock times one group's tap tables (build and
   upload);
7. B3      — the JPEG encode front half against its plain version: mixed
   valid dims with pad rows (64x256, 384x512, 208x208), the edges of its
   64 x 256 tiling — one MCU at batch 1, one MCU column, one MCU row, a
   16 x 528 canvas, valid dims of (1, 1), odd valid widths and heights,
   extents that end inside the first MCU of a tile — strided views read
   in place (row strides of 256 and of 200, the one ladder rung that is a
   multiple of 8 but not of 16) and a view with a row stride of 204
   (copied by the wrapper; the C entry point must refuse a misaligned
   base or stride), then 8 x 3072 x 4096 (limit: 1 quantization step
   inside each image's ceil16(valid) grid; each case prints its error
   and the count of coefficients that differ);
8. B4      — the single-op resample against its plain version: crop and
   aspect thumbnails, a downscale and an upscale resize (limit: 1 LSB);
9. form plans — the seven plans of the upload form (thumbnail, resize,
   watermark flags) through the worker's steps on phase 5's sources, with
   the splice on and with IMAGEPROCESSOR_JPEG_SPLICE=0, then a PNG and a
   GIF source with every flag. It checks every task COMPLETED, the
   artifacts' dims, that a watermark artifact differs from its
   unwatermarked twin inside the text box and nowhere else (the source
   itself when spliced; the same path with a blank text otherwise), the
   launch counts of each plan (B2 on the thumbnail+resize pair, B4 on a
   lone resample, B3 only where a watermark is blended on the device,
   none with the splice on), and that the group outputs match the plain
   versions; each plan's line carries the engine's stage times;
10. timing — CUDA events at 8 x 3072 x 4096: B3 and B4 (resize to
   1024 x 768) and their plain versions, the blend, and the composed
   splice-off step B1 -> B2 -> blend -> B3; B3's and B4's bounds and
   shares as in phase 6;
11. transform plans — crop (an MCU-aligned origin and an unaligned one),
   flip (both directions), rotate (90, 180, 270 and 30 degrees),
   grayscale, and a mixed plan (thumbnail + resize + grayscale + crop)
   through the worker's steps on phase 5's sources, with the splice on
   (crop, flip and the rotations by 90s come from the scanned
   coefficients on the host: no device work; rotate 30 and grayscale run
   on the device) and with IMAGEPROCESSOR_JPEG_SPLICE=0 (everything on
   the device), then a PNG source with every op. It checks every task
   COMPLETED, the artifacts' dims (a crop clamped to its image, 90 and
   270 swapped), the launch counts (B1 once per device group, B3 exactly
   on the grayscale and flip groups, B2 on the mixed plan, none on an
   all-coefficient plan) and the group's device outputs against numpy on
   B1's decoded bucket: 0 LSB for crop, flip and the rotations by 90s
   (slices, [::-1], np.rot90 on each valid region) and for grayscale
   against the float32 formula of ops/extra.py evaluated by numpy
   (<= 1 LSB against Go's integer formula in int64, whose differing
   pixels are counted); rotate 30 within 1 LSB of a float64 inverse map,
   except at pixels whose source coordinate lies within 1e-3 of the
   +-0.5 validity boundary, which are counted and printed. B3's
   canvases of a grayscale or flip group are within 1 step of the plain
   encode of the same canvas. A coefficient-route artifact, decoded by
   the float64 decoder of runtime/splice.py, equals the same transform
   of the decoded source wherever the primitives are lossless (no
   ``_rs``; a crop away from its edges);
12. single image — process_single on one 12 MP JPEG with all seven ops:
   B4 launches twice (resize, thumbnail), every artifact has the batched
   path's dims and PSNR > 45 dB against it (the engine tests' contract
   for JPEG artifacts; the two paths decode the source with different
   IDCTs and encode with different encoders); a PNG source through both
   paths with PNG renditions: crop, flip, rotate and grayscale equal,
   the resamples and the watermark within 1 LSB;
13. timing — CUDA events at 8 x 3072 x 4096: each batched op of
   ops/extra.py and the composed grayscale step B1 -> grayscale -> B3;
   the host clock of the coefficient route per 12 MP image, by op (scan,
   transform, re-encode);
14. entry point — ``python3 -m imageprocessor_tpu_torch.service standalone
   --data build/svc/... --port <free port>`` as a child process with no
   DEVICE_PLATFORM (it must find the card), and a second child with
   IMAGEPROCESSOR_JPEG_SPLICE=0. With the port's client.py: wait for
   GET /api/health; upload phase 5's eleven sources and a 640 x 480 PNG
   with no flags, one 12 MP source with all three flags and one with
   ``thumbnail`` only (first child), one with ``watermark`` only (second
   child: device blend, kernel B3); poll every status to ``completed``;
   GET every original (byte round trip) and every rendition and check
   its dims; hold the thumbnail and resize of every source up to
   1920 x 1080 to the float64 Go oracle on the host-decoded source
   (<= 1 LSB for the PNG source's lossless renditions; PSNR > 32 dB for a
   JPEG source's q85 renditions, whose pre-encode pixels phase 5 holds to
   1 LSB); require that /api/metrics' engine_device_images rose by the
   number of uploads; DELETE one (204, then 404); SIGTERM after the last
   status and require exit code 0 of both children;
15. both workers — build_app plus ``Worker``, then ``PipelinedWorker``, in
   process on shared MemoryBroker / localfs / SQLite, the same uploads
   over HTTP with every launch count set to 0 just before and read once
   the queue is empty: B1, B2, B3 and B4 must each have launched under
   each worker. The two workers' artifacts of one upload: the spliced
   watermark byte-identical (host code on the source's coefficients),
   every other rendition <= 1 LSB after decoding. Before that, the
   failure policy on the card, queued before the worker starts: an
   upload whose blob is deleted -> failed, acked, worker_fetch_missing; a
   truncated JPEG -> failed, acked, worker_failed_permanent; a
   torch.OutOfMemoryError raised out of device_group once -> nacked,
   redelivered and completed, worker_failed_transient;
16. latency — the reference bench's latency run on the port, through the
   port bench's ``bench_latency``: 60 uploads of a 480 x 640 JPEG with a
   3000 x 4000 one every tenth, default plan, batch_size 16,
   batch_deadline_ms 25, arrivals at 200/s through
   ImageUsecase.upload_image -> MemoryBroker -> worker, latency from
   produce to the results topic, after a warm-up of each bucket and batch
   size. It prints p50, p95, p99 and images/s for the batch worker and
   for the pipelined worker with queue_wait_ms, batcher_wait_ms,
   span_{decode,pack,device,encode}_ms
   beside them, then repeats the pipelined run under
   utils/tracing.profile_capture and prints the share of the window in
   which the card ran a kernel or a copy. Nothing is asserted about the
   values;
17. bench — ``python3 -m imageprocessor_tpu_torch.bench`` as a child
   process with no DEVICE_PLATFORM, at full shapes, with a time limit: it
   must exit 0 and print as its last line one JSON object with every key
   the bench documents (``bench.KEYS``), platform "cuda",
   psnr_db_vs_oracle above 45 dB and device_splice_step_images_per_sec
   within 25 % of phase 6's decode -> resample step (both time B1 -> B2
   with CUDA events); the line is printed. The child's launch counts stay
   in its process, so the bench's splice-off step
   (bench_device_jpeg_step, B1 -> B2 -> blend -> B3) and its PSNR check
   (B4) then run in process at the --smoke shape, with every launch count
   set to 0 before and read after: B1, B2, B3 and B4 must each launch;
18. topology — the reference's deployment (deploy/docker-compose.kafka.yaml,
   its ``x-backend-env`` pointed at servers on this host): ``python3 -m
   imageprocessor_tpu_torch.service kafkaserver`` as a child
   (BROKER_PARTITIONS=3), an S3 stub in this script (every request must be
   SigV4-signed) and tests/pg_stub.py's Postgres server (SCRAM) in
   process, the ``api`` entry point as a child over HTTP, and two workers
   of the one consumer group on the card: the ``worker`` entry point as a
   child and a PipelinedWorker in process (the launch counts are per
   process: they are set to 0 just before it starts and read after pass
   b). The bench's latency mix (60 uploads through POST
   /api/images/upload, a 480 x 640 JPEG with a 3000 x 4000 one every
   tenth, default plan; WORKER_BATCH_SIZE 16, WORKER_BATCH_DEADLINE_MS 25)
   in two passes: (a) backlog — all 60 queued before the worker child
   starts, the in-process worker joining after the child's first
   completion (the group must split); (b) arrivals at up to 200/s, the
   worker child sent SIGTERM after 30 (exit code 0; the survivor takes
   over its partitions after the rebalance). Then three seeded PNG
   uploads (480 x 640, 1080 x 1920, 3000 x 4000) whose thumbnail and
   resize must sit within 1 LSB of the float64 Go oracle. It fails unless
   every upload is ``completed``, every processed row points at an object
   the S3 stub holds, the results topic carries exactly one completion per
   task (read back over the wire), the processing topic's depth for the
   group is 0, B1 and B2 launched in process, kafkawire checks record
   batches with the host library's CRC-32C, and the ``api`` and
   ``kafkaserver`` children exit 0 on SIGTERM. It prints (a)'s drain time,
   (b)'s p50/p99 upload -> completion on image-processed, the rebalance
   gap and the launches, each beside the card's name and power limit;
19. routes and replicas — phase 5's sources with the default plan and a
   flip plan, IMAGEPROCESSOR_JPEG_SPLICE=0. (a) An engine built with
   IMAGEPROCESSOR_DEVICE_JPEG=0 takes every JPEG through the host decoder
   (layout "hwc"): B1 and B3 must launch 0 times, B2 must launch on the
   default plan, and its thumbnail and resize of the sources up to
   1920 x 1080 must sit within 1 LSB of the float64 Go oracle on the
   host-decoded pixels; the warm engine_images_per_sec with 0 and unset
   is printed side by side with the host's usable cores. (b) The host
   library's coef_rot_i16 equals runtime/coeftx.py's numpy path bit for
   bit on a 12 MP luma plane in all three modes, and the rot90 transform
   of one 12 MP JPEG is timed with the native pass and the numpy path.
   (c) A Worker asked for DEVICE_DATA_AXIS above the card count raises
   naming the variable; an engine with two replicas on cuda:0 (two
   streams, two threads, each group whole on one) gives the one-replica
   engine's artifacts byte for byte, each replica having run groups;
   with two cards or more, so does data_axis=2 over two cards, each
   card's launches counted (else one line says it was skipped);
21. staging — one group of 32 3000 x 4000 q85 uploads (eight seeded
   photos, four times each) with the default plan through the engine's
   device stage by both paths, in turns: the staged path (each upload's
   entropy-coded bytes staged in a reused page-locked slab, copied to the
   card and decoded there by kernel B0 into the group's canvases) and the
   packed path (the host scan's planes in Group.pack's host canvases, then
   pageable copies), each on fresh uploads after a warm call. Kernel
   B1's operands and the group's outputs must be byte-identical, every
   stream byte of the staged path must come from a slab
   (engine_h2d_pinned_bytes, no engine_stage_pool_misses). It prints each
   path's pack time, its H2D rate (engine_h2d_bytes over the h2d spans),
   its device span and its peak card memory above the allocation before;
22. the group — the benchmark's cell kafka-topology.camera12mp-backlog
   (perfbench/, in process through ``harness.run_cell``, a 10 s window)
   on three seeds: two PipelinedWorker members of image-processor-group
   on the ``kafkaserver`` child, 3-partition topics. Each run must be
   ``correct`` against perfbench/reference.py, the child must exit 0,
   and the group is held to perfbench/group_reference.py: each member's
   partitions are ``range_assign`` of the members' ids, and every judged
   upload was completed once, by ``owner`` of its key. It prints each
   run's rate, the completions by member and the count misrouted;
23. entropy — kernel B0 on eight of perfbench's 3000 x 4000 camera
   originals: one group of 32 (the eight four times) and groups of one,
   each upload's canvases bit-exact against the host scan's planes and
   every status 0. It prints B0's time per upload in each (wall time of
   the wrapper's call on zeroed canvases, its waits for the sync counter
   and the status included), its sync rounds, the host scan's time per
   upload on one thread, the plain version's, and B0's least bytes (the
   stream read once, and written once the 32-byte sectors that hold a
   block's DC or a non-zero coefficient, counted from the host scan's
   planes) at 3.35 TB/s.

Where the checks rebuild kernel B1's input with ``Group.pack`` (phases 5,
11, 21), an upload that B0 decodes on the card is packed from its host
scan (``host_planes``): those checks hold B0 too. Every phase that serves
baseline JPEGs on the card through the engine (5, 9, 11, 15, 18, 19, 21,
22) counts B0's launches beside the others' and fails where B0 never
launched or ``engine_card_entropy_fallbacks`` is above 0; the routes that
keep the host scan (the splice, the device-JPEG switch off, phase 12's
single-image path, phase 17's bench steps on host-scanned planes) must
not launch it.

B2's and B4's bounds are counted twice: by the bytes their taps touch,
and by the 32-byte sectors those bytes lie in (the card's memory moves
whole sectors; a bucket row is 4096 bytes, so a sector is col // 32).
The sector count is the bound; the byte count is printed beside it.

The watermark's font is the reference's lookup (IMAGEPROCESSOR_FONT, the
reference package's assets/fonts, matplotlib's DejaVu Sans); where none
of those exists, phase 1 (the bench's ``ensure_font``) points
IMAGEPROCESSOR_FONT at a TrueType font found on the host, or at Pillow's
bundled default font written under build/, and prints which. Device
times come from the bench's ``time_ms`` (CUDA events on a busy stream).

The line before the last is the card's name and power limit as
nvidia-smi gives them, the one before it a JSON summary of the kernels
(launches on the main paths, phase 15's HTTP uploads, phase 17's bench
steps, phase 18's Kafka tasks and the runs of phases 19, 21 and 22 among them, max
error, ms, plain_ms, bound_ms, bound_by,
roofline_share, byte_bound_ms, and library_ms: null, since no single
PyTorch call computes any of the four functions; B0's row gives its ms
and plain_ms per 12 MP upload from phase 23, its byte bound, its launches
by phase and the host scan's ms beside them); the last line is
{"ok": true, "device": {...}}. Only imageprocessor_tpu_torch
is imported: neither jax nor the reference package imageprocessor_tpu.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import uuid

import numpy as np
import torch
from PIL import Image as PILImage

REPO = os.path.dirname(os.path.abspath(__file__))
B, H, W = 8, 3072, 4096          # the main path's 12 MP group
LSB_LIMIT = 1
STEP_LIMIT = 1                   # B3: quantization steps
WM_MARGIN = 32                   # px past the text box a watermark may touch
SINGLE_PSNR_DB = 45.0            # single-image vs batched JPEG artifacts (phase 12)
BENCH_PSNR_DB = 45.0             # the bench's resample against the Go oracle (phase 17)
HBM_BYTES_S = 3.35e12            # H100 SXM device memory, bytes/s (data sheet)
FP32_FLOP_S = 67e12              # H100 SXM FP32 outside the tensor cores
MODES = ((2, 2), (1, 2), (2, 1), (1, 1))   # 4:2:0, 4:2:2, 4:4:0, 4:4:4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def max_err(a: torch.Tensor, b: torch.Tensor, dims) -> int:
    """Max |a - b| over each image's valid (h, w) region."""
    return max(int((a[i, :, :h, :w].int() - b[i, :, :h, :w].int()).abs().max())
               for i, (h, w) in enumerate(dims))


def bound(nbytes: float, flop: float) -> dict:
    """The least time the card could take (ms) for work that must move
    `nbytes` and compute `flop` FP32 operations, and which of the two
    sets it."""
    t_bytes, t_flop = nbytes / HBM_BYTES_S * 1e3, flop / FP32_FLOP_S * 1e3
    return {"ms": max(t_bytes, t_flop), "nbytes": nbytes, "flop": flop,
            "by": "bytes" if t_bytes >= t_flop else "operations"}


def bound_line(name: str, ms: float, b: dict) -> str:
    line = (f"{name} bound {b['ms']:.4f} ms, set by {b['by']} ({b['nbytes'] / 1e6:.1f} MB "
            f"at {HBM_BYTES_S / 1e12:.2f} TB/s; {b['flop'] / 1e9:.2f} GFLOP at "
            f"{FP32_FLOP_S / 1e12:.0f} TFLOP/s FP32); share of bound "
            f"{b['ms'] / ms:.3f}")
    if "byte" in b:   # a resample: the sector count above, the byte count here
        line += (f"; counted in 32-byte sectors. By touched bytes alone: "
                 f"{b['byte']['ms']:.4f} ms ({b['byte']['nbytes'] / 1e6:.1f} MB), "
                 f"share {b['byte']['ms'] / ms:.3f}")
    return line


def b1_bound(args, fh: int, fw: int, out_hw) -> dict:
    """B1: every coefficient canvas, table and extent read once, the RGB
    bucket written once. FP32 operations: per coefficient, dequantize and
    clamp (3), the two even/odd 8-point passes (16) and the level shift
    (1), plus the [0, 255] clamp (2) of chroma that is upsampled; per
    pixel, BT.601 with the chroma offsets (13), round and clip (6), and
    per subsampled plane the fancy upsample's taps (2 per chroma sample of
    a luma row vertically, 2 per pixel horizontally)."""
    yc, cbc = args[0], args[1]
    coefs = yc.numel() + 2 * cbc.numel()
    px = yc.shape[0] * out_hw[0] * out_hw[1]
    up = 2 * ((2 / fw if fh == 2 else 0) + (2 if fw == 2 else 0))
    clamp = 4 * cbc.numel() if fh * fw > 1 else 0
    nbytes = sum(a.numel() * a.element_size() for a in args) + 3 * px
    return bound(float(nbytes), 20.0 * coefs + clamp + (19 + up) * px)


def b3_bound(rgb, valid) -> dict:
    """B3, for this batch's valid extents: each valid RGB pixel read once,
    each coefficient of the ceil16(valid) grid written once (3 bytes per
    pixel); per pixel the colour conversion (17 operations) and box mean
    (2), per coefficient the level shift, two 8-point passes and the
    quantization (34)."""
    h, w = rgb.shape[2:]
    vh = np.clip(valid[:, 0].cpu().numpy().astype(np.int64), 1, h)
    vw = np.clip(valid[:, 1].cpu().numpy().astype(np.int64), 1, w)
    grid = (-(-vh // 16) * 16 * (-(-vw // 16) * 16)).sum()
    nbytes = 3 * (vh * vw).sum() + 3 * grid + 2 * 64 * 4 + valid.numel() * 4
    return bound(float(nbytes), (19 + 34 * 1.5) * float(grid))


def resample_bound(taps_list) -> dict:
    """B2 / B4: the source that the taps of the outputs touch, read once
    (per image, the union of the outputs' row x column grids), the tap
    tables, and every output written once; 11 operations per output
    sample (three lerps, the xdraw quantization).

    The source is counted in the 32-byte sectors the card's memory moves:
    per touched row and plane, the distinct sectors its touched columns
    lie in (a bucket row is 4096 bytes from an aligned base, so a
    column's sector is col // 32). That is the bound. The count of the
    touched bytes alone, which no kernel can fetch without their
    sectors, is returned under "byte"."""
    def grid(t, i):
        return (set(np.concatenate([t.r0[i].cpu().numpy(), t.r1[i].cpu().numpy()]).tolist()),
                set(np.concatenate([t.c0[i].cpu().numpy(), t.c1[i].cpu().numpy()]).tolist()))

    touched = sectors = 0
    for i in range(taps_list[0].r0.shape[0]):
        grids = [grid(t, i) for t in taps_list]
        # rows by the set of grids that touch them: such a row needs the
        # union of those grids' columns
        members: dict[int, int] = {}
        for k, (rows, _cols) in enumerate(grids):
            for r in rows:
                members[r] = members.get(r, 0) | (1 << k)
        for mask in set(members.values()):
            n_rows = sum(1 for m in members.values() if m == mask)
            cols = set().union(*(c for k, (_r, c) in enumerate(grids)
                                 if mask >> k & 1))
            touched += n_rows * len(cols)
            sectors += n_rows * len({c // 32 for c in cols})
    outs = sum(3 * t.r0.shape[0] * t.shape[0] * t.shape[1] for t in taps_list)
    tables = sum(x.numel() * x.element_size() for t in taps_list
                 for x in (t.r0, t.r1, t.fy, t.c0, t.c1, t.fx))
    b = bound(3.0 * 32 * sectors + outs + tables, 11.0 * outs)
    b["byte"] = bound(3.0 * touched + outs + tables, 11.0 * outs)
    return b


def b1_cases(fh: int, fw: int) -> dict:
    """tag -> (canvas h, w, valid dims, out_hw, pad rows to) of phase 3,
    for an MCU of 8 fh x 8 fw: mixed valid dims with pad rows (the 200
    rung on a 208 canvas among them), then the edges of B1's tiling and
    store widths (tests/test_torch_gpu.py b1_shapes)."""
    mh, mw = 8 * fh, 8 * fw
    return {
        "64x256": (64, 256, [(60, 250), (64, 256), (40, 130)], (64, 256), 4),
        "w200": (208, 208, [(200, 200), (190, 196)], (200, 200), 4),
        "384x512": (384, 512, [(380, 500), (384, 512), (200, 260)], (384, 512), 4),
        "mcu_row_b1": (mh, 256, [(mh - 1, 250)], (mh, 256), 0),
        "mcu_col": (64, mw, [(61, mw - 1), (64, mw)], (64, mw), 0),
        "w528": (16, 528, [(16, 528), (13, 517)], (16, 528), 0),
        "out_w_odd": (64, 528, [(61, 523), (50, 200)], (61, 523), 0),
    }


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


def rgb_case(dims, h, w, seed, pad_to=0):
    """Seeded (B, 3, h, w) u8 canvases and valid dims; pad rows get (1, 1)
    the way the engine passes them to B3."""
    rng = np.random.default_rng(seed)
    b = max(len(dims), pad_to)
    rgb = torch.from_numpy(rng.integers(0, 256, (b, 3, h, w), dtype=np.uint8)).cuda()
    vh = np.ones((b, 2), np.int32)
    vh[:len(dims)] = dims
    return rgb, torch.from_numpy(vh).cuda()


def b3_cases() -> dict:
    """tag -> (canvas h, w, valid dims, pad rows to, bucket) of phase 7:
    mixed valid dims with pad rows, then the edges of B3's 64 x 256 tiling
    (tests/test_torch_gpu.py b3_shapes). With a bucket (h, w) the canvas
    is the top-left view of an allocation of that size."""
    return {
        "64x256": (64, 256, [(60, 250), (64, 256), (40, 130)], 4, None),
        "384x512": (384, 512, [(380, 500), (384, 512), (200, 260)], 4, None),
        "208x208": (208, 208, [(200, 200), (190, 196)], 4, None),
        "mcu_b1": (16, 16, [(16, 16)], 0, None),
        "mcu_col": (64, 16, [(61, 15), (64, 16)], 0, None),
        "mcu_row": (16, 256, [(15, 250)], 0, None),
        "w528": (16, 528, [(16, 528), (13, 517)], 0, None),
        "valid_1x1": (64, 256, [(1, 1), (1, 1)], 0, None),
        "odd_vw": (80, 528, [(80, 261), (64, 7), (34, 527)], 0, None),
        "odd_vh": (80, 528, [(61, 272), (7, 256), (79, 512)], 0, None),
        "tile_first_mcu": (128, 528, [(70, 260), (65, 257), (128, 270)], 0, None),
        "view_aligned": (208, 208, [(200, 200), (190, 196), (1, 1)], 0, (224, 256)),
        "view_stride200": (192, 192, [(192, 192), (180, 185)], 0, (200, 200)),
        "view_stride204": (192, 192, [(192, 192), (180, 185)], 0, (200, 204)),
    }


def coef_err(got, want, dims) -> tuple[int, int]:
    """(max quantization-step difference, count of coefficients that
    differ) over each image's ceil16(valid) grid of the three coefficient
    planes."""
    err = count = 0
    for a, b, div in zip(got, want, (1, 2, 2)):
        for i, (h, w) in enumerate(dims):
            gh, gw = -(-h // 16) * 16 // div, -(-w // 16) * 16 // div
            d = (a[i, :gh, :gw].int() - b[i, :gh, :gw].int()).abs()
            err, count = max(err, int(d.max())), count + int((d > 0).sum())
    return err, count


def text_box(wm, text: str, position: str, h: int, w: int):
    """(y0, y1, x0, x1): the glyphs' nonzero coverage on an h x w image."""
    tile = wm.rasterize_text(text, 36.0)
    bx, by = wm.anchor_baseline(position, w, h, tile)
    rows = np.flatnonzero(tile.coverage.any(axis=1))
    cols = np.flatnonzero(tile.coverage.any(axis=0))
    y0, x0 = int(by) - tile.ascent, int(bx)
    return (max(y0 + rows[0], 0), min(y0 + rows[-1] + 1, h),
            max(x0 + cols[0], 0), min(x0 + cols[-1] + 1, w))


# ---------------------------------------------------------------- the service

SVC_PSNR_DB = 32.0   # a q85 JPEG rendition against the oracle's pixels (phase 14)
KERNEL_KEYS = ("B0", "B1", "B2", "B3", "B4")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_until(done, what: str, timeout: float = 180.0, interval: float = 0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = done()
        if got:
            return got
        time.sleep(interval)
    fail(f"timed out after {timeout:.0f} s waiting for {what}")


def png(img: np.ndarray) -> bytes:
    """Lossless PNG of a planar RGB image."""
    bio = io.BytesIO()
    PILImage.fromarray(np.ascontiguousarray(img.transpose(1, 2, 0))).save(
        bio, format="PNG")
    return bio.getvalue()


def image_size(data: bytes) -> tuple[int, int]:
    """(width, height) of an encoded image."""
    return PILImage.open(io.BytesIO(data)).size


def kernel_counters():
    from imageprocessor_tpu_torch.ops import fused_resample as fr
    from imageprocessor_tpu_torch.ops import jpeg_entropy, jpeg_kernels
    from imageprocessor_tpu_torch.ops import planar_resample as pr

    return {"B0": (jpeg_entropy, "launches"), "B1": (jpeg_kernels, "launches"),
            "B2": (fr, "launches"), "B3": (jpeg_kernels, "encode_launches"),
            "B4": (pr, "launches")}


def entropy_counts() -> dict:
    """The engine's B0 counters in this process since METRICS' last reset:
    uploads B0 decoded, and uploads it flagged."""
    from imageprocessor_tpu_torch.utils.metrics import METRICS

    c = METRICS.snapshot()["counters"]
    return {k: int(c.get(f"engine_card_entropy_{k}", 0))
            for k in ("uploads", "fallbacks")}


def require_card_entropy(what: str, launched: int, got: dict) -> None:
    """Fail unless B0 launched and flagged no upload (``entropy_counts``)."""
    if launched == 0 or got["uploads"] == 0 or got["fallbacks"]:
        fail(f"{what}: B0 launches {launched}, {got}")


def host_planes(group):
    """``group`` with each upload kernel B0 decodes on the card carrying
    its host scan's planes and tables instead, which ``Group.pack``
    packs: the checks that rebuild B1's input from the host then hold
    B0's canvases too."""
    from dataclasses import replace

    from imageprocessor_tpu_torch.runtime.batcher import Group
    from imageprocessor_tpu_torch.runtime.engine import CardUpload

    return Group(group.bucket, group.plan_key, [
        replace(it, image=it.image.host_scan())
        if isinstance(it.image, CardUpload) else it for it in group.items])


def uploads_of(blobs, png_blob):
    """name -> (filename, bytes, mime, form flags, splice) of the service
    phases: the eleven sources with no flags (the default pair), a PNG
    source, one 12 MP source with all three flags, one thumbnail-only,
    and one watermark-only that is served with IMAGEPROCESSOR_JPEG_SPLICE=0
    (the device blend and kernel B3)."""
    ups = {f"default{k}": (f"upload{k}.jpg", blob, "image/jpeg", {}, True)
           for k, blob in enumerate(blobs)}
    ups["png"] = ("small.png", png_blob, "image/png", {}, True)
    ups["all_flags"] = ("all.jpg", blobs[0], "image/jpeg",
                        {"thumbnail": "true", "resize": "true", "watermark": "true"},
                        True)
    ups["thumb_only"] = ("thumb.jpg", blobs[1], "image/jpeg",
                         {"thumbnail": "true"}, True)
    ups["mark_device"] = ("mark.jpg", blobs[2], "image/jpeg",
                          {"watermark": "true"}, False)
    return ups


def expected_dims(flags: dict, src_wh, keep_aspect_dims) -> dict:
    """operation -> (width, height) of each rendition of one upload."""
    w, h = src_wh
    ops = [k for k in ("thumbnail", "resize", "watermark") if flags.get(k)] \
        or ["thumbnail", "resize"]
    return {op: {"thumbnail": (200, 200), "watermark": (w, h),
                 "resize": tuple(keep_aspect_dims(w, h, 1024, 768))}[op]
            for op in ops}


def check_against_oracle(oracle, decode_image, name, src_blob, thumb, resized,
                         exact: bool):
    """Thumbnail and resize renditions against the float64 Go oracle on
    the host-decoded source: <= 1 LSB for lossless (PNG) renditions, PSNR
    above SVC_PSNR_DB for q85 JPEG ones. Returns the two readings."""
    rgb = decode_image(src_blob)[0]
    out = []
    for op, data, ref in (
            ("thumbnail", thumb, oracle.thumbnail_go(rgb, 200, crop_to_fit=True)),
            ("resize", resized, oracle.resize_go(rgb, 1024, 768, keep_aspect=True))):
        got = decode_image(data)[0]
        if got.shape != ref.shape:
            fail(f"{name} {op}: {got.shape} != oracle {ref.shape}")
        if exact:
            err = int(np.abs(got.astype(int) - ref.astype(int)).max())
            if err > LSB_LIMIT:
                fail(f"{name} {op}: {err} LSB from the oracle")
            out.append(f"{op} {err} LSB")
        else:
            db = oracle.psnr(got, ref)
            if db < SVC_PSNR_DB:
                fail(f"{name} {op}: PSNR {db:.2f} dB against the oracle")
            out.append(f"{op} {db:.2f} dB")
    return out


def phase_entry_point(blobs, png_blob, oracle) -> None:
    """Phase 14: ``python -m imageprocessor_tpu_torch.service standalone``
    as a child process, driven over HTTP by the port's client."""
    import httpx

    from imageprocessor_tpu_torch.client import ClientError, ImageProcessorClient
    from imageprocessor_tpu_torch.ops.coords import keep_aspect_dims
    from imageprocessor_tpu_torch.runtime.codecs import decode_image

    root = os.path.join(REPO, "build", "svc")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "src"))
    ups = uploads_of(blobs, png_blob)
    for fname, data, *_ in ups.values():
        with open(os.path.join(root, "src", fname), "wb") as f:
            f.write(data)
    src_wh = {name: image_size(data) for name, (_f, data, *_r) in ups.items()}

    # two children, started together: the default environment, and one
    # with the splice off for the device-blended watermark. Neither gets a
    # DEVICE_PLATFORM: each must find the card or fail.
    children = {}
    for splice_on in (True, False):
        env = {k: v for k, v in os.environ.items() if k != "DEVICE_PLATFORM"}
        env["PYTHONPATH"] = REPO
        env["IMAGEPROCESSOR_JPEG_SPLICE"] = "1" if splice_on else "0"
        port = free_port()
        out = open(os.path.join(root, f"child-{int(splice_on)}.log"), "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "imageprocessor_tpu_torch.service", "standalone",
             "--data", os.path.join(root, f"data-{int(splice_on)}"),
             "--port", str(port)], cwd=REPO, env=env, stdout=out,
            stderr=subprocess.STDOUT)
        children[splice_on] = (proc, out, f"http://127.0.0.1:{port}")

    def tail(splice_on) -> str:
        with open(os.path.join(root, f"child-{int(splice_on)}.log"), "rb") as f:
            return f.read()[-3000:].decode(errors="replace")

    try:
        t0 = time.monotonic()
        for splice_on, (proc, _out, url) in children.items():
            def healthy(proc=proc, url=url, splice_on=splice_on):
                if proc.poll() is not None:
                    fail(f"the service exited with {proc.returncode} before it "
                         f"answered: {tail(splice_on)}")
                try:
                    return httpx.get(f"{url}/api/health", timeout=2).status_code == 200
                except httpx.TransportError:
                    return False
            wait_until(healthy, "GET /api/health", interval=0.2)
        log(f"[14 entry] two standalone services answer /api/health "
            f"{time.monotonic() - t0:.1f} s after they were started")

        readings = []
        t0 = time.monotonic()
        ids = {}
        clients = {on: ImageProcessorClient(url, timeout=120.0)
                   for on, (_p, _o, url) in children.items()}
        before = {on: c.metrics()["counters"].get("engine_device_images", 0)
                  for on, c in clients.items()}
        for name, (fname, _data, _mime, flags, splice_on) in ups.items():
            up = clients[splice_on].upload(
                os.path.join(root, "src", fname),
                **{k: v == "true" for k, v in flags.items()})
            ids[name] = up["id"]
        for name, (_f, data, _mime, flags, splice_on) in ups.items():
            c = clients[splice_on]
            status = c.wait(ids[name], timeout=180.0, poll_interval=0.05)
            if status != "completed":
                fail(f"upload {name}: status {status}: {tail(splice_on)}")
        wall = time.monotonic() - t0
        for name, (_f, data, _mime, flags, splice_on) in ups.items():
            c = clients[splice_on]
            if c.fetch(ids[name]) != data:
                fail(f"upload {name}: the original does not round-trip")
            got = {op: c.fetch(ids[name], operation=op)
                   for op in expected_dims(flags, src_wh[name], keep_aspect_dims)}
            dims = {op: image_size(d) for op, d in got.items()}
            want = expected_dims(flags, src_wh[name], keep_aspect_dims)
            if dims != want:
                fail(f"upload {name}: rendition dims {dims} != {want}")
            w, h = src_wh[name]
            if not flags and h * w <= 1920 * 1080:
                readings.append(f"{name} {w}x{h}: " + ", ".join(check_against_oracle(
                    oracle, decode_image, name, data, got["thumbnail"],
                    got["resize"], exact=name == "png")))
        log(f"[14 entry] {len(ups)} uploads over HTTP completed in {wall:.2f} s "
            f"(host clock, upload to last status), every rendition fetched with "
            f"the expected dims; against the float64 Go oracle on the "
            f"host-decoded source (PNG renditions <= {LSB_LIMIT} LSB, q85 JPEG "
            f"renditions PSNR > {SVC_PSNR_DB} dB): " + "; ".join(readings))

        for on, c in clients.items():
            m = c.metrics()["counters"]
            n = sum(1 for v in ups.values() if v[4] == on)
            rose = m.get("engine_device_images", 0) - before[on]
            # every plan here has at least one op that runs on the device
            if rose < n or m.get("worker_completed", 0) != n:
                fail(f"child splice={on}: engine_device_images rose by {rose}, "
                     f"worker_completed {m.get('worker_completed')} of {n}")
            if not on and m.get("engine_splice_images", 0):
                fail("the splice-off child spliced a watermark")
            log(f"[14 entry] child splice={'on' if on else 'off'}: "
                f"/api/metrics engine_device_images +{rose:.0f}, worker_completed "
                f"{m.get('worker_completed'):.0f}, engine_splice_images "
                f"{m.get('engine_splice_images', 0):.0f}")
        url = children[True][2]
        r = httpx.delete(f"{url}/api/images/{ids['default9']}", timeout=30)
        if r.status_code != 204:
            fail(f"DELETE answered {r.status_code}")
        codes = (httpx.get(f"{url}/api/images/{ids['default9']}/status",
                           timeout=30).status_code,
                 httpx.delete(f"{url}/api/images/{ids['default9']}",
                              timeout=30).status_code)
        if codes != (404, 404):
            fail(f"after DELETE: status and DELETE answered {codes}")
        try:
            clients[True].status(ids["default9"])
            fail("the client did not raise on a deleted image")
        except ClientError as exc:
            if exc.status != 404:
                fail(f"the client mapped a deleted image to {exc.status}")
        for c in clients.values():
            c.close()
        for proc, _out, _url in children.values():
            proc.send_signal(signal.SIGTERM)   # after the last status
        exits = {on: proc.wait(timeout=120)
                 for on, (proc, _out, _url) in children.items()}
        if any(exits.values()):
            fail(f"SIGTERM exit codes {exits}: {tail(True)} {tail(False)}")
        log("[14 entry] DELETE 204 then 404; SIGTERM: both children exited with 0")
    finally:
        for proc, out, _url in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            out.close()
        shutil.rmtree(root, ignore_errors=True)


class ServiceHarness:
    """build_app on its own loop thread plus a worker thread, on shared
    MemoryBroker / localfs / SQLite backends (the shape of the service
    tests' harness)."""

    def __init__(self, root: str, worker_cls, batch_size: int):
        import asyncio
        import threading

        from imageprocessor_tpu_torch.broker import MemoryBroker
        from imageprocessor_tpu_torch.config import load
        from imageprocessor_tpu_torch.storage import (
            LocalFSObjectStore,
            SQLiteMetadataStore,
        )

        self.cfg = load({k: v for k, v in os.environ.items()
                         if k != "DEVICE_PLATFORM"})
        self.cfg.worker.batch_size = batch_size
        self.meta = SQLiteMetadataStore(os.path.join(root, "meta.db"))
        self.store = LocalFSObjectStore(os.path.join(root, "objects"))
        self.broker = MemoryBroker()
        self.worker = worker_cls(self.cfg, meta=self.meta, store=self.store,
                                 broker=self.broker)
        self.worker._idle_sleep = 0.005
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._server_t = threading.Thread(target=self._serve, daemon=True)
        self._worker_t = threading.Thread(target=self.worker.run, daemon=True)
        self.url = ""

    def _serve(self):
        import asyncio

        from aiohttp import web

        from imageprocessor_tpu_torch.service.app import build_app

        asyncio.set_event_loop(self._loop)

        async def start():
            app = build_app(self.cfg, meta=self.meta, store=self.store,
                            broker=self.broker)
            runner = web.AppRunner(app)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", 0).start()
            self.url = f"http://127.0.0.1:{runner.addresses[0][1]}"
            self._started.set()

        self._loop.run_until_complete(start())
        self._loop.run_forever()

    def start_server(self) -> str:
        self._server_t.start()
        if not self._started.wait(30):
            fail("the in-process API did not start")
        return self.url

    def start_worker(self) -> None:
        self._worker_t.start()

    def depth(self) -> int:
        return self.broker.depth(self.cfg.broker.processing_topic,
                                 self.cfg.broker.group_id)

    def stop(self) -> None:
        self.worker.stop()
        if self._worker_t.ident is not None:   # a failure may come before its start
            self._worker_t.join(timeout=120)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._server_t.join(timeout=30)
        if self._worker_t.is_alive() or self._server_t.is_alive():
            fail("the in-process service did not stop")
        self.worker.close()


def phase_workers(blobs, png_blob) -> dict:
    """Phase 15: the batch and the pipelined worker in process behind
    build_app, uploads over HTTP. Returns the launches of both runs."""
    import httpx

    from imageprocessor_tpu_torch.ops.coords import keep_aspect_dims
    from imageprocessor_tpu_torch.runtime.codecs import decode_image
    from imageprocessor_tpu_torch.service.pipelined import PipelinedWorker
    from imageprocessor_tpu_torch.service.worker import Worker
    from imageprocessor_tpu_torch.utils.metrics import METRICS

    counters = kernel_counters()
    ups = uploads_of(blobs, png_blob)
    src_wh = {name: image_size(data) for name, (_f, data, *_r) in ups.items()}
    total = dict.fromkeys(KERNEL_KEYS, 0)
    artifacts = {}
    for kind, cls in (("batch", Worker), ("pipelined", PipelinedWorker)):
        root = tempfile.mkdtemp(prefix=f"chip_smoke-{kind}-",
                                dir=os.path.join(REPO, "build"))
        METRICS.reset()
        h = ServiceHarness(root, cls, batch_size=B)
        try:
            url = h.start_server()
            with httpx.Client(timeout=120) as c:
                def post(fname, data, mime, flags):
                    r = c.post(f"{url}/api/images/upload",
                               files={"file": (fname, data, mime)}, data=flags)
                    if r.status_code != 202:
                        fail(f"{kind}: upload of {fname} answered {r.status_code} "
                             f"{r.text}")
                    return r.json()["id"]

                def status(image_id):
                    return c.get(f"{url}/api/images/{image_id}/status").json()["status"]

                # -- the failure policy, queued before the worker starts
                gone = post("gone.jpg", blobs[9], "image/jpeg", {})
                h.store.delete_object(h.meta.get_image(gone).original_path)
                cut = post("cut.jpg", blobs[9][:len(blobs[9]) // 2], "image/jpeg", {})
                engine = h.worker.engine
                real_group = engine.device_group
                faults = []

                def faulty_group(group):
                    if not faults:
                        faults.append(len(group.items))
                        raise torch.OutOfMemoryError(
                            "CUDA out of memory (injected by chip_smoke)")
                    return real_group(group)

                engine.device_group = faulty_group
                retried = post("retry.jpg", blobs[9], "image/jpeg", {})
                h.start_worker()
                wait_until(lambda: (status(gone), status(cut), status(retried))
                           == ("failed", "failed", "completed") and h.depth() == 0,
                           f"{kind}: the failure policy's three uploads")
                engine.device_group = real_group
                got = {k: METRICS.snapshot()["counters"].get(k, 0) for k in (
                    "worker_fetch_missing", "worker_failed_permanent",
                    "worker_failed_transient", "worker_completed")}
                if got != {"worker_fetch_missing": 1, "worker_failed_permanent": 1,
                           "worker_failed_transient": 1, "worker_completed": 1} \
                        or faults != [1]:
                    fail(f"{kind}: failure policy counters {got}, faults {faults}")
                log(f"[15 workers] {kind}: deleted blob -> failed, acked "
                    f"(worker_fetch_missing 1); truncated JPEG -> failed, acked "
                    f"(worker_failed_permanent 1); torch.OutOfMemoryError out of "
                    f"device_group -> nacked, redelivered, completed "
                    f"(worker_failed_transient 1); queue empty")

                # -- the uploads, with every launch count set to 0 first
                # (the worker is idle: its queue is empty and acked)
                for mod, attr in counters.values():
                    setattr(mod, attr, 0)
                METRICS.reset()
                t0 = time.monotonic()
                ids = {}
                for splice_on in (True, False):
                    # the splice switch is read per call by the engine
                    os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "1" if splice_on else "0"
                    batch = {n: u for n, u in ups.items() if u[4] == splice_on}
                    for name, (fname, data, mime, flags, _s) in batch.items():
                        ids[name] = post(fname, data, mime, flags)
                    wait_until(lambda: all(status(ids[n]) in ("completed", "failed")
                                           for n in batch) and h.depth() == 0,
                               f"{kind}: uploads (splice {splice_on})")
                os.environ.pop("IMAGEPROCESSOR_JPEG_SPLICE", None)
                wall = time.monotonic() - t0
                counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
                bad = {n: status(i) for n, i in ids.items() if status(i) != "completed"}
                if bad:
                    fail(f"{kind}: uploads not completed: {bad}")
                if any(v == 0 for v in counts.values()):
                    fail(f"{kind}: a kernel never launched from the HTTP uploads: "
                         f"{counts}")
                require_card_entropy(f"{kind}: the HTTP uploads", counts["B0"],
                                     entropy_counts())
                for name, (_f, _d, _m, flags, _s) in ups.items():
                    want = expected_dims(flags, src_wh[name], keep_aspect_dims)
                    for op in want:
                        r = c.get(f"{url}/api/images/{ids[name]}",
                                  params={"operation": op})
                        if r.status_code != 200 or image_size(r.content) != want[op]:
                            fail(f"{kind}: {name} {op}: {r.status_code}")
                        artifacts[kind, name, op] = r.content
                t = METRICS.snapshot()["timings"]
                log(f"[15 workers] {kind}: {len(ups)} uploads over HTTP completed in "
                    f"{wall:.2f} s (host clock); launches {counts}; " + "; ".join(
                        f"{k} n={t[k]['count']} p50={t[k]['p50']:.1f} max={t[k]['max']:.1f}"
                        for k in ("queue_wait_ms", "batcher_wait_ms", "span_pack_ms",
                                  "span_device_ms", "engine_encode_ms") if k in t))
                for k in KERNEL_KEYS:
                    total[k] += counts[k]
        finally:
            os.environ.pop("IMAGEPROCESSOR_JPEG_SPLICE", None)
            h.stop()
            shutil.rmtree(root, ignore_errors=True)

    # the two workers' artifacts of the same upload: equal bytes where host
    # code wrote them from the source's own coefficients (the spliced
    # watermark), <= 1 LSB after decoding elsewhere
    worst, same = 0, 0
    for (kind, name, op), data in artifacts.items():
        if kind != "batch":
            continue
        other = artifacts["pipelined", name, op]
        if name == "all_flags" and op == "watermark":
            if data != other:
                fail("the spliced watermark differs between the two workers")
            continue
        same += data == other
        a, b = decode_image(data)[0], decode_image(other)[0]
        worst = max(worst, int(np.abs(a.astype(int) - b.astype(int)).max()))
    if worst > LSB_LIMIT:
        fail(f"the two workers' artifacts differ by {worst} LSB")
    log(f"[15 workers] batch vs pipelined artifacts: spliced watermark "
        f"byte-identical; the other {len(artifacts) // 2 - 1} renditions differ by "
        f"{worst} LSB at most after decoding ({same} byte-identical)")
    return total


def phase_latency(card: str) -> dict:
    """Phase 16: queue-to-processed latency under arrival, the reference
    bench's latency run through the port bench's ``bench_latency``: 60
    uploads of a 480 x 640 JPEG with a 3000 x 4000 one every tenth,
    default plan, batch_size 16, batch_deadline_ms 25, arrivals at 200/s
    through ImageUsecase.upload_image -> MemoryBroker -> worker; latency
    from produce to the result on the results topic. Each bucket and batch
    size is warmed first. The batch worker, the pipelined worker, and the
    pipelined worker under profile_capture. Nothing is asserted about the
    values."""
    from imageprocessor_tpu_torch.bench import bench_latency
    from imageprocessor_tpu_torch.service.pipelined import PipelinedWorker
    from imageprocessor_tpu_torch.service.worker import Worker

    results = []
    for kind, cls, traced in (("batch", Worker, False),
                              ("pipelined", PipelinedWorker, False),
                              ("pipelined", PipelinedWorker, True)):
        r = bench_latency(torch.device("cuda"), cls, traced=traced)
        results.append({"worker": kind, "traced": traced, **r})
        idle = ("" if not traced else
                "; device idle share not measured (the profiler showed no device time)"
                if r["device_busy_share"] is None else
                f"; device busy {r['device_busy_share']:.4f} of the window "
                f"(idle share {1 - r['device_busy_share']:.4f}, torch.profiler)")
        log(f"[16 latency] {card}: {kind} worker{' under torch.profiler' if traced else ''}"
            f", {r['n']} uploads at 200/s (480x640, a 3000x4000 every 10th), batch 16, "
            f"deadline 25 ms: p50 {r['p50_ms']:.1f} ms, p95 {r['p95_ms']:.1f} ms, p99 "
            f"{r['p99_ms']:.1f} ms, max {r['max_ms']:.1f} ms (480x640 alone: p50 "
            f"{r['small_p50_ms']:.1f}, p99 {r['small_p99_ms']:.1f} ms); "
            f"{r['images_per_sec']:.2f} images/s over the window (host clock){idle}; "
            f"stages: " + "; ".join(
                f"{k} n={v['count']} p50={v['p50']:.1f} p99={v['p99']:.1f} max={v['max']:.1f}"
                for k, v in r["stages_ms"].items()))
    return {"latency": results}


def phase_bench(card: str, step_ms: float) -> dict:
    """Phase 17: ``python3 -m imageprocessor_tpu_torch.bench`` as a child
    process with no DEVICE_PLATFORM, then its splice-off step and its PSNR
    check in process at the --smoke shape with the launch counts set to 0
    before and read after. step_ms: phase 6's decode -> resample step.
    Returns the launches of the in-process run."""
    from imageprocessor_tpu_torch import bench

    env = {k: v for k, v in os.environ.items() if k != "DEVICE_PLATFORM"}
    env["PYTHONPATH"] = REPO
    t0 = time.monotonic()
    try:
        proc = subprocess.run([sys.executable, "-m", "imageprocessor_tpu_torch.bench"],
                              cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=300)
    except subprocess.TimeoutExpired as exc:
        fail(f"the bench did not finish in {exc.timeout:.0f} s")
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        fail(f"the bench exited with {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if set(line) != set(bench.KEYS):
        fail(f"the bench's keys differ from bench.KEYS: "
             f"{sorted(set(line) ^ set(bench.KEYS))}")
    composed = B * 1000.0 / step_ms
    off = abs(line["device_splice_step_images_per_sec"] - composed) / composed
    if line["platform"] != "cuda" or line["psnr_db_vs_oracle"] <= BENCH_PSNR_DB \
            or off > 0.25:
        fail(f"the bench: platform {line['platform']}, PSNR "
             f"{line['psnr_db_vs_oracle']} dB, splice step "
             f"{line['device_splice_step_images_per_sec']:.1f} images/s against phase "
             f"6's {composed:.1f} ({off:.3f} off, limit 0.25)")
    log(f"[17 bench] {card}: python3 -m imageprocessor_tpu_torch.bench exited 0 in "
        f"{wall:.1f} s (host clock); every documented key, platform cuda, PSNR "
        f"{line['psnr_db_vs_oracle']:.2f} dB, splice step "
        f"{line['device_splice_step_images_per_sec']:.1f} images/s, {off:.3f} from "
        f"phase 6's {composed:.1f}; its line:")
    log(json.dumps(line))

    counters = kernel_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    cuda = torch.device("cuda")
    geo = {k: bench.SMOKE[k] for k in bench.GEOMETRY}
    step = bench.bench_device_jpeg_step(cuda, bench.SMOKE["batch"], False,
                                        iters=bench.SMOKE["iters"], **geo)
    db, _ = bench.quick_psnr_check(cuda)
    counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    # the bench's steps start from host-scanned planes: no B0
    if (any(v == 0 for k, v in counts.items() if k != "B0") or counts["B0"]
            or db <= BENCH_PSNR_DB):
        fail(f"the bench's steps in process: launches {counts}, PSNR {db:.2f} dB")
    log(f"[17 bench] in process at the --smoke shape: splice-off step "
        f"{step['device_jpeg_step_images_per_sec']:.1f} images/s, PSNR {db:.2f} dB; "
        f"launches {counts}")
    return counts


# ------------------------------------------------------ the reference topology

class S3Stub:
    """An in-process S3 endpoint: path-style buckets and objects in memory,
    with PUT, GET, HEAD, DELETE and ListObjectsV2. Every request must carry
    an ``AWS4-HMAC-SHA256`` Authorization header; one without it is
    answered 403 and counted in ``unsigned``. ``buckets`` keeps the body of
    each CreateBucket (its location constraint)."""

    def __init__(self):
        import http.server
        import threading
        import urllib.parse

        self.objects: dict[str, bytes] = {}
        self.types: dict[str, str] = {}
        self.buckets: dict[str, bytes] = {}
        self.requests = 0
        self.unsigned = 0
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *_args):
                pass

            def _reply(self, code, body=b"", ctype="", length=None):
                self.send_response(code)
                self.send_header("Content-Length", str(len(body) if length is None
                                                       else length))
                if ctype:
                    self.send_header("Content-Type", ctype)
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _target(self):
                """(bucket, key or "", query) of the request; False when
                it is unsigned (answered 403 here)."""
                stub.requests += 1
                if not self.headers.get("Authorization", "").startswith(
                        "AWS4-HMAC-SHA256 "):
                    stub.unsigned += 1
                    self._reply(403)
                    return False
                path, _, query = self.path.partition("?")
                bucket, _, key = urllib.parse.unquote(path).lstrip("/").partition("/")
                return bucket, key, urllib.parse.parse_qs(query)

            def do_PUT(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                t = self._target()
                if t is False:
                    return
                bucket, key, _ = t
                if not key:
                    stub.buckets[bucket] = body
                elif bucket not in stub.buckets:
                    return self._reply(404)
                else:
                    stub.objects[f"{bucket}/{key}"] = body
                    stub.types[f"{bucket}/{key}"] = self.headers.get("Content-Type", "")
                self._reply(200)

            def do_GET(self):
                t = self._target()
                if t is False:
                    return
                bucket, key, query = t
                if not key:
                    prefix = f"{bucket}/{query.get('prefix', [''])[0]}"
                    keys = sorted(k[len(bucket) + 1:] for k in list(stub.objects)
                                  if k.startswith(prefix))
                    body = ("<?xml version='1.0'?><ListBucketResult>"
                            + "".join(f"<Contents><Key>{k}</Key></Contents>"
                                      for k in keys)
                            + "<IsTruncated>false</IsTruncated></ListBucketResult>")
                    return self._reply(200, body.encode(), "application/xml")
                data = stub.objects.get(f"{bucket}/{key}")
                if data is None:
                    return self._reply(404)
                self._reply(200, data, stub.types.get(f"{bucket}/{key}", ""))

            def do_HEAD(self):
                t = self._target()
                if t is False:
                    return
                bucket, key, _ = t
                if not key:
                    return self._reply(200 if bucket in stub.buckets else 404)
                data = stub.objects.get(f"{bucket}/{key}")
                if data is None:
                    return self._reply(404)
                self._reply(200, ctype=stub.types.get(f"{bucket}/{key}", ""),
                            length=len(data))

            def do_DELETE(self):
                t = self._target()
                if t is False:
                    return
                bucket, key, _ = t
                stub.objects.pop(f"{bucket}/{key}", None)
                self._reply(204)

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        self.endpoint = f"127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def pg_stub(auth: str = "scram"):
    """tests/pg_stub.py's PgStubServer, the repo's in-process Postgres wire
    server (loaded by path: the tests directory is not a package), with
    TCP_NODELAY on each connection: the stub answers a query in several
    small writes, and Nagle's algorithm against the client's delayed ACK
    would hold every answer ~40 ms."""
    import importlib.util
    import socket

    spec = importlib.util.spec_from_file_location(
        "ip_pg_stub", os.path.join(REPO, "tests", "pg_stub.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class NoDelayPgStub(mod.PgStubServer):
        def _serve(self, conn):
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            super()._serve(conn)

    return NoDelayPgStub(auth=auth)


def topology_env(kafka: str, s3: str, pg) -> dict:
    """deploy/docker-compose.kafka.yaml's x-backend-env (its defaults),
    pointed at a Kafka-wire server, an S3 endpoint and a Postgres server
    on this host."""
    return {"STORAGE_BACKEND": "s3", "MINIO_ENDPOINT": s3,
            "MINIO_ACCESS_KEY": "minioadmin", "MINIO_SECRET_KEY": "minioadmin",
            "MINIO_REGION": "us-east-1", "MINIO_BUCKET": "images",
            "METADATA_BACKEND": "postgres", "POSTGRES_HOST": pg.host,
            "POSTGRES_PORT": str(pg.port), "POSTGRES_USER": pg.user,
            "POSTGRES_PASSWORD": pg.password, "POSTGRES_DB": "image_processor",
            "BROKER_BACKEND": "kafka", "KAFKA_BROKERS": kafka,
            "KAFKA_PROCESSING_TOPIC": "image-processing",
            "KAFKA_RESULTS_TOPIC": "image-processed",
            "KAFKA_GROUP_ID": "image-processor-group", "BROKER_PARTITIONS": "3"}


def smooth_png(h: int, w: int, seed: int) -> bytes:
    """A seeded gradient with two bits of noise as a fast-deflate PNG (a
    12 MP one stays well under the API's 32 MiB upload limit)."""
    import cv2

    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 170, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 80, w, dtype=np.float32)[None, :, None]
    img = np.clip(yy + xx + rng.integers(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, 1])
    if not ok:
        fail("OpenCV could not encode a PNG")
    return buf.tobytes()


TOPO_N, TOPO_RATE = 60, 200.0                    # the bench's latency mix
TOPO_SMALL, TOPO_BIG = (480, 640), (3000, 4000)


def phase_topology(card: str, oracle) -> dict:
    """Phase 18: the reference's topology. A ``kafkaserver`` child
    (3 partitions), the S3 stub and tests/pg_stub.py's Postgres server
    (SCRAM), the ``api`` child over HTTP, and two workers of one consumer
    group on the card: the ``worker`` entry point as a child and a
    PipelinedWorker in process (the launch counts are per process). The
    bench's latency mix in two passes: (a) backlog, (b) arrivals at 200/s
    with the child stopped by SIGTERM halfway; then three seeded PNG
    uploads against the float64 Go oracle. Returns the in-process
    launches."""
    import threading

    import httpx

    from imageprocessor_tpu_torch.bench import percentile, seeded_jpegs
    from imageprocessor_tpu_torch.broker import kafkawire
    from imageprocessor_tpu_torch.broker.base import partition_for_key
    from imageprocessor_tpu_torch.broker.kafka import KafkaBroker
    from imageprocessor_tpu_torch.config import load
    from imageprocessor_tpu_torch.domain import ProcessingResult
    from imageprocessor_tpu_torch.runtime.codecs import decode_image
    from imageprocessor_tpu_torch.service.pipelined import PipelinedWorker
    from imageprocessor_tpu_torch.storage.postgres_meta import PostgresMetadataStore
    from imageprocessor_tpu_torch.utils.metrics import METRICS

    label = (f"{card}; against in-process stub servers (S3, Postgres), not MinIO "
             f"and Postgres; host clock")
    root = tempfile.mkdtemp(prefix="chip_smoke-topology-",
                            dir=os.path.join(REPO, "build"))
    s3 = S3Stub()
    pg = pg_stub("scram")
    kafka = f"127.0.0.1:{free_port()}"
    env = topology_env(kafka, s3.endpoint, pg)
    # the worker service's WORKER_CONCURRENCY; batch size and deadline of
    # the bench's latency run
    env.update(WORKER_CONCURRENCY="3", WORKER_BATCH_SIZE="16",
               WORKER_BATCH_DEADLINE_MS="25")
    cfg = load(env)
    topic, group = cfg.broker.processing_topic, cfg.broker.group_id
    children: dict = {}
    done: dict[str, list] = {}          # image id -> [(monotonic, status)]
    stop = threading.Event()
    threads: list = []
    observer = worker = None

    def spawn(name, *args):
        child_env = {k: v for k, v in os.environ.items() if k != "DEVICE_PLATFORM"}
        child_env.update(env, PYTHONPATH=REPO)
        out = open(os.path.join(root, f"{name}.log"), "wb")
        proc = subprocess.Popen(
            [sys.executable, "-m", "imageprocessor_tpu_torch.service", *args],
            cwd=REPO, env=child_env, stdout=out, stderr=subprocess.STDOUT)
        children[name] = (proc, out)
        return proc

    def tail(name) -> str:
        with open(os.path.join(root, f"{name}.log"), "rb") as f:
            return f.read()[-3000:].decode(errors="replace")

    def alive(name) -> bool:
        proc = children[name][0]
        if proc.poll() is not None:
            fail(f"the {name} child exited with {proc.returncode}: {tail(name)}")
        return True

    def exits_zero(name, timeout=120.0) -> None:
        """Waits for a child sent SIGTERM once (a second one could land
        after its handler is gone, during interpreter shutdown)."""
        try:
            code = children[name][0].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            fail(f"the {name} child did not exit {timeout:.0f} s after SIGTERM")
        if code != 0:
            fail(f"the {name} child exited with {code} on SIGTERM: {tail(name)}")

    def consume():
        # every completion on the results topic, read back over the wire
        while not stop.is_set():
            try:
                for m in observer.poll(cfg.broker.results_topic, "chip-smoke-observer",
                                       max_n=64):
                    res = ProcessingResult.from_json(m.value)
                    done.setdefault(res.image_id, []).append(
                        (time.monotonic(), res.status.value))
                    observer.ack(m)
            except Exception as exc:   # reported by the waits that follow
                log(f"[18 topology] results consumer: {exc!r}")
            time.sleep(0.002)

    try:
        spawn("kafkaserver", "kafkaserver", "--port", kafka.rsplit(":", 1)[1])
        api_url = f"http://127.0.0.1:{free_port()}"
        spawn("api", "api", "--port", api_url.rsplit(":", 1)[1])
        t0 = time.monotonic()

        def healthy():
            try:
                return httpx.get(f"{api_url}/api/health", timeout=2).status_code == 200
            except httpx.TransportError:
                return False

        # the api's first request (create_topic) waits for the Kafka server
        wait_until(lambda: alive("kafkaserver") and alive("api") and healthy(),
                   "the kafkaserver and api children", interval=0.1)
        log(f"[18 topology] kafkaserver and api children up "
            f"{time.monotonic() - t0:.1f} s after they were started")
        observer = KafkaBroker(brokers=[kafka])
        threads.append(threading.Thread(target=consume, daemon=True))
        threads[-1].start()

        small = seeded_jpegs(1, *TOPO_SMALL)[0]
        big = seeded_jpegs(1, *TOPO_BIG)[0]
        client = httpx.Client(timeout=120)

        def post(fname, data, mime="image/jpeg") -> str:
            r = client.post(f"{api_url}/api/images/upload",
                            files={"file": (fname, data, mime)})
            if r.status_code != 202:
                fail(f"upload of {fname} answered {r.status_code} {r.text}: {tail('api')}")
            return r.json()["id"]

        def mix(i):
            return (big if (i + 1) % 10 == 0 else small), f"u{i}.jpg"

        def settled(ids, what, timeout=240.0):
            wait_until(lambda: all(i in done for i in ids), what, timeout=timeout,
                       interval=0.005)
            return max(done[i][0][0] for i in ids)

        # -- (a) backlog: everything queued before either worker starts
        ids_a = [post(name, data) for data, name in map(mix, range(TOPO_N))]
        t_a = time.monotonic()
        spawn("worker", "worker")
        wait_until(lambda: alive("worker") and any(i in done for i in ids_a),
                   "the worker child's first completion", interval=0.005)
        t_first = min(done[i][0][0] for i in ids_a if i in done)
        counters = kernel_counters()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        METRICS.reset()
        worker = PipelinedWorker(cfg)
        worker._idle_sleep = 0.002
        threads.append(threading.Thread(target=worker.run, daemon=True))
        threads[-1].start()
        t_drained = settled(ids_a, "(a) the backlog's completions")
        own = sorted(worker.broker._consumers[(topic, group)].partitions)
        in_a = METRICS.snapshot()["counters"].get("worker_completed", 0)
        log(f"[18 topology] {label}: (a) backlog of {TOPO_N} uploads "
            f"({TOPO_SMALL[1]}x{TOPO_SMALL[0]}, a "
            f"{TOPO_BIG[1]}x{TOPO_BIG[0]} every 10th, default plan) drained "
            f"{t_drained - t_a:.3f} s after the worker child was started "
            f"({t_first - t_a:.3f} s to its first completion, start-up included; "
            f"{t_drained - t_first:.3f} s from there to the last); the in-process "
            f"PipelinedWorker joined after that first completion, completed "
            f"{in_a:.0f} and owns partitions {own}")
        if not own or len(own) == 3:
            fail(f"(a): the in-process worker owns partitions {own}: the group "
                 f"never split")

        # -- (b) arrivals at TOPO_RATE; the worker child stopped halfway
        t_up: dict[str, float] = {}
        marks: dict[str, float] = {}

        def watch():
            proc = children["worker"][0]
            while not stop.is_set() and len(marks) < 2:
                now = time.monotonic()
                if "exit" not in marks and proc.poll() is not None:
                    marks["exit"] = now
                if "own" not in marks and len(
                        worker.broker._consumers[(topic, group)].partitions) == 3:
                    marks["own"] = now
                time.sleep(0.001)

        for i in range(TOPO_N):
            if i == TOPO_N // 2:
                children["worker"][0].send_signal(signal.SIGTERM)
                t_term = time.monotonic()
                threads.append(threading.Thread(target=watch, daemon=True))
                threads[-1].start()
            data, name = mix(TOPO_N + i)
            t_up[post(name, data)] = time.monotonic()
            time.sleep(1.0 / TOPO_RATE)
        ids_b = list(t_up)
        exits_zero("worker")
        settled(ids_b, "(b) the completions under arrival")
        wait_until(lambda: len(marks) == 2, "the survivor's rebalance", interval=0.005)
        lat = sorted((done[i][0][0] - t_up[i]) * 1000.0 for i in ids_b)
        ends = sorted(done[i][0][0] for i in ids_b)
        stall = max(b - a for a, b in zip(ends, ends[1:]))
        moved = sum(1 for i in ids_b if partition_for_key(i.encode(), 3) not in own)
        log(f"[18 topology] {label}: (b) {TOPO_N} uploads at up to {TOPO_RATE:.0f}/s, the "
            f"worker child sent SIGTERM after {TOPO_N // 2}: upload -> completion on "
            f"image-processed p50 {percentile(lat, 0.50):.1f} ms, p99 "
            f"{percentile(lat, 0.99):.1f} ms, max {lat[-1]:.1f} ms; the child exited "
            f"0 {(marks['exit'] - t_term) * 1000.0:.1f} ms after SIGTERM; rebalance "
            f"gap (SIGTERM -> the survivor owns all 3 partitions) "
            f"{(marks['own'] - t_term) * 1000.0:.1f} ms; longest interval without a "
            f"completion {stall * 1000.0:.1f} ms; {moved} of {TOPO_N} uploads keyed to "
            f"the child's partitions")

        counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        if counts["B1"] == 0 or counts["B2"] == 0:
            fail(f"B1 or B2 never launched from the Kafka tasks: {counts}")
        require_card_entropy("phase 18's Kafka tasks", counts["B0"], entropy_counts())
        log(f"[18 topology] {card}: launches in process from the Kafka tasks of "
            f"(a) and (b): {counts}")

        # -- three seeded PNG uploads against the float64 Go oracle
        pngs = {f"png{h}x{w}": smooth_png(h, w, seed)
                for seed, (h, w) in enumerate(((480, 640), (1080, 1920), TOPO_BIG))}
        ids_c = {name: post(f"{name}.png", data, "image/png")
                 for name, data in pngs.items()}
        settled(ids_c.values(), "the oracle uploads")
        readings = []
        for name, image_id in ids_c.items():
            got = {op: client.get(f"{api_url}/api/images/{image_id}",
                                  params={"operation": op}) for op in ("thumbnail", "resize")}
            if any(r.status_code != 200 for r in got.values()):
                fail(f"{name}: renditions answered {[r.status_code for r in got.values()]}")
            readings.append(f"{name}: " + ", ".join(check_against_oracle(
                oracle, decode_image, name, pngs[name], got["thumbnail"].content,
                got["resize"].content, exact=True)))
        log(f"[18 topology] three PNG uploads through the topology against the "
            f"float64 Go oracle on the host-decoded source (<= {LSB_LIMIT} LSB): "
            + "; ".join(readings))

        # -- what the topology holds afterwards
        every = [*ids_a, *ids_b, *ids_c.values()]
        statuses = {client.get(f"{api_url}/api/images/{i}/status").json()["status"]
                    for i in every}
        if statuses != {"completed"}:
            fail(f"statuses after the run: {statuses}")
        meta = PostgresMetadataStore(cfg.db)
        rows = {i: meta.list_processed(i) for i in every}
        meta.close()
        missing = [r.path for rs in rows.values() for r in rs
                   if f"{cfg.storage.bucket}/{r.path}" not in s3.objects]
        shapes = {tuple(sorted(r.operation.value for r in rs)) for rs in rows.values()}
        if missing or shapes != {("resize", "thumbnail")}:
            fail(f"processed rows: {len(missing)} point at no object ({missing[:3]}), "
                 f"operations {shapes}")
        completions = {i: [s for _t, s in done.get(i, [])] for i in every}
        bad = {i: c for i, c in completions.items() if c != ["completed"]}
        if bad or len(done) != len(every):
            fail(f"image-processed: {len(bad)} tasks without exactly one completion "
                 f"({list(bad.items())[:3]}), {len(done)} image ids for {len(every)} "
                 f"tasks")
        depth = observer.depth(topic, group)
        if depth != 0:
            fail(f"the processing topic's depth for {group} is {depth}")
        if kafkawire._native_crc32c is None:
            fail("kafkawire checks record batches with the Python CRC-32C table")
        blob = np.random.default_rng(18).integers(0, 256, 1 << 24, np.uint8).tobytes()
        t0 = time.perf_counter()
        kafkawire.crc32c(blob)
        crc_mb_s = 16.0 / (time.perf_counter() - t0)
        if s3.unsigned or not s3.requests:
            fail(f"S3 stub: {s3.unsigned} of {s3.requests} requests unsigned")
        log(f"[18 topology] {len(every)} uploads completed; {sum(map(len, rows.values()))} "
            f"Postgres rows, each pointing at an object the S3 stub holds "
            f"({len(s3.objects)} objects; {s3.requests} requests, all SigV4-signed); "
            f"one completion per task on image-processed; depth of {topic} for "
            f"{group}: 0; CRC-32C: the host library's, {crc_mb_s:.1f} MB/s over "
            f"16 MiB on this host (host clock)")

        worker.stop()
        stop.set()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads):
            fail("the in-process worker or the results consumer did not stop")
        worker.close()
        worker = None
        observer.close()
        observer = None
        client.close()
        for name in ("api", "kafkaserver"):
            children[name][0].send_signal(signal.SIGTERM)
            exits_zero(name)
        log("[18 topology] SIGTERM: the api and kafkaserver children exited with 0")
        return counts
    finally:
        stop.set()
        if worker is not None:
            worker.stop()
        for t in threads:
            t.join(timeout=30)
        if worker is not None:
            worker.close()
        if observer is not None:
            observer.close()
        for proc, out in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            out.close()
        s3.close()
        pg.close()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------ routes and replicas

def phase_routes(card: str, oracle, blobs: list) -> dict:
    """Phase 19: the device-JPEG switch, the native coefficient rotation
    and the engine's replicas, on phase 5's sources (the 12 MP group among
    them) with the default plan and a flip plan, the splice off so that
    the flip's JPEG renditions reach the device. Each engine run is a warm
    call after a first one; every launch count is set to 0 just before
    each run and read just after. Returns the launches of the runs."""
    from imageprocessor_tpu_torch import kernels
    from imageprocessor_tpu_torch.config import load
    from imageprocessor_tpu_torch.domain import (
        ImageStatus,
        OperationParams,
        OperationType,
        ProcessingTask,
    )
    from imageprocessor_tpu_torch.models.plan import normalize_operations
    from imageprocessor_tpu_torch.runtime import coeftx, hostcodec, splice
    from imageprocessor_tpu_torch.runtime.batcher import BatchItem, group_items
    from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
    from imageprocessor_tpu_torch.service.worker import Worker

    from imageprocessor_tpu_torch.utils.metrics import METRICS

    counters = kernel_counters()
    launched = dict.fromkeys(KERNEL_KEYS, 0)

    def counted(fn):
        """fn() with every launch count and METRICS set to 0 before; ->
        (result, launches), the launches added to the phase's. B0 must
        flag no upload."""
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        METRICS.reset()
        out = fn()
        if entropy_counts()["fallbacks"]:
            fail(f"phase 19: B0 flagged uploads: {entropy_counts()}")
        got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        for k, v in got.items():
            launched[k] += v
        return out, got

    class Store:
        def __init__(self):
            self.blobs: dict[str, bytes] = {}

        def save_processed(self, path, data, mime=None):
            self.blobs[path] = data

    P, T = OperationParams, OperationType
    plans = {"default": [P(T.THUMBNAIL, {"size": 200, "crop_to_fit": True}),
                         P(T.RESIZE, {"width": 1024, "height": 768,
                                      "keep_aspect": True})],
             "flip": [P(T.FLIP, {"direction": "vertical"})]}

    def run(engine, ops):
        """A first and a warm process_tasks of the sources; -> (the warm
        run's artifacts, its images/s on the host clock)."""
        def once():
            engine.store.blobs.clear()
            t0 = time.monotonic()
            res = engine.process_tasks([
                (ProcessingTask(id=f"t{k}", image_id=f"i{k}", original_path="o",
                                bucket="images", operations=ops, format="jpeg"), b)
                for k, b in enumerate(blobs)])
            wall = time.monotonic() - t0
            for r in res:
                if r.result.status is not ImageStatus.COMPLETED:
                    fail(f"phase 19: {r.result.error}")
            return wall
        once()
        wall = once()
        return dict(engine.store.blobs), len(blobs) / wall

    engines = []
    os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "0"
    try:
        # (a) IMAGEPROCESSOR_DEVICE_JPEG=0: JPEG decode and encode on the host
        os.environ["IMAGEPROCESSOR_DEVICE_JPEG"] = "0"
        off = TorchProcessingEngine(Store(), device="cuda", batch_size=B)
        engines.append(off)
        os.environ.pop("IMAGEPROCESSOR_DEVICE_JPEG")
        on = TorchProcessingEngine(Store(), device="cuda", batch_size=B)
        engines.append(on)
        if off.device_jpeg is not False or on.device_jpeg is not True:
            fail("phase 19: IMAGEPROCESSOR_DEVICE_JPEG was not honoured")
        rates = {}
        for name, ops in plans.items():
            (_, rates[name, 0]), got = counted(lambda: run(off, ops))
            if (got["B0"] or got["B1"] or got["B3"]
                    or (name == "default" and not got["B2"])):
                fail(f"phase 19 {name}, DEVICE_JPEG=0: launches {got}")
            (_, rates[name, 1]), got1 = counted(lambda: run(on, ops))
            if (not got1["B0"] or not got1["B1"]
                    or (name == "flip" and not got1["B3"])):
                fail(f"phase 19 {name}, DEVICE_JPEG unset: launches {got1}")
            log(f"[19 routes] {card}: {name} plan, {len(blobs)} sources "
                f"(8 x 12 MP among them): engine_images_per_sec "
                f"DEVICE_JPEG=0 {rates[name, 0]:.2f}, DEVICE_JPEG=1 "
                f"{rates[name, 1]:.2f} (host clock, warm); launches {got} "
                f"and {got1}; usable_cores {len(os.sched_getaffinity(0))}")
        plan = normalize_operations(plans["default"])
        items = []
        for k, blob in enumerate(blobs):
            arr, _fmt, layout, hw, _ = off.decode_for_plan_ex(blob, plan)
            if layout != "hwc":
                fail(f"phase 19: DEVICE_JPEG=0 took layout {layout}")
            items.append(BatchItem(item_id=str(k), image=arr,
                                   plan_key=plan.group_key(),
                                   payload=(k, None, "jpeg", plan),
                                   layout=layout, valid_hw=hw))
        worst, checked = 0, 0
        for group in group_items(items, max_batch=B):
            (_, outs, out_hws, _), _ = counted(lambda: off.device_group(group))
            for i, it in enumerate(group.items):
                h, w = it.hw
                if h * w > 1920 * 1080:
                    continue
                rgb = it.image[:h, :w]
                oh, ow = out_hws[1][i]
                for got, ref in ((outs[0][i], oracle.thumbnail_go(rgb, 200, crop_to_fit=True)),
                                 (outs[1][i][:, :oh, :ow],
                                  oracle.resize_go(rgb, 1024, 768, keep_aspect=True))):
                    got = got.transpose(1, 2, 0)
                    if got.shape != ref.shape:
                        fail(f"phase 19: {got.shape} != oracle {ref.shape}")
                    worst = max(worst, int(np.abs(got.astype(int) - ref.astype(int)).max()))
                checked += 1
        if worst > LSB_LIMIT or checked == 0:
            fail(f"phase 19: DEVICE_JPEG=0 outputs {worst} LSB from the oracle")
        log(f"[19 routes] DEVICE_JPEG=0: thumbnail and resize of the {checked} "
            f"sources up to 1920x1080, host-decoded, within {worst} LSB of the "
            f"float64 Go oracle (limit {LSB_LIMIT})")

        # (b) the native coefficient rotation against the numpy path
        scanned = hostcodec.scan_jpeg_coefficients(blobs[0])
        luma = scanned[0][0]
        numpy_rot = {"transpose": lambda q: q.T,
                     "rot90": lambda q: coeftx._flip_h_plane(q).T,
                     "rot270": lambda q: coeftx._flip_v_plane(q).T}
        for mode, ref_fn in numpy_rot.items():
            if not np.array_equal(hostcodec.coef_rot_i16(luma, mode), ref_fn(luma)):
                fail(f"phase 19: coef_rot_i16 {mode} differs from the numpy path")
        ctx = splice.coef_context(*scanned)
        op = normalize_operations([P(T.ROTATE, {"angle": 90})]).ops[0]
        prims = coeftx.eligible_prims(op, ctx.size, ctx.sampling)
        native = coeftx._rot_native

        def timed_apply():
            best, out = float("inf"), None
            for _ in range(3):
                t0 = time.perf_counter()
                out = coeftx.apply(ctx, prims)
                best = min(best, time.perf_counter() - t0)
            return out, best * 1000.0

        fast, fast_ms = timed_apply()
        coeftx._rot_native = lambda planes, mode: None
        try:
            slow, slow_ms = timed_apply()
        finally:
            coeftx._rot_native = native
        if not all(np.array_equal(a, b) for a, b in zip(fast.planes, slow.planes)):
            fail("phase 19: rot90 planes differ between the native and numpy paths")
        log(f"[19 routes] {card}: coef_rot_i16 equals the numpy path bit for bit "
            f"on a {luma.shape[0]}x{luma.shape[1]} luma plane in all three modes; "
            f"rot90 [{'+'.join(prims)}] transform of one 3000x4000 4:2:0 JPEG, "
            f"best of 3 (host clock, one thread): native {fast_ms:.1f} ms, numpy "
            f"{slow_ms:.1f} ms ({slow_ms / fast_ms:.2f}x)")

        # (c) replicas: the refusal, two on one card, two cards
        have = torch.cuda.device_count()
        try:
            Worker(load({"DEVICE_DATA_AXIS": str(have + 1)}))
            fail(f"phase 19: Worker took DEVICE_DATA_AXIS={have + 1} on {have} card(s)")
        except ValueError as exc:
            if "DEVICE_DATA_AXIS" not in str(exc):
                fail(f"phase 19: the refusal does not name the variable: {exc}")
            log(f"[19 replicas] Worker refuses DEVICE_DATA_AXIS={have + 1} before "
                f"any backend: {exc}")
        one = TorchProcessingEngine(Store(), device="cuda:0", batch_size=B)
        engines.append(one)
        two = TorchProcessingEngine(Store(), devices=[torch.device("cuda", 0)] * 2,
                                    batch_size=B)
        engines.append(two)
        multi = None
        if have >= 2:
            multi = TorchProcessingEngine(Store(), device="cuda", data_axis=2,
                                          batch_size=B)
            engines.append(multi)
        for name, ops in plans.items():
            (art1, r1), got1 = counted(lambda: run(one, ops))
            two.replica_groups[:] = [0, 0]
            (art2, r2), got2 = counted(lambda: run(two, ops))
            if art2 != art1 or not all(two.replica_groups):
                fail(f"phase 19 {name}: two replicas on one card: identical "
                     f"{art2 == art1}, groups per replica {two.replica_groups}")
            line = (f"[19 replicas] {card}: {name} plan, {len(art1)} artifacts "
                    f"byte-identical with two replicas on cuda:0 (two streams, two "
                    f"threads, groups per replica {two.replica_groups}); images/s "
                    f"one {r1:.2f}, two {r2:.2f} (host clock, warm); launches "
                    f"{got1} and {got2}")
            if multi is not None:
                with kernels.count_lock:
                    before = dict(kernels.card_launches)
                (art_m, r_m), got_m = counted(lambda: run(multi, ops))
                with kernels.count_lock:
                    after = dict(kernels.card_launches)
                per_card = {c: after.get(c, 0) - before.get(c, 0) for c in (0, 1)}
                if art_m != art1 or not all(per_card.values()):
                    fail(f"phase 19 {name}: data_axis=2 over two cards: identical "
                         f"{art_m == art1}, launches per card {per_card}")
                line += (f"; data_axis=2 over cuda:0 and cuda:1 byte-identical, "
                         f"{r_m:.2f} images/s, launches per card {per_card}")
            log(line)
        if multi is None:
            log(f"[19 replicas] the multi-card run was skipped: this host has "
                f"{have} CUDA card")
    finally:
        os.environ.pop("IMAGEPROCESSOR_JPEG_SPLICE", None)
        os.environ.pop("IMAGEPROCESSOR_DEVICE_JPEG", None)
        for e in engines:
            e.close()
    log(f"[19 routes] launches of the phase's runs: {launched}")
    return launched


def phase_staging(card: str) -> dict:
    """Phase 21: one 32 x 12 MP group through the staged and the packed
    device stage, in turns, on fresh scans each time: B1's operands and
    the outputs byte-identical, and each path's pack time, H2D rate,
    device span and peak card memory. Returns the launches of the runs."""
    from concurrent.futures import ThreadPoolExecutor

    from imageprocessor_tpu_torch.domain import OperationParams, OperationType
    from imageprocessor_tpu_torch.models.plan import normalize_operations
    from imageprocessor_tpu_torch.runtime import engine as engine_mod
    from imageprocessor_tpu_torch.runtime.batcher import BatchItem, group_items
    from imageprocessor_tpu_torch.runtime.engine import TorchProcessingEngine
    from imageprocessor_tpu_torch.utils.metrics import METRICS
    from imageprocessor_tpu_torch.utils.tracing import span

    n = 32
    counters = kernel_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    P, T = OperationParams, OperationType
    plan = normalize_operations([
        P(T.THUMBNAIL, {"size": 200, "crop_to_fit": True}),
        P(T.RESIZE, {"width": 1024, "height": 768, "keep_aspect": True})])
    sources = [jpeg(photo(3000, 4000, 2100 + s), True) for s in range(8)]
    blobs = [sources[k % len(sources)] for k in range(n)]

    class Store:
        def save_processed(self, path, data, mime=None):
            pass

    engine = TorchProcessingEngine(Store(), device="cuda:0", batch_size=n)
    operands = []
    inner = engine_mod.decode_coefs

    def decode_coefs(*args):
        operands.append([a.clone() for a in args[:5]])
        return inner(*args)

    def packed(group, b, device):
        """The packed path: Group.pack's host canvases, each copied to the
        card from pageable memory."""
        with span("pack", images=len(group.items)):
            imgs, src_hw = host_planes(group).pack(pad_batch_to=b)
        return [engine_mod._h2d(a, device) for a in imgs], src_hw

    def scanned():
        with ThreadPoolExecutor(3) as ex:
            decoded = list(ex.map(
                lambda blob: engine.decode_for_plan_ex(blob, plan, "jpeg"), blobs))
        [group] = group_items([
            BatchItem(item_id=str(k), image=arr, plan_key=plan.group_key(),
                      payload=(k, None, "jpeg", plan), layout=layout,
                      valid_hw=hw, splice=sctx)
            for k, (arr, _f, layout, hw, sctx) in enumerate(decoded)], max_batch=n)
        return group

    def run(path):
        """A warm call, whose B1 operands are kept, then a measured one,
        each on fresh scans."""
        if path == "packed":
            engine._stage_coefs = packed
        try:
            engine_mod.decode_coefs = decode_coefs
            try:
                engine.device_group(scanned())
            finally:
                engine_mod.decode_coefs = inner
            group = scanned()
            torch.cuda.synchronize(0)
            base = torch.cuda.memory_allocated(0)
            torch.cuda.reset_peak_memory_stats(0)
            METRICS.reset()
            out = engine.device_group(group)
            torch.cuda.synchronize(0)
            peak = torch.cuda.max_memory_allocated(0) - base
        finally:
            engine.__dict__.pop("_stage_coefs", None)
        snap = METRICS.snapshot()
        t, c = snap["timings"], snap["counters"]
        return out, {
            "pack_ms": t["span_pack_ms"]["sum"],
            "h2d_gb_s": c["engine_h2d_bytes"] / t["span_h2d_ms"]["sum"] / 1e6,
            "h2d_bytes": c["engine_h2d_bytes"],
            "pinned_share": c.get("engine_h2d_pinned_bytes", 0) / c["engine_h2d_bytes"],
            "misses": c.get("engine_stage_pool_misses", 0),
            "entropy": entropy_counts(),
            "device_ms": t["span_device_ms"]["sum"], "peak_mb": peak / 1e6}

    try:
        outs, stats = {}, {"staged": [], "packed": []}
        for path in ("staged", "packed", "packed", "staged"):
            outs[path], st = run(path)
            stats[path].append(st)
            log(f"[21 staging] {card}: {n} x 3000x4000 q85, {path}: pack "
                f"{st['pack_ms']:.3f} ms ({st['pack_ms'] / n:.4f} ms/image), h2d "
                f"{st['h2d_gb_s']:.2f} GB/s ({st['h2d_bytes']} B, from slabs "
                f"{st['pinned_share']:.4f}), misses {st['misses']}, device span "
                f"{st['device_ms']:.1f} ms, peak {st['peak_mb']:.1f} MB above the "
                "allocation before")
    finally:
        engine.close()
    # one B1 launch kept a run, staged first: all four on the same bytes
    if len(operands) != 4 or not all(
            all(torch.equal(x, y) for x, y in zip(operands[0], other))
            for other in operands[1:]):
        fail("phase 21: B1's operands differ between the staged and packed paths")
    (plan_s, out_s, hws_s, _), (plan_p, out_p, hws_p, _) = outs["staged"], outs["packed"]
    if not (len(out_s) == len(out_p) and all(
            np.array_equal(a, b) for a, b in zip(out_s, out_p))
            and all(np.array_equal(hws_s[k], hws_p[k]) for k in hws_p)):
        fail("phase 21: the staged path's outputs differ from the packed path's")
    for st in stats["staged"]:
        if st["pinned_share"] < 0.95 or st["misses"]:
            fail(f"phase 21: staged copies from slabs {st['pinned_share']:.4f}, "
                 f"misses {st['misses']}")
        if st["entropy"] != {"uploads": n, "fallbacks": 0}:
            fail(f"phase 21: the staged path's B0 counters {st['entropy']}")
    launched = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    require_card_entropy("phase 21", launched["B0"], stats["staged"][0]["entropy"])
    log(f"[21 staging] {card}: B1's operands and the outputs byte-identical over "
        "both paths")
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def phase_entropy(card: str) -> dict:
    """Phase 23: kernel B0 per 12 MP upload beside the host scan and the
    plain version; every canvas bit-exact against the host scan."""
    from perfbench import pool

    from imageprocessor_tpu_torch.ops import jpeg_entropy as je
    from imageprocessor_tpu_torch.runtime import hostcodec

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2300000023)
    blobs = [pool.encode(x) for x in pool.synthesize(gen, 8, 3000, 4000, "cuda")]
    t0 = time.perf_counter()
    scans = [hostcodec.scan_jpeg_coefficients(b) for b in blobs]
    host_ms = (time.perf_counter() - t0) / len(blobs) * 1e3

    def sectors(planes) -> int:
        """The 32-byte sectors B0 writes for one upload: those holding a
        block's DC or a non-zero coefficient (each plane's rows are whole
        sectors: 4000 and 2000 int16 wide)."""
        total = 0
        for p in planes:
            wrote = p != 0
            wrote[::8, ::8] = True
            total += int(wrote.reshape(-1, 16).any(axis=1).sum())
        return total

    def group(bl, device):
        """B0's operands for ``bl`` as one group on ``device``, and a call
        that zeroes the canvases, waits, then times the decode."""
        streams = [je.stage(b) for b in bl]
        ops = je.upload(streams, list(range(len(bl))), device)
        canvases = [torch.zeros((len(bl), *p.shape), dtype=torch.int16,
                                device=device) for p in scans[0][0]]

        def call():
            for c in canvases:
                c.zero_()
            if device == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            status, rounds = je.decode(ops, canvases)
            return (time.perf_counter() - t) * 1e3, status, rounds
        return canvases, call, sum(st.nbytes for st in streams)

    def timed(call, repeat=5):
        runs = [call() for _ in range(repeat)]
        return min(r[0] for r in runs), runs[-1][1], runs[-1][2]

    n0 = je.launches
    out = {"host_scan_ms": host_ms}
    big = [blobs[k % len(blobs)] for k in range(32)]
    canvases, call, stream_bytes = group(big, "cuda")
    call()   # the module's first launch
    ms32, status, rounds = timed(call)
    if status.tolist() != [0] * 32:
        fail(f"phase 23: B0 flagged {status.tolist()}")
    for i, blob in enumerate(big):
        for c, p in zip(canvases, scans[i % len(blobs)][0]):
            if not torch.equal(c[i].cpu(), torch.from_numpy(p)):
                fail(f"phase 23: B0's canvas of upload {i} differs from the host scan")
    sector_bytes = 32 * sum(sectors(scans[k % len(blobs)][0]) for k in range(32))
    out.update(ms_per_upload_32=ms32 / 32, rounds_32=rounds,
               stream_mb_per_upload=stream_bytes / 32 / 1e6,
               written_mb_per_upload=sector_bytes / 32 / 1e6)
    singles = []
    for blob in blobs[:4]:
        _c, call1, _n = group([blob], "cuda")
        ms1, st1, r1 = timed(call1, 3)
        if st1.tolist() != [0]:
            fail(f"phase 23: B0 flagged a single upload: {st1.tolist()}")
        singles.append((ms1, r1))
    out["ms_per_upload_1"] = min(m for m, _r in singles)
    out["rounds_1"] = [r for _m, r in singles]
    cpu_canvases, cpu_call, _n = group(blobs[:1], "cpu")
    out["plain_ms"], cpu_status, _r = cpu_call()
    if cpu_status.tolist() != [0] or not all(
            torch.equal(c[0], torch.from_numpy(p))
            for c, p in zip(cpu_canvases, scans[0][0])):
        fail("phase 23: the plain version differs from the host scan")
    least = (stream_bytes + sector_bytes) / 32
    out.update(bound_ms=least / HBM_BYTES_S * 1e3, bound_mb=least / 1e6,
               launches=je.launches - n0)
    out["roofline_share"] = out["bound_ms"] / out["ms_per_upload_32"]
    log(f"[23 entropy] {card}: B0 {out['ms_per_upload_32']:.4f} ms per 12 MP upload "
        f"in a group of 32 ({rounds} sync rounds), {out['ms_per_upload_1']:.3f} ms "
        f"alone (rounds {out['rounds_1']}); host scan {host_ms:.2f} ms, plain "
        f"version {out['plain_ms']:.0f} ms per upload; least bytes "
        f"{out['bound_mb']:.2f} MB (stream {out['stream_mb_per_upload']:.2f} MB read, "
        f"{out['written_mb_per_upload']:.2f} MB of sectors written) = "
        f"{out['bound_ms']:.4f} ms at 3.35 TB/s (share {out['roofline_share']:.4f}); "
        "canvases bit-exact against the host scan")
    log(json.dumps({"b0": out}))
    return out


def group_check(run) -> dict:
    """A Kafka group's run of the benchmark's harness (``harness.Run``)
    held to perfbench/group_reference.py: each member's id and partitions
    from its own client, the partitions range assignment gives those ids,
    and which member completed each judged upload against the owner of
    its key (the image id, as the API keys its produce)."""
    from perfbench import group_reference as ref

    env = run.cfg["env"]
    group, n = env["KAFKA_GROUP_ID"], int(env["BROKER_PARTITIONS"])
    views = [w.broker._consumers[(run.topic, group)] for w in run.workers]
    ids = [c.member_id for c in views]
    want = ref.range_assign(ids, range(n))
    by = {i: run.completed_by.get(i, []) for i in run.judged}
    return {"judged": len(by),
            "member_partitions": [sorted(c.partitions) for c in views],
            "range_assign": [want[m] for m in ids],
            "member_completed": [sum(k in ks for ks in by.values())
                                 for k in range(len(ids))],
            "not_once": sum(len(ks) != 1 for ks in by.values()),
            "misrouted": sum(ids[k] != ref.owner(i.encode(), ids, n)
                             for i, ks in by.items() for k in ks)}


def phase_group(card: str) -> dict:
    """Phase 22: the benchmark's Kafka group cell on three seeds with a
    10 s window, every run correct, its child exited 0, the assignment
    and every completion as perfbench/group_reference.py gives them.
    Returns the launches."""
    from perfbench import harness

    from imageprocessor_tpu_torch.ops import jpeg_entropy

    seeds = (3220000001, 3220000002, 3220000003)

    counters = kernel_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    for seed in seeds:
        line, run = harness.run_cell("kafka-topology.camera12mp-backlog", seed,
                                     10.0, False, "cuda:0")
        got = group_check(run)
        require_card_entropy(f"phase 22 seed {seed}", jpeg_entropy.launches,
                             entropy_counts())
        rate = line["metrics"]["images_per_s"]["value"]
        log(f"[22 group] seed {seed}: {rate:.2f} images/s, correct {line['correct']}, "
            f"failed {line['failed']}, {json.dumps(got)}, "
            f"kafkaserver exit {run.extra['service_exit']}; {card}")
        if not line["correct"] or line["failed"]:
            fail(f"phase 22: seed {seed} not correct: {line['checks']}")
        if run.extra["service_exit"] != {"kafkaserver": 0}:
            fail(f"phase 22: kafkaserver exit {run.extra['service_exit']}")
        if got["member_partitions"] != got["range_assign"] or got["not_once"] \
                or got["misrouted"]:
            fail(f"phase 22: the group departs from group_reference: {got}")
    log(f"[22 group] {len(seeds)} seeds: every upload completed once, by its "
        "key's owner under range assignment")
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def main_sources() -> list:
    """Phase 5's originals as (pixels, 4:2:0?): eight 12 MP photos, 1920 x
    1080 and 640 x 480, all 4:2:0, and 1600 x 1200 at 4:4:4."""
    sources = [(photo(3000, 4000, s), True) for s in range(8)]
    sources += [(photo(1080, 1920, 8), True), (photo(480, 640, 9), True),
                (photo(1200, 1600, 10), False)]        # last: 4:4:4
    return sources


def main(argv: list[str] | None = None) -> int:
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--phase", choices=["19", "21", "22", "23"],
                      help="run only phases 1, 2 and this one (19: routes "
                           "and replicas, 21: the staging, 22: the Kafka "
                           "group, 23: kernel B0; on a host with any number "
                           "of cards); "
                           "prints its launches and the card line, not the "
                           "kernels line")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from imageprocessor_tpu_torch import kernels
    from imageprocessor_tpu_torch.bench import card_line, ensure_font, load_oracle, time_ms
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
    from imageprocessor_tpu_torch.ops import extra
    from imageprocessor_tpu_torch.ops import fused_resample as fr
    from imageprocessor_tpu_torch.ops import jpeg_entropy, jpeg_kernels
    from imageprocessor_tpu_torch.ops import planar_resample as pr
    from imageprocessor_tpu_torch.ops import watermark as wm
    from imageprocessor_tpu_torch.ops.coords import center_crop_rect, keep_aspect_dims
    from imageprocessor_tpu_torch.ops.jpeg_decode import decode_ycbcr
    from imageprocessor_tpu_torch.ops.jpeg_encode import (
        encode_420_plain,
        quality_qtables,
    )
    from imageprocessor_tpu_torch.ops.resize import resize_image
    from imageprocessor_tpu_torch.ops.thumbnail import thumbnail_image
    from imageprocessor_tpu_torch.runtime import coeftx, hostcodec, splice
    from imageprocessor_tpu_torch.runtime.batcher import (
        BatchItem,
        coef_factors,
        group_items,
        quantize_batch,
    )
    from imageprocessor_tpu_torch.runtime.codecs import decode_image
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
    log(f"[1 device] watermark font: {ensure_font()}")

    # ---- 2. build
    t0 = time.monotonic()
    kernels.library()
    t1 = time.monotonic()
    hostcodec.library()
    t2 = time.monotonic()
    log(f"[2 build] kernels (one nvcc sm_90a per csrc/*.cu, in parallel) "
        f"{t1 - t0:.2f} s, host JPEG + GIF library (g++) {t2 - t1:.2f} s")
    if args.phase:
        if args.phase == "21":
            launched = phase_staging(card)
        elif args.phase == "22":
            launched = phase_group(card)
        elif args.phase == "23":
            launched = phase_entropy(card)["launches"]
        else:
            blobs = [jpeg(img, sub) for img, sub in main_sources()]
            launched = phase_routes(card, oracle, blobs)
        print(json.dumps({"phase": args.phase, "launches": launched}))
        print(card)
        return 0

    # ---- 3. B1 vs plain
    b1_err = 0
    for fh, fw in MODES:
        errs = []
        for tag, (ch, cw, dims, out_hw, pad) in b1_cases(fh, fw).items():
            args = coef_case(dims, ch, cw, fh, fw, seed=fh * 10 + fw, pad_to=pad)
            got = jpeg_kernels.decode_coefs(*args, fh, fw, out_hw)
            want = decode_ycbcr(*args, fh=fh, fw=fw, out_h=out_hw[0],
                                out_w=out_hw[1])
            torch.cuda.synchronize()
            err = max_err(got, want, dims)
            errs.append(f"{tag} {err}")
            b1_err = max(b1_err, err)
            if err > LSB_LIMIT:
                fail(f"B1 {fh}x{fw} {tag}: {err} LSB")
        log(f"[3 B1] {fh}x{fw} max |kernel - plain| LSB per case: " + ", ".join(errs))
    big_dims = [(3000, 4000)] * 6 + [(2000, 3000), (3072, 4096)]
    for fh, fw in ((1, 2), (2, 1), (2, 2)):   # 4:2:0 last: phase 6 times it
        big = coef_case(big_dims, H, W, fh, fw, seed=7 if fh * fw == 4 else 7 + fh)
        got = jpeg_kernels.decode_coefs(*big, fh, fw, (H, W))
        want = decode_ycbcr(*big, fh=fh, fw=fw)
        err = max_err(got, want, big_dims)
        del got, want
        b1_err = max(b1_err, err)
        log(f"[3 B1] {fh}x{fw} 8x3072x4096: max |kernel - plain| = {err} LSB")
        if err > LSB_LIMIT:
            fail(f"B1 {fh}x{fw} 8x3072x4096: {err} LSB")
    log(f"[3 B1] every case: max |kernel - plain| = {b1_err} LSB (limit {LSB_LIMIT})")

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
    sources = main_sources()
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
        jpeg_entropy.launches = 0
        METRICS.reset()
        t0 = time.monotonic()
        results = engine.process_tasks(work)
        wall = time.monotonic() - t0
        launches = {"B0": jpeg_entropy.launches, "B1": jpeg_kernels.launches,
                    "B2": fr.launches}
        require_card_entropy("phase 5's main path", launches["B0"], entropy_counts())

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
            packed, ghw = host_planes(group).pack(pad_batch_to=outs[0].shape[0])
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
    b1_b = b1_bound(big, 2, 2, (H, W))
    b2_b = resample_bound([taps_t, taps_r])
    log(f"[6 timing] {card}: {bound_line('B1', b1_ms, b1_b)}")
    log(f"[6 timing] {card}: {bound_line('B2', b2_ms, b2_b)}")
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

    # ---- 7. B3 vs plain
    qt85 = torch.from_numpy(quality_qtables(85).astype(np.float32)).cuda()
    b3_err = 0
    errs = []
    for tag, (ch, cw, dims, pad, bucket) in b3_cases().items():
        bh, bw = bucket or (ch, cw)
        rgb, vh = rgb_case(dims, bh, bw, seed=ch + cw, pad_to=pad)
        rgb = rgb[:, :, :ch, :cw]
        got = jpeg_kernels.encode_420(rgb, vh, qt85)
        want = encode_420_plain(rgb, vh, qt85)
        torch.cuda.synchronize()
        err, n = coef_err(got, want, dims + [(1, 1)] * (pad - len(dims)))
        errs.append(f"{tag} {err} ({n})")
        b3_err = max(b3_err, err)
        if err > STEP_LIMIT:
            fail(f"B3 {tag}: {err} steps")
    log("[7 B3] max |kernel - plain| steps (coefficients that differ) per "
        "case: " + ", ".join(errs))
    # the C entry point itself refuses what the wrapper would have copied
    rgb, vh = rgb_case([(16, 16)], 16, 32, seed=1)
    outs = [torch.empty(n, dtype=torch.int16, device="cuda") for n in (256, 64, 64)]
    for what, off, s_row in (("base", 4, 32), ("row stride", 0, 36)):
        rc = kernels.library().ip_encode_420(
            rgb.data_ptr() + off, rgb.stride(0), rgb.stride(1), s_row,
            vh.data_ptr(), qt85.data_ptr(), *(o.data_ptr() for o in outs), 1, 16,
            16, rgb.device.index, kernels.stream_ptr(rgb.device))
        if rc == 0:
            fail(f"B3's C entry point took a misaligned {what}")
    log("[7 B3] ip_encode_420 refuses a base and a row stride that are not "
        "multiples of 8")
    big_vh = torch.from_numpy(src_hw.astype(np.int32)).cuda()
    err, n = coef_err(jpeg_kernels.encode_420(src, big_vh, qt85),
                      encode_420_plain(src, big_vh, qt85), src_hw.tolist())
    b3_err = max(b3_err, err)
    log(f"[7 B3] 8x3072x4096: max |kernel - plain| = {err} steps, {n} "
        f"coefficients differ")
    if b3_err > STEP_LIMIT:
        fail(f"B3 8x3072x4096: {err} steps")
    log(f"[7 B3] every case: max |kernel - plain| = {b3_err} steps "
        f"(limit {STEP_LIMIT})")

    # ---- 8. B4 vs plain
    b4_err = 0
    for t in (taps_t, taps_a, taps_r,
              fr.make_taps(src_hw, resize_hw(src_hw, 6000, 4500), (4500, 6000),
                           (H, W)).to("cuda")):
        err = int((pr.planar_resample(src, t).int()
                   - fr.resample_plain(src, t).int()).abs().max())
        b4_err = max(b4_err, err)
    if b4_err > LSB_LIMIT:
        fail(f"B4 vs plain: {b4_err} LSB")
    log(f"[8 B4] crop + aspect thumbnails, 1024x768 resize, 6000x4500 upscale: "
        f"max |kernel - plain| = {b4_err} LSB (limit {LSB_LIMIT})")

    # ---- 9. every upload-form plan through the worker's steps
    thumb, resize = default_ops

    def mark(text="© ImageProcessor"):
        return OperationParams(OperationType.WATERMARK, {
            "text": text, "opacity": 0.5, "position": "bottom-right"})

    form = {flags: [op for flag, op in zip("trw", (thumb, resize, mark()))
                    if flag in flags]
            for flags in ("t", "r", "w", "tr", "tw", "rw", "trw")}
    counters = kernel_counters()
    workdir = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(REPO, "build"))
    store = LocalFSObjectStore(os.path.join(workdir, "objects"))
    meta = SQLiteMetadataStore(os.path.join(workdir, "meta.db"))
    broker = MemoryBroker()
    broker.create_topic(KAFKA_TOPIC_PROCESSING, 3)
    engine = TorchProcessingEngine(store, device="cuda", batch_size=B)

    def worker_steps(blobs_in, ops, fmt="jpeg"):
        """Upload rows + task JSON -> poll -> process_tasks -> rows -> ack,
        with every launch count set to 0 just before process_tasks and
        read just after. Returns ([(task, result)] in upload order,
        launches, wall seconds)."""
        ids = []
        for k, blob in enumerate(blobs_in):
            path = store.save_original(f"form{k}", blob, "application/octet-stream")
            image_id = str(uuid.uuid4())
            meta.save_image(Image(id=image_id, original_filename=f"form{k}",
                                  original_size=len(blob), mime_type="image/jpeg",
                                  status=ImageStatus.PROCESSING,
                                  original_path=path, bucket="images"))
            broker.produce(KAFKA_TOPIC_PROCESSING, image_id.encode(), ProcessingTask(
                id=str(uuid.uuid4()), image_id=image_id, original_path=path,
                bucket="images", operations=ops, format=fmt).to_json())
            ids.append(image_id)
        msgs = broker.poll(KAFKA_TOPIC_PROCESSING, KAFKA_GROUP_ID,
                           max_n=len(ids), lease_s=600)
        tasks = [ProcessingTask.from_json(m.value) for m in msgs]
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        METRICS.reset()
        t0 = time.monotonic()
        results = engine.process_tasks(
            [(t, store.get_object(t.original_path)) for t in tasks])
        wall = time.monotonic() - t0
        counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        if entropy_counts()["fallbacks"]:
            fail(f"form task {ops}: B0 flagged uploads: {entropy_counts()}")
        for msg, task, res in zip(msgs, tasks, results):
            for art in res.artifacts:
                meta.save_processed_image(ProcessedImage(
                    id="", image_id=task.image_id, operation=art.operation,
                    path=art.path, size=art.size, mime_type=art.mime_type,
                    format=art.format, status="completed"))
            meta.update_status(task.image_id, res.result.status)
            broker.ack(msg)
        by_id = {t.image_id: (t, r) for t, r in zip(tasks, results)}
        for image_id in ids:
            task, res = by_id[image_id]
            if meta.get_image(image_id).status is not ImageStatus.COMPLETED:
                fail(f"form task {ops}: {res.result.status} {res.result.error}")
            rows = {p.operation.value if hasattr(p.operation, "value") else p.operation
                    for p in meta.list_processed(image_id)}
            if rows != {op.type.value for op in ops}:
                fail(f"form task {ops}: processed rows {rows}")
        return [by_id[i] for i in ids], counts, wall

    def stage_line() -> str:
        """The engine's stage metrics of the last worker_steps call: the
        largest group's device and finish (encode, emit, splice, save)
        stages, and the splice and coefficient-transform emits per image."""
        snap = METRICS.snapshot()
        t = snap["timings"]
        parts = [f"{k.split('_', 1)[1]} max {t[k]['max']:.1f}" for k in (
            "engine_decode_ms", "span_device_ms", "engine_encode_ms") if k in t]
        for k in ("engine_splice_emit_ms", "engine_coeftx_emit_ms"):
            if k in t:
                parts.append(f"{k[7:]} p50 {t[k]['p50']:.2f} max {t[k]['max']:.2f}")
        n = int(snap["counters"].get("engine_splice_images", 0))
        m = int(snap["counters"].get("engine_coeftx_images", 0))
        return "; ".join(parts) + f"; spliced {n}; from coefficients {m}"

    def artifact_px(res, op):
        return decode_image(store.get_object(res.result.processed_paths[op]))[0]

    def check_dims(res, h, w):
        for op, path in res.result.processed_paths.items():
            got = decode_image(store.get_object(path))[0].shape[:2]
            want = {"thumbnail": (200, 200), "watermark": (h, w),
                    "resize": keep_aspect_dims(w, h, 1024, 768)[::-1]}[op]
            if tuple(got) != tuple(want):
                fail(f"{path}: {got} != {want}")

    def check_mark(got, twin, h, w, what):
        """got differs from twin inside the text box and nowhere else."""
        y0, y1, x0, x1 = text_box(wm, "© ImageProcessor", "bottom-right", h, w)
        if not (got[y0:y1, x0:x1] != twin[y0:y1, x0:x1]).any():
            fail(f"{what}: no watermark inside the text box")
        outside = np.ones((h, w), bool)
        outside[max(y0 - WM_MARGIN, 0):y1 + WM_MARGIN,
                max(x0 - WM_MARGIN, 0):x1 + WM_MARGIN] = False
        if (got != twin)[outside].any():
            fail(f"{what}: pixels changed outside the text box")

    def plan_groups(plan, fmt="jpeg"):
        """Phase 5's sources decoded for a plan and grouped, as
        process_tasks does; fmt is the renditions' format."""
        items = []
        for k, blob in enumerate(blobs):
            arr, _f, layout, hw, sctx = engine.decode_for_plan_ex(blob, plan, fmt)
            items.append(BatchItem(item_id=str(k), image=arr, plan_key=plan.group_key(),
                                   payload=(k, None, fmt, plan), layout=layout,
                                   valid_hw=hw, splice=sctx))
        return group_items(items, max_batch=B)

    def plain_group_check(ops):
        """Group outputs of a plan vs the plain versions on the plain
        decode: resamples <= 1 LSB, B3 canvases <= 1 step."""
        plan = normalize_operations(ops)
        lsb = step = 0
        for group in plan_groups(plan):
            _, outs, out_hws, _ = engine.device_group(group)
            packed, ghw = host_planes(group).pack(
                pad_batch_to=quantize_batch(len(group.items)))
            fh, fw = coef_factors(group.layout)
            dec = decode_ycbcr(*(torch.from_numpy(a).cuda() for a in packed),
                               fh=fh, fw=fw, out_h=group.bucket[0],
                               out_w=group.bucket[1])
            specs = plan_output_specs(plan)
            taps = step_taps(group.bucket, ghw, out_hws, specs, torch.device("cuda"))
            dims = [it.hw for it in group.items]
            for oi, op in enumerate(plan.ops):
                if oi in taps:
                    want = fr.resample_plain(dec, taps[oi]).cpu().numpy()
                    for i in range(len(dims)):
                        oh, ow = out_hws[oi][i] if oi in out_hws else want.shape[2:]
                        lsb = max(lsb, int(np.abs(
                            outs[oi][i][:, :oh, :ow].astype(int)
                            - want[i][:, :oh, :ow].astype(int)).max()))
            for oi, op in enumerate(plan.ops):
                if op.type is not OperationType.WATERMARK:
                    continue
                if outs[oi][0] != "coef420":
                    fail(f"plan {ops}: watermark not encoded by B3")
                tile = wm.quantize_tile(wm.rasterize_text(op.text, op.font_size))
                r, g, b, a = wm.resolve_color(op.font_color, op.opacity)
                wm.watermark_planar_(dec, ghw, tile, (r, g, b), a / 255.0, op.position)
                mh = -(-max(h for h, _ in dims) // 16) * 16
                mw = -(-max(w for _, w in dims) // 16) * 16
                canvas = torch.nn.functional.pad(
                    dec[:, :, :mh, :mw], (0, max(mw - dec.shape[3], 0),
                                          0, max(mh - dec.shape[2], 0)))
                vh = np.ones((dec.shape[0], 2), np.int32)
                vh[:len(dims)] = dims
                want = encode_420_plain(canvas, torch.from_numpy(vh).cuda(), qt85)
                step = max(step, coef_err([torch.from_numpy(x) for x in outs[oi][1:4]],
                                          [x.cpu() for x in want], dims)[0])
        return lsb, step

    form_launches = {"B0": 0, "B3": 0, "B4": 0}
    form_lsb = form_step = 0
    src_px = [decode_image(b)[0] for b in blobs]
    try:
        for splice_on in (True, False):
            os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "1" if splice_on else "0"
            mode = "splice on" if splice_on else "splice off"
            if splice_on:
                twins = src_px
            else:   # the same path with a blank text: the unwatermarked JPEG
                pairs, _, _ = worker_steps(blobs, [mark(" ")])
                twins = [artifact_px(r, "watermark") for _, r in pairs]
            for flags, ops in form.items():
                pairs, counts, wall = worker_steps(blobs, ops)
                stages = stage_line()
                n_resample = sum(f in flags for f in "tr")
                want_b3 = "w" in flags and not splice_on
                # a spliced watermark keeps the host's splice scan
                want_b0 = not ("w" in flags and splice_on)
                if ((counts["B2"] > 0) != (n_resample == 2)
                        or (counts["B4"] > 0) != (n_resample == 1)
                        or (counts["B3"] > 0) != want_b3
                        or (counts["B0"] > 0) != want_b0):
                    fail(f"plan {flags} ({mode}): launches {counts}")
                for k in form_launches:
                    form_launches[k] += counts[k]
                for k, (task, res) in enumerate(pairs):
                    _, h, w = sources[k][0].shape
                    check_dims(res, h, w)
                    if "w" in flags:
                        got = artifact_px(res, "watermark")
                        check_mark(got, twins[k], h, w, f"plan {flags} ({mode}) #{k}")
                        if splice_on and not np.array_equal(got[:h // 2], src_px[k][:h // 2]):
                            fail(f"plan {flags} #{k}: spliced top half differs")
                log(f"[9 form] plan {flags:>3} ({mode}): {len(pairs)} tasks COMPLETED "
                    f"in {wall:.3f} s (host clock); launches {counts}; ms: {stages}")
            if not splice_on:
                for flags in ("t", "r", "w", "trw"):
                    lsb, step = plain_group_check(form[flags])
                    form_lsb, form_step = max(form_lsb, lsb), max(form_step, step)
                if form_lsb > LSB_LIMIT or form_step > STEP_LIMIT:
                    fail(f"form group outputs vs plain: {form_lsb} LSB, {form_step} steps")
                log(f"[9 form] group outputs of plans t, r, w, trw (splice off) vs "
                    f"plain versions: resamples {form_lsb} LSB, B3 {form_step} steps")
        os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "1"
        # non-JPEG sources never splice: device blend + B3 for the watermark
        for fmt, h, w in (("PNG", 480, 640), ("GIF", 300, 400)):
            img = photo(h, w, 20 + h).transpose(1, 2, 0)
            bio = io.BytesIO()
            PILImage.fromarray(img).save(bio, format=fmt)
            blob = bio.getvalue()
            [(_, twin)], _, _ = worker_steps([blob], [mark(" ")], fmt.lower())
            [(_, res)], counts, _ = worker_steps([blob], form["trw"], fmt.lower())
            # a PNG upload's watermark stays PNG; a GIF's is re-encoded as
            # JPEG (watermark.go), through B3
            if (counts["B2"] == 0 or (counts["B3"] > 0) != (fmt == "GIF")
                    or counts["B0"]):
                fail(f"{fmt} source: launches {counts}")
            check_dims(res, h, w)
            check_mark(artifact_px(res, "watermark"), artifact_px(twin, "watermark"),
                       h, w, fmt)
            exts = {op: p.rsplit(".", 1)[1] for op, p in res.result.processed_paths.items()}
            want_ext = fmt.lower()
            if exts != {"thumbnail": want_ext, "resize": want_ext,
                        "watermark": "png" if fmt == "PNG" else "jpeg"}:
                fail(f"{fmt} source: artifact formats {exts}")
            log(f"[9 form] {fmt} {w}x{h} source, every flag: COMPLETED, formats "
                f"{exts}, launches {counts}")
    finally:
        os.environ.pop("IMAGEPROCESSOR_JPEG_SPLICE", None)
        engine.close()
        meta.close()
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- 10. timing at 8 x 3072 x 4096
    b3_ms = time_ms(lambda: jpeg_kernels.encode_420(src, big_vh, qt85))
    b3_plain = time_ms(lambda: encode_420_plain(src, big_vh, qt85), iters=3)
    b4_ms = time_ms(lambda: pr.planar_resample(src, taps_r))
    b4_plain = time_ms(lambda: fr.resample_plain(src, taps_r), iters=5)
    tile = wm.quantize_tile(wm.rasterize_text("© ImageProcessor", 36.0))
    color, alpha = (255, 255, 255), 127 / 255.0

    def blend(canvas):
        return wm.watermark_planar_(canvas, src_hw, tile, color, alpha, "bottom-right")

    canvas = src.clone()
    blend_ms = time_ms(lambda: blend(canvas))

    def splice_off_step():
        rgb = jpeg_kernels.decode_coefs(*big, 2, 2, (H, W))
        fr.fused_resample(rgb, taps_t, taps_r)
        jpeg_kernels.encode_420(blend(rgb), big_vh, qt85)

    off_ms = time_ms(splice_off_step)
    log(f"[10 timing] {card}: B3 {b3_ms:.4f} ms (plain {b3_plain:.4f} ms), "
        f"B4 resize to 1024x768 {b4_ms:.4f} ms (plain {b4_plain:.4f} ms), "
        f"blend {blend_ms:.4f} ms per 8x3072x4096 batch; splice-off step "
        f"B1 -> B2 -> blend -> B3 {off_ms:.4f} ms = {B * 1000.0 / off_ms:.1f} "
        f"images/s (CUDA events)")
    b3_b = b3_bound(src, big_vh)
    b4_b = resample_bound([taps_r])
    log(f"[10 timing] {card}: {bound_line('B3', b3_ms, b3_b)}")
    log(f"[10 timing] {card}: {bound_line('B4', b4_ms, b4_b)}")

    # ---- 11. crop, flip, rotate and grayscale plans through the worker's steps
    def op_of(kind, **params):
        return OperationParams(OperationType(kind), params)

    crop_a = op_of("crop", x=512, y=256, width=1024, height=768)   # MCU-aligned origin
    crop_u = op_of("crop", x=301, y=203, width=1500, height=1100)
    tx_plans = {
        "crop_aligned": [crop_a], "crop_unaligned": [crop_u],
        "flip_h": [op_of("flip", direction="horizontal")],
        "flip_v": [op_of("flip", direction="vertical")],
        "rot90": [op_of("rotate", angle=90)], "rot180": [op_of("rotate", angle=180)],
        "rot270": [op_of("rotate", angle=270)], "rot30": [op_of("rotate", angle=30)],
        "grayscale": [op_of("grayscale")],
        "mixed": [thumb, resize, op_of("grayscale"), crop_u],
    }
    # plans the coefficient domain serves when source and renditions are JPEGs
    coef_plans = {"crop_aligned", "crop_unaligned", "flip_h", "flip_v", "rot90",
                  "rot180", "rot270"}
    b3_plans = {"flip_h", "flip_v", "grayscale", "mixed"}   # a full-bucket JPEG output

    def out_dims(o, h, w):
        """Valid (h, w) of a normalized op's output on an h x w image."""
        kind = o.type.value
        if kind == "crop":
            x, y = min(o.x, w - 1), min(o.y, h - 1)
            return max(1, min(o.height, h - y)), max(1, min(o.width, w - x))
        if kind == "rotate" and o.angle % 180.0 == 90.0:
            return w, h
        if kind == "thumbnail":
            return o.size, o.size
        if kind == "resize":
            return keep_aspect_dims(w, h, o.width, o.height)[::-1]
        return h, w

    def check_tx_dims(res, plan, h, w, what):
        for o in plan.ops:
            data = store.get_object(res.result.processed_paths[o.type.value])
            if data[:2] == b"\xff\xd8":
                got = tuple(hostcodec.scan_jpeg_coefficients(data)[2])[::-1]
            else:
                got = decode_image(data)[0].shape[:2]
            if tuple(got) != tuple(out_dims(o, h, w)):
                fail(f"{what} {o.type.value}: artifact {got} != {out_dims(o, h, w)}")

    def gray_f32(rgb):
        """ops/extra.py's float32 luma, evaluated by numpy on (3, h, w)."""
        f = np.float32
        r, g, b = (c.astype(f) * f(257.0) for c in rgb)
        y16 = (f(299.0) * r + f(587.0) * g + f(114.0) * b + f(500.0)) * f(0.001)
        return np.clip(np.floor(np.floor(y16) / f(256.0)), 0, 255).astype(np.uint8)

    def gray_go(rgb):
        """Go's color.GrayModel on 16-bit channels, int64, on (3, h, w)."""
        x = rgb.astype(np.int64) * 257
        return (((299 * x[0] + 587 * x[1] + 114 * x[2] + 500) // 1000) >> 8).astype(np.uint8)

    def rotate_f64(img, h, w, angle, eps=1e-3):
        """Float64 inverse-mapped bilinear rotation of the (h, w) image in
        the top-left of a (3, Hc, Wc) u8 canvas about its centre, on the
        card: (expected u8 canvas, mask of pixels whose source coordinate
        lies within eps of the validity boundary)."""
        f64 = torch.float64
        th = math.radians(angle)
        c, s = math.cos(th), math.sin(th)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        dy = torch.arange(img.shape[1], dtype=f64, device=img.device)[:, None] - cy
        dx = torch.arange(img.shape[2], dtype=f64, device=img.device)[None, :] - cx
        sx, sy = c * dx - s * dy + cx, s * dx + c * dy + cy
        near = (((sx + 0.5).abs() < eps) | ((sx - (w - 0.5)).abs() < eps)
                | ((sy + 0.5).abs() < eps) | ((sy - (h - 0.5)).abs() < eps))
        valid = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx, fy = sx - x0, sy - y0
        x0, y0 = x0.long(), y0.long()

        def g(yi, xi):
            return img[:, yi.clamp(0, h - 1), xi.clamp(0, w - 1)].to(f64)

        top = g(y0, x0) * (1 - fx) + g(y0, x0 + 1) * fx
        bot = g(y0 + 1, x0) * (1 - fx) + g(y0 + 1, x0 + 1) * fx
        out = torch.where(valid, top * (1 - fy) + bot * fy, torch.zeros((), dtype=f64,
                                                                      device=img.device))
        return out.round().clamp(0, 255).to(torch.uint8), near

    def tx_group_check(ops):
        """A plan's device outputs against numpy on B1's decoded bucket,
        per group of phase 5's sources. The items ask for PNG renditions,
        so every output comes back as pixels. Returns (max LSB of crop /
        flip / rotate by 90s / grayscale against numpy, max LSB of
        rotate 30 off the boundary pixels, boundary pixels, grayscale
        pixels that differ from Go's integers, grayscale pixels)."""
        plan = normalize_operations(ops)
        exact = rot = near_n = go_n = gray_n = 0
        for group in plan_groups(plan, "png"):
            if not group.layout.startswith("coef"):
                fail(f"plan {ops}: a JPEG source took layout {group.layout}")
            _, outs, out_hws, _ = engine.device_group(group)
            packed, _ = host_planes(group).pack(
                pad_batch_to=quantize_batch(len(group.items)))
            dec_t = engine._upload([torch.from_numpy(a).to(engine.device) for a in packed],
                                   group, engine.device)
            dec = dec_t.cpu().numpy()
            for oi, o in enumerate(plan.ops):
                kind = o.type.value
                if kind in ("thumbnail", "resize"):
                    continue   # held against the plain versions in phase 9
                for i, it in enumerate(group.items):
                    h, w = it.hw
                    oh, ow = out_dims(o, h, w)
                    if oi in out_hws and tuple(out_hws[oi][i]) != (oh, ow):
                        fail(f"{kind}: out_hws {out_hws[oi][i]} != {(oh, ow)}")
                    got = outs[oi][i][:, :oh, :ow]
                    src_i = dec[i][:, :h, :w]
                    if kind == "rotate" and o.angle % 90.0:
                        want, near = rotate_f64(dec_t[i], h, w, o.angle)
                        near = near[:h, :w].cpu().numpy()
                        d = np.abs(got.astype(np.int16)
                                   - want[:, :h, :w].cpu().numpy().astype(np.int16)).max(axis=0)
                        rot = max(rot, int(d[~near].max()))
                        near_n += int(near.sum())
                        continue
                    if kind == "crop":
                        x, y = min(o.x, w - 1), min(o.y, h - 1)
                        want = src_i[:, y:y + oh, x:x + ow]
                    elif kind == "flip":
                        want = (src_i[:, ::-1] if o.direction == "vertical"
                                else src_i[:, :, ::-1])
                    elif kind == "rotate":
                        want = np.rot90(src_i, int(o.angle // 90), axes=(1, 2))
                    else:   # grayscale
                        want = np.repeat(gray_f32(src_i)[None], 3, axis=0)
                        go_n += int((got[0] != gray_go(src_i)).sum())
                        gray_n += h * w
                        if np.abs(got[0].astype(np.int16)
                                  - gray_go(src_i).astype(np.int16)).max() > LSB_LIMIT:
                            fail("grayscale: more than 1 LSB from Go's integer formula")
                    if got.shape != want.shape:
                        fail(f"{kind}: output {got.shape} != {want.shape}")
                    exact = max(exact, int(np.abs(got.astype(np.int16)
                                                  - want.astype(np.int16)).max()))
        return exact, rot, near_n, go_n, gray_n

    def b3_group_check(ops):
        """B3's canvases of a plan's full-bucket JPEG outputs (grayscale,
        flip) against the plain encode of the same canvas, in steps."""
        plan = normalize_operations(ops)
        step = 0
        for group in plan_groups(plan):
            _, outs, _, _ = engine.device_group(group)
            packed, ghw = host_planes(group).pack(
                pad_batch_to=quantize_batch(len(group.items)))
            dec_t = engine._upload([torch.from_numpy(a).to(engine.device) for a in packed],
                                   group, engine.device)
            dims = [it.hw for it in group.items]
            for oi, o in enumerate(plan.ops):
                if o.type.value not in ("grayscale", "flip"):
                    continue
                if outs[oi][0] != "coef420":
                    fail(f"plan {ops}: {o.type.value} not encoded by B3")
                canvas = (extra.batched_grayscale_planar(dec_t)
                          if o.type.value == "grayscale"
                          else extra.batched_flip(dec_t, ghw, o.direction))
                mh = -(-max(h for h, _ in dims) // 16) * 16
                mw = -(-max(w for _, w in dims) // 16) * 16
                canvas = torch.nn.functional.pad(
                    canvas[:, :, :mh, :mw], (0, max(mw - canvas.shape[3], 0),
                                             0, max(mh - canvas.shape[2], 0)))
                vh = np.ones((canvas.shape[0], 2), np.int32)
                vh[:len(dims)] = dims
                want = encode_420_plain(canvas, torch.from_numpy(vh).cuda(), qt85)
                step = max(step, coef_err([torch.from_numpy(x) for x in outs[oi][1:4]],
                                          [x.cpu() for x in want], dims)[0])
        return step

    pixel_tx = {
        "crop_aligned": lambda a: a[256:256 + 768, 512:512 + 1024],
        "flip_h": lambda a: a[:, ::-1], "flip_v": lambda a: a[::-1],
        "rot90": lambda a: np.rot90(a, 1), "rot180": lambda a: np.rot90(a, 2),
        "rot270": lambda a: np.rot90(a, 3),
    }
    src_rgb: dict[int, np.ndarray] = {}   # source index -> float64-decoded pixels

    def lossless_check(name, pairs) -> int:
        """Coefficient-route artifacts of one plan, decoded by the float64
        decoder of runtime/splice.py, against the same transform of the
        decoded source, wherever every primitive is lossless. One 12 MP
        source and the three small ones. Returns how many were held."""
        o = normalize_operations(tx_plans[name]).ops[0]
        held = 0
        for k in (0, 8, 9, 10):
            planes, qt, size, samp = hostcodec.scan_jpeg_coefficients(blobs[k])
            mcu_w, mcu_h = 8 * samp[0][0], 8 * samp[0][1]
            prims = coeftx.eligible_prims(o, size, samp)
            if prims is None or any(
                    pr.endswith("_rs") if isinstance(pr, str)
                    else (pr[1] % mcu_w or pr[2] % mcu_h) for pr in prims):
                continue
            if name not in pixel_tx:
                continue
            if k not in src_rgb:
                src_rgb[k] = splice.decode_rgb(splice.coef_context(planes, qt, size, samp))
            data = store.get_object(pairs[k][1].result.processed_paths[o.type.value])
            got = splice.decode_rgb(splice.coef_context(
                *hostcodec.scan_jpeg_coefficients(data)))
            want = pixel_tx[name](src_rgb[k])
            if name == "crop_aligned":
                h, w = src_rgb[k].shape[:2]
                oh, ow = out_dims(o, h, w)
                want = want[:oh, :ow]
                # the chroma upsample clamps at the new plane's edges
                got, want = got[2:-2, 2:-2], want[2:-2, 2:-2]
            if not np.array_equal(got, want):
                fail(f"{name} source {k}: coefficient-route artifact differs "
                     f"from the transform of the decoded source")
            held += 1
        return held

    workdir = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(REPO, "build"))
    store = LocalFSObjectStore(os.path.join(workdir, "objects"))
    meta = SQLiteMetadataStore(os.path.join(workdir, "meta.db"))
    broker = MemoryBroker()
    broker.create_topic(KAFKA_TOPIC_PROCESSING, 3)
    engine = TorchProcessingEngine(store, device="cuda", batch_size=B)
    tx_launches = dict.fromkeys(counters, 0)
    single_launches = dict.fromkeys(counters, 0)
    n_jpeg = len(blobs)
    try:
        for splice_on in (True, False):
            os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "1" if splice_on else "0"
            mode = "splice on" if splice_on else "splice off"
            for pname, ops in tx_plans.items():
                plan = normalize_operations(ops)
                pairs, counts, wall = worker_steps(blobs, ops)
                stages = stage_line()
                snap = METRICS.snapshot()
                n_coef = int(snap["counters"].get("engine_coeftx_images", 0))
                dev = snap["timings"]["span_device_ms"]
                from_coefs = splice_on and pname in coef_plans
                if from_coefs:   # nothing packed, copied or launched
                    ok = (not any(counts.values()) and n_coef == n_jpeg
                          and not {"span_pack_ms", "span_h2d_ms"} & set(snap["timings"]))
                else:
                    # with the splice on, a plan of coefficient-domain ops
                    # scans on the host for the splice (rot30): no B0
                    ok = (counts["B1"] == dev["count"] and counts["B1"] >= 1
                          and (counts["B0"] >= 1 or splice_on)
                          and counts["B4"] == 0 and n_coef == 0
                          and counts["B2"] == (counts["B1"] if pname == "mixed" else 0)
                          and counts["B3"] == (counts["B1"] if pname in b3_plans else 0))
                if not ok:
                    fail(f"plan {pname} ({mode}): launches {counts}, device stage "
                         f"{dev}, from coefficients {n_coef}")
                for k in counts:
                    tx_launches[k] += counts[k]
                for k, (_task, res) in enumerate(pairs):
                    _, h, w = sources[k][0].shape
                    check_tx_dims(res, plan, h, w, f"plan {pname} ({mode}) #{k}")
                held = lossless_check(pname, pairs) if from_coefs else 0
                log(f"[11 transform] plan {pname:>14} ({mode}): {len(pairs)} tasks "
                    f"COMPLETED in {wall:.3f} s (host clock); launches {counts}; "
                    f"ms: {stages}"
                    + (f"; {held} lossless artifacts equal the transform of the "
                       f"decoded source" if from_coefs else ""))
        # still with the splice off: the group checks below run every plan
        # on the device
        tx_exact = tx_rot = tx_step = 0
        for pname, ops in tx_plans.items():
            exact, rot, near_n, go_n, gray_n = tx_group_check(ops)
            tx_exact, tx_rot = max(tx_exact, exact), max(tx_rot, rot)
            note = ""
            if pname == "rot30":
                note = (f"; rotate 30 vs float64 inverse map {rot} LSB off "
                        f"{near_n} boundary pixels")
            if gray_n:
                note += (f"; grayscale differs from Go's integers at {go_n} of "
                         f"{gray_n} pixels (by 1 LSB)")
            if pname in ("flip_h", "flip_v", "grayscale"):
                step = b3_group_check(ops)
                tx_step = max(tx_step, step)
                note += f"; B3 canvases vs plain encode {step} steps"
            log(f"[11 transform] plan {pname:>14}: device outputs vs numpy on B1's "
                f"bucket {exact} LSB{note}")
        if tx_exact > 0 or tx_rot > LSB_LIMIT or tx_step > STEP_LIMIT:
            fail(f"transform outputs: {tx_exact} LSB (limit 0), rotate 30 {tx_rot} "
                 f"LSB (limit {LSB_LIMIT}), B3 {tx_step} steps (limit {STEP_LIMIT})")

        os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "1"
        # a PNG source with every op: the pixel path, PNG renditions
        every = [thumb, resize, mark(), crop_u, op_of("rotate", angle=90),
                 op_of("flip", direction="horizontal"), op_of("grayscale")]
        png_img = photo(480, 640, 31).transpose(1, 2, 0)
        bio = io.BytesIO()
        PILImage.fromarray(png_img).save(bio, format="PNG")
        png_blob = bio.getvalue()
        [(_, res)], counts, _ = worker_steps([png_blob], every, "png")
        if counts != {"B0": 0, "B1": 0, "B2": 1, "B3": 0, "B4": 0}:
            fail(f"PNG source, every op: launches {counts}")
        for k in counts:
            tx_launches[k] += counts[k]
        check_tx_dims(res, normalize_operations(every), 480, 640, "PNG source")
        chw = png_img.transpose(2, 0, 1)
        for kind, want in (("crop", png_img[203:, 301:]), ("rotate", np.rot90(png_img, 1)),
                           ("flip", png_img[:, ::-1]),
                           ("grayscale", np.repeat(gray_f32(chw)[..., None], 3, axis=2))):
            if not np.array_equal(artifact_px(res, kind), want):
                fail(f"PNG source: {kind} artifact differs from numpy")
        log(f"[11 transform] PNG 640x480 source, all seven ops: COMPLETED, crop, "
            f"rotate 90, flip and grayscale artifacts equal numpy; launches {counts}")

        # ---- 12. the single-image path
        os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "0"
        task = ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                              original_path="single", bucket="images",
                              operations=every, format="jpeg")
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.monotonic()
        one = engine.process_single(task, blobs[0])
        wall = time.monotonic() - t0
        counts = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        if one.result.status is not ImageStatus.COMPLETED:
            fail(f"process_single: {one.result.error}")
        if counts != {"B0": 0, "B1": 0, "B2": 0, "B3": 0, "B4": 2}:
            fail(f"process_single: launches {counts}")
        for k in counts:
            single_launches[k] += counts[k]
        # B4 against its plain version on the tensors this path gives it:
        # one unpadded 3000x4000 image (row stride 4000, batch 1), the
        # keep-aspect resize and the crop thumbnail's centre window. The
        # ops' own outputs on the card equal the kernel's on these taps, so
        # the taps are the path's.
        sh, sw = src_px[0].shape[:2]
        img_hwc = torch.from_numpy(np.ascontiguousarray(src_px[0])).cuda()
        img = img_hwc.permute(2, 0, 1)[None].contiguous()
        s_plan = normalize_operations(every)
        t_op = next(o for o in s_plan.ops if o.type is OperationType.THUMBNAIL)
        r_op = next(o for o in s_plan.ops if o.type is OperationType.RESIZE)
        rw, rh = keep_aspect_dims(sw, sh, r_op.width, r_op.height)
        cx, cy, side = center_crop_rect(sw, sh)
        single_lsb = 0
        for out_hw, window, via_op in (
                ((rh, rw), (), resize_image(img_hwc, r_op.width, r_op.height,
                                            r_op.keep_aspect)),
                ((t_op.size, t_op.size),
                 (np.array([[cy, cx]]), np.array([[side, side]])),
                 thumbnail_image(img_hwc, t_op.size, t_op.crop_to_fit))):
            taps = fr.make_taps(np.array([[sh, sw]]), np.array([out_hw]), out_hw,
                                (sh, sw), *window).to("cuda")
            got = pr.planar_resample(img, taps)
            if not torch.equal(got[0].permute(1, 2, 0), via_op):
                fail(f"process_single: B4 on the rebuilt taps for {out_hw} differs "
                     f"from the single-image op's output")
            single_lsb = max(single_lsb,
                             max_err(got, fr.resample_plain(img, taps), [out_hw]))
        if single_lsb > LSB_LIMIT:
            fail(f"process_single: B4 vs plain on 1x3x{sh}x{sw}: {single_lsb} LSB")
        log(f"[12 single] B4 on the single-image tensors (1x3x{sh}x{sw}, resize to "
            f"{rw}x{rh}, crop thumbnail {t_op.size}x{t_op.size}): max |kernel - "
            f"plain| = {single_lsb} LSB (limit {LSB_LIMIT})")
        [(_, many)], _, _ = worker_steps([blobs[0]], every)
        check_tx_dims(one, normalize_operations(every), 3000, 4000, "process_single")
        psnrs = {}
        for kind in one.result.processed_paths:
            a, b = artifact_px(one, kind), artifact_px(many, kind)
            if a.shape != b.shape:
                fail(f"process_single {kind}: {a.shape} != batched {b.shape}")
            psnrs[kind] = oracle.psnr(a, b)
        log(f"[12 single] process_single, one 3000x4000 JPEG, all seven ops: "
            f"COMPLETED in {wall:.3f} s (host clock); launches {counts}; PSNR "
            f"against the batched path's artifacts (splice off): "
            + ", ".join(f"{k} {v:.2f} dB" for k, v in sorted(psnrs.items())))
        if min(psnrs.values()) <= SINGLE_PSNR_DB:
            fail(f"process_single vs batched: PSNR {psnrs}")
        os.environ["IMAGEPROCESSOR_JPEG_SPLICE"] = "1"
        task = ProcessingTask(id=str(uuid.uuid4()), image_id=str(uuid.uuid4()),
                              original_path="single.png", bucket="images",
                              operations=every, format="png")
        one = engine.process_single(task, png_blob)
        if one.result.status is not ImageStatus.COMPLETED:
            fail(f"process_single (PNG): {one.result.error}")
        lsb = {}
        for kind in one.result.processed_paths:
            a, b = artifact_px(one, kind), artifact_px(res, kind)
            if a.shape != b.shape:
                fail(f"process_single (PNG) {kind}: {a.shape} != batched {b.shape}")
            lsb[kind] = int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
        log(f"[12 single] PNG 640x480 source, PNG renditions, single vs batched "
            f"path, max LSB: {lsb}")
        if (any(lsb[k] for k in ("crop", "rotate", "flip", "grayscale"))
                or max(lsb.values()) > LSB_LIMIT):
            fail(f"process_single (PNG) vs batched: {lsb}")
    finally:
        os.environ.pop("IMAGEPROCESSOR_JPEG_SPLICE", None)
        engine.close()
        meta.close()
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- 13. timing of the new ops at 8 x 3072 x 4096, and the host clock
    # of the coefficient route
    tx_hw = np.array([[3000, 4000]] * 6 + [[1080, 1920], [480, 640]], np.int32)
    c = normalize_operations([crop_u]).ops[0]
    op_ms = {
        "grayscale": time_ms(lambda: extra.batched_grayscale_planar(src), iters=10),
        "flip_h": time_ms(lambda: extra.batched_flip(src, tx_hw, "horizontal"), iters=10),
        "flip_v": time_ms(lambda: extra.batched_flip(src, tx_hw, "vertical"), iters=10),
        "crop 1500x1100": time_ms(lambda: extra.batched_crop(
            src, tx_hw, c.x, c.y, width=c.width, height=c.height), iters=10),
        "rotate 90": time_ms(lambda: extra.batched_rotate(src, tx_hw, 90.0), iters=10),
        "rotate 180": time_ms(lambda: extra.batched_rotate(src, tx_hw, 180.0), iters=10),
        "rotate 270": time_ms(lambda: extra.batched_rotate(src, tx_hw, 270.0), iters=10),
        "rotate 30": time_ms(lambda: extra.batched_rotate(src, tx_hw, 30.0), iters=3,
                             warmup=1),
    }
    gray_step = time_ms(lambda: jpeg_kernels.encode_420(
        extra.batched_grayscale_planar(jpeg_kernels.decode_coefs(*big, 2, 2, (H, W))),
        big_vh, qt85), iters=10)
    log(f"[13 timing] {card}: ops/extra.py per 8x3072x4096 batch (CUDA events): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in op_ms.items())
        + f"; grayscale step B1 -> grayscale -> B3 {gray_step:.4f} ms = "
        f"{B * 1000.0 / gray_step:.1f} images/s")
    t0 = time.perf_counter()
    scanned = hostcodec.scan_jpeg_coefficients(blobs[0])
    ctx = splice.coef_context(*scanned)
    parts = [f"scan {(time.perf_counter() - t0) * 1000.0:.1f} ms"]
    for pname in sorted(coef_plans):
        o = normalize_operations(tx_plans[pname]).ops[0]
        prims = coeftx.eligible_prims(o, ctx.size, ctx.sampling)
        t0 = time.perf_counter()
        out = coeftx.apply(ctx, prims)
        t1 = time.perf_counter()
        splice.reencode(out)
        t2 = time.perf_counter()
        prim_s = "+".join(pr if isinstance(pr, str) else pr[0] for pr in prims)
        parts.append(f"{pname} [{prim_s}] transform {(t1 - t0) * 1000.0:.1f} ms, "
                     f"re-encode {(t2 - t1) * 1000.0:.1f} ms")
    log(f"[13 timing] {card}: coefficient route on the host, one 3000x4000 4:2:0 "
        f"JPEG, one thread (host clock): " + "; ".join(parts))

    # ---- 14-16. the service: the entry point over HTTP, both workers in
    # process, latency under arrival
    png_blob = png(sources[9][0])
    phase_entry_point(blobs, png_blob, oracle)
    svc_launches = phase_workers(blobs, png_blob)
    latency = phase_latency(card)
    log(json.dumps(latency))

    # ---- 17. the bench
    bench_launches = phase_bench(card, step_ms)

    # ---- 18. the reference topology: Kafka, S3, Postgres, two workers
    topo_launches = phase_topology(card, oracle)

    # ---- 19. the device-JPEG switch, the native rotation, the replicas
    route_launches = phase_routes(card, oracle, blobs)

    # ---- 21. the staged device stage against the packed one
    stage_launches = phase_staging(card)

    # ---- 22. the benchmark's Kafka group against the group's reference
    group_launches = phase_group(card)

    # ---- 23. kernel B0 per 12 MP upload
    b0 = phase_entropy(card)

    def row(name, key, source, replaces, phase, launched, err, ms, plain, b,
            extra=None):
        # library_ms: no single PyTorch call computes any of the five:
        # torch has no 8x8 DCT (B1, B3) and no Huffman decode (B0), and
        # interpolate takes one output size for the whole batch, where B2 /
        # B4 resample per-image source windows to per-image sizes with
        # Go's xdraw rounding
        by_phase = {phase: launched, "11": tx_launches[key],
                    "12": single_launches[key], "15": svc_launches[key],
                    "17": bench_launches[key], "18": topo_launches[key],
                    "19": route_launches[key], "21": stage_launches[key],
                    "22": group_launches[key], **(extra or {})}
        return {"name": name, "route": "cuda",
                "source": f"imageprocessor_tpu_torch/csrc/{source}",
                "replaces": replaces and f"imageprocessor_tpu/ops/{replaces}",
                "launches": sum(by_phase.values()),
                "launches_by_phase": by_phase,
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b["ms"], "bound_by": b["by"],
                "roofline_share": b["ms"] / ms,
                "byte_bound_ms": b.get("byte", b)["ms"], "library_ms": None}

    b0_row = row("jpeg_entropy_b0", "B0", "jpeg_entropy.cu", None, "5", launches["B0"],
                 0, b0["ms_per_upload_32"], b0["plain_ms"],
                 {"ms": b0["bound_ms"],
                  "by": "bytes: the stream read once and the sectors written once "
                        "(the serial chain of each subsequence, which binds, is "
                        "not counted)"},
                 {"9": form_launches["B0"], "23": b0["launches"]})
    b0_row["host_scan_ms"] = b0["host_scan_ms"]
    summary = {"kernels": [
        row("jpeg_decode_b1", "B1", "jpeg_decode.cu", "pallas_jpeg.py:548",
            "5", launches["B1"], max(b1_err, main_err), b1_ms, b1_plain, b1_b),
        row("fused_resample_b2", "B2", "fused_resample.cu", "pallas_fused.py:591",
            "5", launches["B2"], max(b2_err, main_err), b2_ms, b2_plain, b2_b),
        row("jpeg_encode_b3", "B3", "jpeg_encode.cu", "pallas_jpeg.py:932",
            "9", form_launches["B3"], max(b3_err, form_step), b3_ms, b3_plain, b3_b),
        row("planar_resample_b4", "B4", "planar_resample.cu", "pallas_resample.py:341",
            "9", form_launches["B4"], max(b4_err, form_lsb, single_lsb), b4_ms, b4_plain, b4_b),
        b0_row,
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
