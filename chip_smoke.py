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
   artifacts' dims, that both kernels launched during the run, that the
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
   transform, re-encode).

B2's and B4's bounds are counted twice: by the bytes their taps touch,
and by the 32-byte sectors those bytes lie in (the card's memory moves
whole sectors; a bucket row is 4096 bytes, so a sector is col // 32).
The sector count is the bound; the byte count is printed beside it.

The watermark's font is the reference's lookup (IMAGEPROCESSOR_FONT, the
reference package's assets/fonts, matplotlib's DejaVu Sans); where none
of those exists, phase 1 points IMAGEPROCESSOR_FONT at a TrueType font
found on the host, or at Pillow's bundled default font written under
build/, and prints which.

The line before the last is the card's name and power limit as
nvidia-smi gives them, the one before it a JSON summary of the kernels
(launches on the main path, max error, ms, plain_ms, bound_ms, bound_by,
roofline_share, byte_bound_ms, and library_ms: null, since no single
PyTorch call computes any of the four functions); the last line is
{"ok": true, "device": {...}}. Only imageprocessor_tpu_torch
is imported: neither jax nor the reference package imageprocessor_tpu.
"""

from __future__ import annotations

import glob
import io
import json
import math
import os
import shutil
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
HBM_BYTES_S = 3.35e12            # H100 SXM device memory, bytes/s (data sheet)
FP32_FLOP_S = 67e12              # H100 SXM FP32 outside the tensor cores
MODES = ((2, 2), (1, 2), (2, 1), (1, 1))   # 4:2:0, 4:2:2, 4:4:0, 4:4:4


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
    """Device ms per call of fn, by CUDA events. The stream is first held
    busy (~30 ms) so the host enqueues every call before the device
    reaches the first event: a call that never waits on the device is
    timed without the host's launch overhead. A call that synchronizes
    (a pageable host-to-device copy) still waits, so its time includes
    the host's share."""
    for _ in range(warmup):
        fn()
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


def load_oracle():
    """tests/oracle.py: the repo's float64 oracle of the Go reference."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ip_oracle", os.path.join(REPO, "tests", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ensure_font(wm) -> str:
    """The watermark font: the reference's lookup when it finds one, else
    a TrueType font on the host (DejaVu Sans first), else Pillow's bundled
    default font written under build/. Sets IMAGEPROCESSOR_FONT for the
    last two."""
    try:
        path = wm._default_font_path()
        if os.path.exists(path):
            return path
    except ImportError:   # no matplotlib: the reference's last fallback
        pass
    import site

    roots = ["/usr/share/fonts", "/usr/local/share/fonts", *site.getsitepackages()]
    found = sorted({f for r in roots
                    for f in glob.glob(os.path.join(r, "**", "*.ttf"), recursive=True)},
                   key=lambda f: (os.path.basename(f) != "DejaVuSans.ttf", f))
    if found:
        path = found[0]
    else:
        from PIL import ImageFont

        path = os.path.join(REPO, "build", "fonts", "pillow-default.ttf")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(ImageFont.load_default(36).font_bytes)
    os.environ["IMAGEPROCESSOR_FONT"] = path
    wm._DEFAULT_FONT_PATH = None
    return wm._default_font_path()


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
    from imageprocessor_tpu_torch.ops import extra
    from imageprocessor_tpu_torch.ops import fused_resample as fr
    from imageprocessor_tpu_torch.ops import jpeg_kernels
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
    log(f"[1 device] watermark font: {ensure_font(wm)}")

    # ---- 2. build
    t0 = time.monotonic()
    kernels.library()
    t1 = time.monotonic()
    hostcodec.library()
    t2 = time.monotonic()
    log(f"[2 build] kernels (one nvcc sm_90a per csrc/*.cu, in parallel) "
        f"{t1 - t0:.2f} s, host JPEG + GIF library (g++) {t2 - t1:.2f} s")

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
            16, kernels.stream_ptr(rgb.device))
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
    counters = {"B1": (jpeg_kernels, "launches"), "B2": (fr, "launches"),
                "B3": (jpeg_kernels, "encode_launches"), "B4": (pr, "launches")}
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
        parts = [f"{k[7:]} max {t[k]['max']:.1f}" for k in (
            "engine_decode_ms", "engine_device_ms", "engine_encode_ms") if k in t]
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
            packed, ghw = group.pack(pad_batch_to=quantize_batch(len(group.items)))
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

    form_launches = {"B3": 0, "B4": 0}
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
                if ((counts["B2"] > 0) != (n_resample == 2)
                        or (counts["B4"] > 0) != (n_resample == 1)
                        or (counts["B3"] > 0) != want_b3):
                    fail(f"plan {flags} ({mode}): launches {counts}")
                form_launches["B4"] += counts["B4"]
                form_launches["B3"] += counts["B3"]
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
            if counts["B2"] == 0 or (counts["B3"] > 0) != (fmt == "GIF"):
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
            dec_t, _ = engine._upload(group, quantize_batch(len(group.items)))
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
            dec_t, ghw = engine._upload(group, quantize_batch(len(group.items)))
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
                dev = snap["timings"]["engine_device_ms"]
                from_coefs = splice_on and pname in coef_plans
                if from_coefs:
                    ok = (not any(counts.values()) and dev["max"] == 0.0
                          and n_coef == n_jpeg)
                else:
                    ok = (counts["B1"] == dev["count"] and counts["B1"] >= 1
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
        if counts != {"B1": 0, "B2": 1, "B3": 0, "B4": 0}:
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
        if counts != {"B1": 0, "B2": 0, "B3": 0, "B4": 2}:
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

    def row(name, key, source, replaces, phase, launched, err, ms, plain, b):
        # library_ms: no single PyTorch call computes any of the four:
        # torch has no 8x8 DCT (B1, B3), and interpolate takes one output
        # size for the whole batch, where B2 / B4 resample per-image
        # source windows to per-image sizes with Go's xdraw rounding
        return {"name": name, "route": "cuda",
                "source": f"imageprocessor_tpu_torch/csrc/{source}",
                "replaces": f"imageprocessor_tpu/ops/{replaces}",
                "launches": launched + tx_launches[key] + single_launches[key],
                "launches_by_phase": {phase: launched, "11": tx_launches[key],
                                      "12": single_launches[key]},
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b["ms"], "bound_by": b["by"],
                "roofline_share": b["ms"] / ms,
                "byte_bound_ms": b.get("byte", b)["ms"], "library_ms": None}

    summary = {"kernels": [
        row("jpeg_decode_b1", "B1", "jpeg_decode.cu", "pallas_jpeg.py:548",
            "5", launches["B1"], max(b1_err, main_err), b1_ms, b1_plain, b1_b),
        row("fused_resample_b2", "B2", "fused_resample.cu", "pallas_fused.py:591",
            "5", launches["B2"], max(b2_err, main_err), b2_ms, b2_plain, b2_b),
        row("jpeg_encode_b3", "B3", "jpeg_encode.cu", "pallas_jpeg.py:932",
            "9", form_launches["B3"], max(b3_err, form_step), b3_ms, b3_plain, b3_b),
        row("planar_resample_b4", "B4", "planar_resample.cu", "pallas_resample.py:341",
            "9", form_launches["B4"], max(b4_err, form_lsb, single_lsb), b4_ms, b4_plain, b4_b),
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
