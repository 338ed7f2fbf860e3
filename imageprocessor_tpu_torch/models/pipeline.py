"""The planar device step — counterpart of the planar half of
imageprocessor_tpu/models/pipeline.py (``plan_output_specs``,
``step_chw``, ``_fused_setup`` and ``_pallas_setup``).

For one padded group (B, 3, Hb, Wb) u8 on the device, the ops of a plan
are served as the reference routes them:

* the first thumbnail and the first resize form the fused pair: one
  launch of kernel B2 reads the source once and writes both (the default
  plan — thumbnail 200 crop + resize 1024x768 keep-aspect — is one
  launch). The port's B2 takes any scale, upscales included;
* every other resize or thumbnail is one launch of kernel B4;
* crop, flip, rotate and grayscale are the plain tensor ops of
  ops/extra.py on the planar bucket (the reference keeps an HWC layout
  for the first three; the port needs none). A crop's canvas is its
  requested rect clamped to the bucket; flip, grayscale and rotations by
  0 or 180 degrees or by any other angle fill the bucket canvas, and a
  rotation by 90 or 270 degrees the transposed one. Every op reads the
  source bucket: ops are not chained;
* a watermark's output is the full bucket canvas: the text is blended
  into the source canvas in place (ops/watermark.py), after every other
  op has read it (one stream orders them). A plan with several
  watermarks blends every one but the last into a copy.

The tap tables are built on the host for every group and copied to the
device. PyTorch runs eagerly, so nothing is traced or recompiled, and
unlike the reference there is no cache of per-geometry arguments:
building and uploading an 8-image group's tables takes about a
millisecond, against about 200 ms for the group's whole device stage
(chip_smoke.py times it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from imageprocessor_tpu_torch.domain import OperationType
from imageprocessor_tpu_torch.models.plan import NormalizedOp, OperationPlan
from imageprocessor_tpu_torch.ops.extra import (
    batched_crop,
    batched_flip,
    batched_grayscale_planar,
    batched_rotate,
)
from imageprocessor_tpu_torch.ops.fused_resample import (
    Taps,
    center_crop_windows,
    fused_resample,
    make_taps,
)
from imageprocessor_tpu_torch.ops.planar_resample import planar_resample
from imageprocessor_tpu_torch.ops.watermark import (
    quantize_tile,
    rasterize_text,
    resolve_color,
    watermark_planar_,
)

RESAMPLE_OPS = (OperationType.RESIZE, OperationType.THUMBNAIL)


@dataclass(frozen=True)
class OpOutputSpec:
    """Output-canvas description for one op."""

    op: NormalizedOp
    canvas: tuple[int, int]  # (out_h, out_w); (0, 0) = the full bucket canvas


def _quant_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan_output_specs(plan: OperationPlan,
                      aspect_long_sides: dict[int, int] | None = None,
                      ) -> tuple[OpOutputSpec, ...]:
    """Output canvases: resize -> the requested (height, width), which
    every keep-aspect output fits; crop thumbnail -> (size, size); aspect
    thumbnail -> the group's longest side quantized up to /64; crop ->
    the requested (height, width), which step_chw clamps to the bucket;
    watermark, grayscale, flip and rotate -> the full bucket canvas,
    (0, 0)."""
    specs = []
    for i, op in enumerate(plan.ops):
        if op.type is OperationType.RESIZE:
            specs.append(OpOutputSpec(op, (op.height, op.width)))
        elif op.type is OperationType.THUMBNAIL and op.crop_to_fit:
            specs.append(OpOutputSpec(op, (op.size, op.size)))
        elif op.type is OperationType.THUMBNAIL:
            long_side = (aspect_long_sides or {}).get(i, op.size)
            long_side = max(_quant_up(long_side, 64), op.size)
            specs.append(OpOutputSpec(op, (long_side, long_side)))
        elif op.type is OperationType.CROP:
            specs.append(OpOutputSpec(op, (op.height, op.width)))
        else:
            specs.append(OpOutputSpec(op, (0, 0)))
    return tuple(specs)


def fused_pair(specs: tuple[OpOutputSpec, ...]) -> tuple[int, int] | None:
    """(thumbnail index, resize index) of the plan's first thumbnail and
    first resize — the ops kernel B2 serves in one launch — or None."""
    first = {}
    for i, spec in enumerate(specs):
        first.setdefault(spec.op.type, i)
    if OperationType.THUMBNAIL in first and OperationType.RESIZE in first:
        return first[OperationType.THUMBNAIL], first[OperationType.RESIZE]
    return None


def step_taps(bucket: tuple[int, int], src_hw: np.ndarray,
              out_hws: dict[int, np.ndarray],
              specs: tuple[OpOutputSpec, ...],
              device: torch.device) -> dict[int, Taps]:
    """Op index -> tap tables on ``device``, for each resample op."""
    taps = {}
    for i, spec in enumerate(specs):
        op = spec.op
        if op.type is OperationType.THUMBNAIL and op.crop_to_fit:
            crop_yx, crop_hw = center_crop_windows(src_hw)
            out_hw = np.full((src_hw.shape[0], 2), op.size, np.int64)
            t = make_taps(src_hw, out_hw, spec.canvas, bucket, crop_yx, crop_hw)
        elif op.type in RESAMPLE_OPS:
            t = make_taps(src_hw, out_hws[i], spec.canvas, bucket)
        else:
            continue
        taps[i] = t.to(device)
    return taps


def step_chw(imgs: torch.Tensor, src_hw: np.ndarray,
             out_hws: dict[int, np.ndarray],
             specs: tuple[OpOutputSpec, ...]) -> list[torch.Tensor]:
    """A plan's ops on one padded group: B2 for the fused pair, B4 for the
    other resamples, the tensor ops of ops/extra.py, then the watermarks
    into ``imgs`` in place.

    imgs: (B, 3, Hb, Wb) u8 (consumed: a watermark writes into it);
    src_hw: (B, 2) valid source dims; out_hws: op index -> (B, 2) valid
    output dims (resize and aspect thumbnails); specs: plan_output_specs
    of the plan. Returns per-op (B, 3, h, w) u8 canvases in plan order,
    on the device of ``imgs``."""
    src_hw = np.asarray(src_hw)
    bucket = (int(imgs.shape[2]), int(imgs.shape[3]))
    taps = step_taps(bucket, src_hw, out_hws, specs, imgs.device)
    outs: list[torch.Tensor | None] = [None] * len(specs)
    pair = fused_pair(specs)
    if pair is not None:
        i_t, i_r = pair
        outs[i_t], outs[i_r] = fused_resample(imgs, taps[i_t], taps[i_r])
    for i, t in taps.items():
        if outs[i] is None:
            outs[i] = planar_resample(imgs, t)
    for i, spec in enumerate(specs):
        op = spec.op
        if op.type is OperationType.GRAYSCALE:
            outs[i] = batched_grayscale_planar(imgs)
        elif op.type is OperationType.FLIP:
            outs[i] = batched_flip(imgs, src_hw, op.direction)
        elif op.type is OperationType.CROP:
            outs[i] = batched_crop(imgs, src_hw, op.x, op.y,
                                   width=min(op.width, bucket[1]),
                                   height=min(op.height, bucket[0]))
        elif op.type is OperationType.ROTATE:
            outs[i] = batched_rotate(imgs, src_hw, op.angle)
    marks = [i for i, s in enumerate(specs) if s.op.type is OperationType.WATERMARK]
    for k, i in enumerate(marks):
        op = specs[i].op
        tile = quantize_tile(rasterize_text(op.text, op.font_size))
        r, g, b, a = resolve_color(op.font_color, op.opacity)
        canvas = imgs if k == len(marks) - 1 else imgs.clone()
        outs[i] = watermark_planar_(canvas, src_hw, tile, (r, g, b), a / 255.0,
                                    op.position)
    return outs
