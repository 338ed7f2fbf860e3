"""The planar resample step — counterpart of the planar half of
imageprocessor_tpu/models/pipeline.py (``plan_output_specs``,
``step_chw`` and ``_fused_setup``).

For one padded group (B, 3, Hb, Wb) u8 on the device, every thumbnail and
resize op of the plan is served by kernel B2: the ops are taken in
pairs, and each pair is one launch that reads the source once and writes
both outputs (the default plan — thumbnail 200 crop + resize 1024x768
keep-aspect — is one launch). The tap tables are built on the host for
every group and copied to the device. PyTorch runs eagerly, so nothing
is traced or recompiled, and unlike the reference there is no cache of
per-geometry arguments: building and uploading an 8-image group's
tables takes about a millisecond, against about 200 ms for the group's
whole device stage (chip_smoke.py's phase 6 times it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from imageprocessor_tpu_torch.domain import OperationType
from imageprocessor_tpu_torch.errors import UnsupportedOperationError
from imageprocessor_tpu_torch.models.plan import NormalizedOp, OperationPlan
from imageprocessor_tpu_torch.ops.fused_resample import (
    Taps,
    center_crop_windows,
    fused_resample,
    make_taps,
)

# Ops this step serves; the engine refuses plans with any other op.
RESAMPLE_OPS = (OperationType.RESIZE, OperationType.THUMBNAIL)


@dataclass(frozen=True)
class OpOutputSpec:
    """Output-canvas description for one op."""

    op: NormalizedOp
    canvas: tuple[int, int]  # (out_h, out_w)


def _quant_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan_output_specs(plan: OperationPlan,
                      aspect_long_sides: dict[int, int] | None = None,
                      ) -> tuple[OpOutputSpec, ...]:
    """Output canvases: resize -> the requested (height, width), which
    every keep-aspect output fits; crop thumbnail -> (size, size); aspect
    thumbnail -> the group's longest side quantized up to /64."""
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
        else:
            raise UnsupportedOperationError(
                f"operation {op.type.value} has no planar step in the port")
    return tuple(specs)


def step_taps(bucket: tuple[int, int], src_hw: np.ndarray,
              out_hws: dict[int, np.ndarray],
              specs: tuple[OpOutputSpec, ...],
              device: torch.device) -> list[Taps]:
    """Per-op tap tables of one group, on ``device``."""
    taps = []
    for i, spec in enumerate(specs):
        op = spec.op
        if op.type is OperationType.THUMBNAIL and op.crop_to_fit:
            crop_yx, crop_hw = center_crop_windows(src_hw)
            out_hw = np.full((src_hw.shape[0], 2), op.size, np.int64)
            t = make_taps(src_hw, out_hw, spec.canvas, bucket, crop_yx, crop_hw)
        else:
            t = make_taps(src_hw, out_hws[i], spec.canvas, bucket)
        taps.append(t.to(device))
    return taps


def step_chw(imgs: torch.Tensor, src_hw: np.ndarray,
             out_hws: dict[int, np.ndarray],
             specs: tuple[OpOutputSpec, ...]) -> list[torch.Tensor]:
    """A plan's resample ops on one padded group through kernel B2.

    imgs: (B, 3, Hb, Wb) u8; src_hw: (B, 2) valid source dims; out_hws:
    op index -> (B, 2) valid output dims (resize and aspect thumbnails);
    specs: plan_output_specs of the plan. Returns per-op (B, 3, h, w) u8
    canvases in plan order, on the device of ``imgs``."""
    bucket = (int(imgs.shape[2]), int(imgs.shape[3]))
    taps = step_taps(bucket, np.asarray(src_hw), out_hws, specs, imgs.device)
    outs: list[torch.Tensor | None] = [None] * len(taps)
    for k in range(0, len(taps), 2):
        pair = taps[k:k + 2]
        a, b = fused_resample(imgs, pair[0], pair[1] if len(pair) > 1 else None)
        outs[k] = a
        if len(pair) > 1:
            outs[k + 1] = b
    return outs
