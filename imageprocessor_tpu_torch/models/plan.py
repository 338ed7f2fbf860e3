"""Operation-plan normalization — a copy of imageprocessor_tpu/models/plan.py.

The reference module is jax-free, but its package's ``__init__`` imports
the jax pipeline, so it cannot be imported where jax is absent; the port
carries this copy (tests/test_torch_coords_plan.py holds it equal to the
original).

Turns the free-form `Parameters` maps from queue tasks into fully-resolved,
hashable plan entries. Two jobs:

1. Reproduce the reference's parameter coercion exactly — numbers may
   arrive as JSON float64 or int (reference: operations/resize.go:27-53
   accepts float64/int/int64/int32), invalid values raise the same error
   classes, absent values take the reference defaults.
2. Produce a static `plan_key` so one compiled XLA program serves every
   task with the same plan, independent of image content.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

from imageprocessor_tpu_torch.domain import (
    DEFAULT_THUMBNAIL_SIZE,
    DEFAULT_WATERMARK_OPACITY,
    DEFAULT_WATERMARK_TEXT,
    OperationParams,
    OperationType,
    WatermarkPosition,
)
from imageprocessor_tpu_torch.errors import UnsupportedOperationError


class InvalidParamsError(ValueError):
    pass


def _as_int(params: dict[str, Any], key: str) -> int | None:
    """Go-style numeric coercion: float64/int accepted, nothing else.
    Non-finite floats are rejected loudly: Python's json parses 1e400 to
    inf (Go's rejects it at unmarshal), and int(inf) raises
    OverflowError — which is NOT in the callers' catch tuples, so it
    would abort the whole worker batch and crash-loop on redelivery."""
    v = params.get(key)
    if v is None:
        return None
    if isinstance(v, bool):  # bool is int in Python; Go would not accept it
        return None
    if isinstance(v, float) and not math.isfinite(v):
        raise InvalidParamsError(f"{key} must be a finite number")
    if isinstance(v, (int, float)):
        return int(v)
    return None


def _as_float(params: dict[str, Any], key: str) -> float | None:
    v = params.get(key)
    if v is None or isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    if isinstance(v, float) and not math.isfinite(v):
        raise InvalidParamsError(f"{key} must be a finite number")
    return float(v)


@dataclass(frozen=True)
class NormalizedOp:
    """One fully-resolved operation; hashable, orderable, plan-key ready."""

    type: OperationType
    # resize
    width: int = 0
    height: int = 0
    keep_aspect: bool = False
    # thumbnail
    size: int = 0
    crop_to_fit: bool = False
    # watermark
    text: str = ""
    position: str = ""
    opacity: float = 0.0
    font_size: float = 0.0
    font_color: str = ""
    # crop
    x: int = 0
    y: int = 0
    # rotate / flip
    angle: float = 0.0
    direction: str = ""

    def compile_key(self) -> tuple:
        """Static compile key. Watermark TEXT is deliberately excluded —
        the rasterized tile is a runtime input with a shape-quantized pad,
        so different texts reuse one compiled program."""
        if self.type is OperationType.WATERMARK:
            return (self.type.value, self.position, round(self.opacity, 6),
                    round(self.font_size, 3), self.font_color)
        return (self.type.value, self.width, self.height, self.keep_aspect,
                self.size, self.crop_to_fit, self.x, self.y,
                round(self.angle, 3), self.direction)


def normalize_op(op: OperationParams) -> NormalizedOp:
    p = op.parameters or {}
    t = op.type

    if t is OperationType.RESIZE:
        width = _as_int(p, "width")
        height = _as_int(p, "height")
        if width is None:
            raise InvalidParamsError("width parameter is required and must be a number")
        if height is None:
            raise InvalidParamsError("height parameter is required and must be a number")
        if width <= 0 or height <= 0:
            raise InvalidParamsError("width and height must be positive numbers")
        return NormalizedOp(type=t, width=width, height=height,
                            keep_aspect=bool(p.get("keep_aspect") is True))

    if t is OperationType.THUMBNAIL:
        size = _as_int(p, "size")
        if size is None:
            size = DEFAULT_THUMBNAIL_SIZE  # thumbnail.go:36
        if size <= 0:
            raise InvalidParamsError("size must be a positive number")
        return NormalizedOp(type=t, size=size,
                            crop_to_fit=bool(p.get("crop_to_fit") is True))

    if t is OperationType.WATERMARK:
        text = p.get("text") if isinstance(p.get("text"), str) else ""
        if not text:
            text = DEFAULT_WATERMARK_TEXT           # watermark.go:42-44
        opacity = _as_float(p, "opacity")
        if opacity is None or opacity <= 0:
            opacity = DEFAULT_WATERMARK_OPACITY     # watermark.go:46-48
        position = p.get("position") if isinstance(p.get("position"), str) \
            else "bottom-right"                     # watermark.go:50-52
        # Unknown position strings all BEHAVE as bottom-right (anchor
        # default case, watermark.go:146-148) — normalize them here so
        # "", "foo", "bottomright" don't each mint a distinct
        # compile_key and a multi-second throwaway XLA compile.
        if position not in set(x.value for x in WatermarkPosition):
            position = "bottom-right"
        # Cap the text length: the tile rasterizer allocates
        # text-width-proportional buffers (the Go reference draws
        # clipped into the image and never does), so the 64 KiB
        # form-field cap would otherwise admit a single upload that
        # rasterizes a multi-GB tile. 1024 chars is far wider than any
        # bucket can show.
        if len(text) > 1024:
            text = text[:1024]
        font_size = _as_float(p, "font_size")
        if font_size is None or font_size <= 0:
            font_size = 36.0                        # watermark.go:54-56
        font_color = p.get("font_color") if isinstance(p.get("font_color"), str) \
            else "255,255,255"                      # watermark.go:58-60
        return NormalizedOp(type=t, text=text, position=position,
                            opacity=opacity, font_size=font_size,
                            font_color=font_color)

    if t is OperationType.CROP:
        width = _as_int(p, "width") or 0
        height = _as_int(p, "height") or 0
        if width <= 0 or height <= 0:
            raise InvalidParamsError("width and height must be positive numbers")
        return NormalizedOp(type=t, x=max(_as_int(p, "x") or 0, 0),
                            y=max(_as_int(p, "y") or 0, 0),
                            width=width, height=height)

    if t is OperationType.ROTATE:
        angle = _as_float(p, "angle")
        if angle is None:
            raise InvalidParamsError("angle parameter is required and must be a number")
        return NormalizedOp(type=t, angle=float(angle) % 360.0)

    if t is OperationType.FLIP:
        direction = p.get("direction") if isinstance(p.get("direction"), str) \
            else "horizontal"
        if direction not in ("horizontal", "vertical"):
            raise InvalidParamsError("direction must be horizontal or vertical")
        return NormalizedOp(type=t, direction=direction)

    if t is OperationType.GRAYSCALE:
        return NormalizedOp(type=t)

    raise UnsupportedOperationError(f"unsupported operation type: {t}")


@dataclass(frozen=True)
class OperationPlan:
    """Ordered, normalized operation list for one task."""

    ops: tuple[NormalizedOp, ...]

    def compile_key(self) -> tuple:
        return tuple(op.compile_key() for op in self.ops)

    def group_key(self) -> tuple:
        """Batch-grouping key: compile_key PLUS each op's runtime
        identity (watermark TEXT). A Group is processed with the FIRST
        item's plan verbatim (engine._device_group_impl,
        prepare_wm_args), so anything that differs between tasks must
        split groups — compile_key alone once let two uploads with
        different watermark texts share a group, stamping the second
        user's image with the first user's text. The compiled-program
        cache keeps using compile_key, so same-shape texts still share
        one XLA program."""
        return tuple((op.compile_key(), op.text) for op in self.ops)

    def __iter__(self):
        return iter(self.ops)

    def __len__(self) -> int:
        return len(self.ops)


def normalize_operations(operations: list[OperationParams]) -> OperationPlan:
    return OperationPlan(ops=tuple(normalize_op(op) for op in operations))
