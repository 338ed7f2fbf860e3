"""Deterministic output-path scheme — a copy of imageprocessor_tpu/runtime/paths.py
(the original imports models.plan, and so jax; tests/test_torch_coords_plan.py
holds the copy equal to it).

Byte-parity with the reference's generatePath (reference:
internal/usecase/processor/image_processor.go:129-162):
  resize    -> processed/resize/{imageID}/{W}x{H}.{fmt}   (requested dims,
               even when keep_aspect shrinks the actual output)
  thumbnail -> processed/thumbnails/{imageID}/{size}.{fmt}
  watermark -> processed/watermarked/{imageID}/watermarked.{fmt}
  other     -> processed/{op}/{imageID}/processed.{fmt}
Deterministic paths make reprocessing idempotent — the at-least-once
redelivery story depends on it (SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

from imageprocessor_tpu_torch.domain import DEFAULT_THUMBNAIL_SIZE, OperationType
from imageprocessor_tpu_torch.models.plan import NormalizedOp


def op_path_prefixes() -> tuple[str, ...]:
    """Every per-op directory name generate_path can emit — the single
    source of truth for delete_image's prefix sweep (a hand-copied list
    would silently orphan blobs of any newly added operation)."""
    special = {OperationType.RESIZE: "resize",
               OperationType.THUMBNAIL: "thumbnails",
               OperationType.WATERMARK: "watermarked"}
    return tuple(special.get(t, t.value.lower()) for t in OperationType)


def generate_path(image_id: str, op: NormalizedOp, fmt: str) -> str:
    if op.type is OperationType.RESIZE:
        return f"processed/resize/{image_id}/{op.width}x{op.height}.{fmt}"
    if op.type is OperationType.THUMBNAIL:
        # normalize_op guarantees size > 0 (default applied there); the
        # fallback only guards hand-built NormalizedOps, and must track
        # the shared constant or deterministic paths fork on a default
        # change.
        size = op.size or DEFAULT_THUMBNAIL_SIZE
        return f"processed/thumbnails/{image_id}/{size}.{fmt}"
    if op.type is OperationType.WATERMARK:
        return f"processed/watermarked/{image_id}/watermarked.{fmt}"
    return f"processed/{op.type.value.lower()}/{image_id}/processed.{fmt}"
