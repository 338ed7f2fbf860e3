# Copy of imageprocessor_tpu/domain/__init__.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Domain model: pure types shared by every layer.

Mirrors the reference's `internal/domain` package
(reference: internal/domain/image.go:5-62, internal/domain/task.go:3-74).
"""

from imageprocessor_tpu_torch.domain.image import (
    Image,
    ImageFormat,
    ImageStatus,
    OperationType,
    ProcessedImage,
)
from imageprocessor_tpu_torch.domain.task import (
    BUCKET_ORIGINAL,
    BUCKET_PROCESSED,
    DEFAULT_JPEG_QUALITY,
    DEFAULT_MAX_UPLOAD_SIZE,
    DEFAULT_THUMBNAIL_SIZE,
    DEFAULT_WATERMARK_OPACITY,
    DEFAULT_WATERMARK_TEXT,
    KAFKA_GROUP_ID,
    KAFKA_TOPIC_PROCESSING,
    KAFKA_TOPIC_RESULTS,
    OperationParams,
    ProcessingResult,
    ProcessingTask,
    WatermarkPosition,
)

__all__ = [
    "Image",
    "ImageFormat",
    "ImageStatus",
    "OperationType",
    "ProcessedImage",
    "OperationParams",
    "ProcessingResult",
    "ProcessingTask",
    "WatermarkPosition",
    "KAFKA_TOPIC_PROCESSING",
    "KAFKA_TOPIC_RESULTS",
    "KAFKA_GROUP_ID",
    "BUCKET_ORIGINAL",
    "BUCKET_PROCESSED",
    "DEFAULT_MAX_UPLOAD_SIZE",
    "DEFAULT_THUMBNAIL_SIZE",
    "DEFAULT_JPEG_QUALITY",
    "DEFAULT_WATERMARK_TEXT",
    "DEFAULT_WATERMARK_OPACITY",
]
