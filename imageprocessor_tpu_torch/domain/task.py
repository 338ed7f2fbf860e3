# Copy of imageprocessor_tpu/domain/task.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Processing-task wire types and framework constants.

Wire parity: the reference marshals `ProcessingTask` / `ProcessingResult`
with Go's default (un-tagged) field names, i.e. capitalized keys
("ID", "ImageID", "OriginalPath", "Bucket", "Operations", "Format",
"Type", "Parameters", "Status", "ProcessedPaths", "Error")
(reference: internal/domain/task.go:3-23 has no json tags;
internal/usecase/image/image.go:93 json.Marshal). `to_json`/`from_json`
below produce/accept exactly that shape so queue payloads interoperate.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any

from imageprocessor_tpu_torch.domain.image import ImageStatus, OperationType


class WatermarkPosition(str, enum.Enum):
    """Seven anchor positions (reference: internal/domain/task.go:27-35)."""

    TOP_LEFT = "top-left"
    TOP_RIGHT = "top-right"
    TOP_CENTER = "top-center"
    BOTTOM_LEFT = "bottom-left"
    BOTTOM_RIGHT = "bottom-right"
    BOTTOM_CENTER = "bottom-center"
    CENTER = "center"

    def __str__(self) -> str:
        return self.value


# Queue topology (reference: internal/domain/task.go:38-40)
KAFKA_TOPIC_PROCESSING = "image-processing"
KAFKA_TOPIC_RESULTS = "image-processed"
KAFKA_GROUP_ID = "image-processor-group"

# Bucket/path prefixes (reference: internal/domain/task.go:43-52)
BUCKET_ORIGINAL = "original"
BUCKET_PROCESSED = "processed"
PATH_PREFIX_ORIGINAL = "original/"
PATH_PREFIX_PROCESSED = "processed/"
PATH_PREFIX_THUMBNAIL = "thumbnails/"

# Defaults (reference: internal/domain/task.go:55-59)
DEFAULT_MAX_UPLOAD_SIZE = 32 << 20
DEFAULT_THUMBNAIL_SIZE = 200
DEFAULT_JPEG_QUALITY = 85
DEFAULT_WATERMARK_TEXT = "© ImageProcessor"
DEFAULT_WATERMARK_OPACITY = 0.5

# Parameter keys (reference: internal/domain/task.go:63-74)
PARAM_WIDTH = "width"
PARAM_HEIGHT = "height"
PARAM_SIZE = "size"
PARAM_TEXT = "text"
PARAM_POSITION = "position"
PARAM_OPACITY = "opacity"
PARAM_FONT_SIZE = "font_size"
PARAM_FONT_COLOR = "font_color"
PARAM_KEEP_ASPECT = "keep_aspect"
PARAM_CROP_TO_FIT = "crop_to_fit"
PARAM_ANGLE = "angle"


@dataclass
class OperationParams:
    """One operation + free-form parameters (reference: internal/domain/task.go:12-15)."""

    type: OperationType
    parameters: dict[str, Any] = field(default_factory=dict)

    def to_wire(self) -> dict[str, Any]:
        return {"Type": str(self.type), "Parameters": self.parameters}

    @classmethod
    def from_wire(cls, obj: dict[str, Any]) -> "OperationParams":
        return cls(
            type=OperationType(obj["Type"]),
            parameters=obj.get("Parameters") or {},
        )


@dataclass
class ProcessingTask:
    """Queue task payload (reference: internal/domain/task.go:3-10)."""

    id: str
    image_id: str
    original_path: str
    bucket: str
    operations: list[OperationParams]
    format: str = ""

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "ID": self.id,
                "ImageID": self.image_id,
                "OriginalPath": self.original_path,
                "Bucket": self.bucket,
                "Operations": [op.to_wire() for op in self.operations],
                "Format": self.format,
            },
            ensure_ascii=False,
        ).encode("utf-8")

    @classmethod
    def from_json(cls, data: bytes | str) -> "ProcessingTask":
        obj = json.loads(data)
        return cls(
            id=obj.get("ID", ""),
            image_id=obj.get("ImageID", ""),
            original_path=obj.get("OriginalPath", ""),
            bucket=obj.get("Bucket", ""),
            operations=[OperationParams.from_wire(o) for o in obj.get("Operations") or []],
            format=obj.get("Format", "") or "",
        )


@dataclass
class ProcessingResult:
    """Processing outcome (reference: internal/domain/task.go:17-23)."""

    id: str
    image_id: str
    status: ImageStatus
    processed_paths: dict[str, str] = field(default_factory=dict)
    error: str = ""

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "ID": self.id,
                "ImageID": self.image_id,
                "Status": str(self.status),
                "ProcessedPaths": self.processed_paths,
                "Error": self.error,
            },
            ensure_ascii=False,
        ).encode("utf-8")

    @classmethod
    def from_json(cls, data: bytes | str) -> "ProcessingResult":
        obj = json.loads(data)
        return cls(
            id=obj.get("ID", ""),
            image_id=obj.get("ImageID", ""),
            status=ImageStatus(obj.get("Status", "failed")),
            processed_paths=obj.get("ProcessedPaths") or {},
            error=obj.get("Error", "") or "",
        )
