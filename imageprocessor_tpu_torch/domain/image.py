# Copy of imageprocessor_tpu/domain/image.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Image entities and enums.

Parity notes (reference: internal/domain/image.go):
* statuses: uploaded / processing / completed / failed / deleted (:32-38)
* operation types: resize / thumbnail / watermark / crop / rotate / flip /
  grayscale (:42-50) — the reference only *implements* the first three
  (internal/usecase/processor/image_processor.go:108-117); this framework
  implements all seven on-device.
* formats: jpeg / jpg / png / gif / webp / bmp / tiff (:54-62)
"""

from __future__ import annotations

import datetime as _dt
import enum
from dataclasses import dataclass, field


class ImageStatus(str, enum.Enum):
    UPLOADED = "uploaded"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"
    DELETED = "deleted"

    def __str__(self) -> str:  # so f-strings/json render the raw value
        return self.value


class OperationType(str, enum.Enum):
    RESIZE = "resize"
    THUMBNAIL = "thumbnail"
    WATERMARK = "watermark"
    CROP = "crop"
    ROTATE = "rotate"
    FLIP = "flip"
    GRAYSCALE = "grayscale"

    def __str__(self) -> str:
        return self.value


class ImageFormat(str, enum.Enum):
    JPEG = "jpeg"
    JPG = "jpg"
    PNG = "png"
    GIF = "gif"
    WEBP = "webp"
    BMP = "bmp"
    TIFF = "tiff"

    def __str__(self) -> str:
        return self.value


def utcnow() -> _dt.datetime:
    """Timezone-AWARE UTC timestamps (rendered with a Z suffix in JSON,
    like Go time.Time). Storage backends that strip tzinfo (Postgres
    TIMESTAMP) re-attach UTC on read so the same entity never flips
    between aware and naive representations."""
    return _dt.datetime.now(_dt.timezone.utc)


@dataclass
class Image:
    """Uploaded image metadata row (reference: internal/domain/image.go:5-16)."""

    id: str
    original_filename: str
    original_size: int
    mime_type: str
    status: ImageStatus
    original_path: str
    bucket: str
    created_at: _dt.datetime = field(default_factory=utcnow)
    updated_at: _dt.datetime = field(default_factory=utcnow)


@dataclass
class ProcessedImage:
    """Processed-variant metadata row (reference: internal/domain/image.go:18-29)."""

    id: str
    image_id: str
    operation: OperationType
    path: str
    size: int = 0
    mime_type: str = ""
    format: str = ""
    status: str = "processing"
    parameters: str = ""
    created_at: _dt.datetime = field(default_factory=utcnow)
