# Copy of imageprocessor_tpu/storage/metadata.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Metadata-store interface.

Surface parity with the reference's Postgres repository (reference:
internal/repository/image/db/postgres/postgres.go:17-298): image CRUD,
status updates, processed-image rows, soft delete via status, newest-first
listing that excludes deleted rows, LIMIT-1 processed-by-operation lookup
returning None when absent (:200-232).
"""

from __future__ import annotations

import abc

from imageprocessor_tpu_torch.domain import Image, ImageStatus, ProcessedImage


# Canonical SELECT column order both backends use — ONE row-to-entity
# mapping each, so a schema/field change cannot silently shift fields
# in one backend only. `ts` is the backend's timestamp parser.
IMAGE_COLUMNS = ("id, original_filename, original_size, mime_type,"
                 " status, original_path, bucket, created_at, updated_at")
PROCESSED_COLUMNS = ("id, image_id, operation, parameters, path, size,"
                     " mime_type, format, status, created_at")


def row_to_image(row, ts) -> "Image":
    return Image(id=row[0], original_filename=row[1], original_size=row[2],
                 mime_type=row[3], status=ImageStatus(row[4]),
                 original_path=row[5], bucket=row[6],
                 created_at=ts(row[7]), updated_at=ts(row[8]))


def row_to_processed(row, ts) -> "ProcessedImage":
    from imageprocessor_tpu_torch.domain import OperationType

    return ProcessedImage(id=row[0], image_id=row[1],
                          operation=OperationType(row[2]),
                          parameters=row[3] or "", path=row[4], size=row[5],
                          mime_type=row[6], format=row[7], status=row[8],
                          created_at=ts(row[9]))


class MetadataError(Exception):
    pass


class NotFound(MetadataError):
    pass


class MetadataStore(abc.ABC):
    @abc.abstractmethod
    def save_image(self, image: Image) -> None: ...

    @abc.abstractmethod
    def get_image(self, image_id: str) -> Image:
        """Raises NotFound for missing OR deleted rows (postgres.go:53-83
        filters status != 'deleted')."""

    @abc.abstractmethod
    def update_status(self, image_id: str, status: ImageStatus) -> None:
        """Also bumps updated_at (postgres.go:85-106)."""

    @abc.abstractmethod
    def save_processed_image(self, processed: ProcessedImage) -> None: ...

    @abc.abstractmethod
    def get_processed_by_operation(self, image_id: str,
                                   operation: str) -> ProcessedImage | None:
        """None when absent — NOT an error (postgres.go:200-232)."""

    @abc.abstractmethod
    def list_processed(self, image_id: str) -> list[ProcessedImage]: ...

    @abc.abstractmethod
    def delete_processed_images(self, image_id: str) -> None: ...

    @abc.abstractmethod
    def list_images(self, limit: int = 50, offset: int = 0) -> list[Image]:
        """Excludes deleted; newest first (postgres.go:247-284)."""

    def close(self) -> None:  # noqa: B027
        pass

