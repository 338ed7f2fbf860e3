# Copy of imageprocessor_tpu/errors.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Sentinel error types shared across layers.

Mirror of the reference's usecase/repo sentinel errors
(reference: internal/usecase/image/errors.go:5-13,
internal/repository/image/errors.go) so HTTP handlers can map error
classes to status codes the same way (handler/image/image.go:279-325).
"""

from __future__ import annotations


class FrameworkError(Exception):
    """Base class for all framework-raised errors."""


class InvalidFileFormatError(FrameworkError):
    """File content is not an image (usecase sniff failed)."""


class FileTooLargeError(FrameworkError):
    """Upload exceeds DEFAULT_MAX_UPLOAD_SIZE."""


class ImageNotFoundError(FrameworkError):
    """No (non-deleted) image row for this id."""


class ProcessedImageNotFoundError(FrameworkError):
    """Image exists but the requested processed variant does not (yet)."""


class StorageError(FrameworkError):
    """Object-store backend failure."""


class DatabaseError(FrameworkError):
    """Metadata-store backend failure."""


class MessageQueueError(FrameworkError):
    """Broker produce/consume failure."""


class UnsupportedOperationError(FrameworkError):
    """Operation type not supported by the processing engine."""


class DecodeError(FrameworkError):
    """Image bytes could not be decoded."""
