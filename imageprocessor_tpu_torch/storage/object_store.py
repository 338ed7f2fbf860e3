# Copy of imageprocessor_tpu/storage/object_store.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Object-store interface and shared path logic.

Path scheme parity (reference: internal/repository/image/cloud/minio/minio.go):
* originals land at  original/YYYY/MM/DD/{unix_nanos}{ext}  (:71-100);
* object keys are sanitized against path traversal (:24-30) and filenames
  against separators/.. (:32-39);
* processed objects carry a 1-year Cache-Control (:119-132) — surfaced
  here as metadata for backends that support it.
"""

from __future__ import annotations

import abc
import posixpath
import re
import time
from dataclasses import dataclass


class ObjectStoreError(Exception):
    pass


class ObjectNotFound(ObjectStoreError):
    pass


@dataclass
class ObjectInfo:
    path: str
    size: int
    content_type: str = ""


def sanitize_object_path(path: str) -> str:
    """Reject traversal; normalize to a clean relative key (minio.go:24-30)."""
    norm = posixpath.normpath(path.replace("\\", "/")).lstrip("/")
    if norm.startswith("..") or "/../" in f"/{norm}/":
        raise ObjectStoreError(f"invalid object path: {path!r}")
    return norm


_FILENAME_BAD = re.compile(r"[/\\\x00]|\.\.")


def sanitize_filename(name: str) -> str:
    """Strip separators and traversal from user filenames (minio.go:32-39)."""
    cleaned = _FILENAME_BAD.sub("_", name).strip() or "upload"
    return cleaned[:255]


def original_object_path(filename: str, now_ns: int | None = None,
                         entropy: str | None = None) -> str:
    """original/YYYY/MM/DD/{unixnano}-{entropy}{ext} (minio.go:71-100).

    Deliberate divergence from the reference's bare `{unixnano}{ext}`:
    two API processes saving in the same nanosecond (coarse clocks, NTP
    step-backs) would silently overwrite each other's blob — a
    process-local lock cannot prevent it and S3 PUT has no uniqueness.
    Six hex chars of per-call entropy close the cross-process collision
    class; readers resolve paths via the DB row, never by parsing the
    filename, so the layout contract (original/YYYY/MM/DD/...) holds.
    """
    import secrets

    ns = time.time_ns() if now_ns is None else now_ns
    if entropy is None:
        entropy = secrets.token_hex(3)
    t = time.gmtime(ns // 1_000_000_000)
    name = sanitize_filename(filename)
    ext = ""
    if "." in name:
        ext = "." + name.rsplit(".", 1)[1].lower()
    return (f"original/{t.tm_year:04d}/{t.tm_mon:02d}/{t.tm_mday:02d}/"
            f"{ns}-{entropy}{ext}")


class ObjectStore(abc.ABC):
    """Blob CRUD surface (minio.go FileRepository methods)."""

    @abc.abstractmethod
    def save_original(self, filename: str, data: bytes,
                      content_type: str = "") -> str:
        """Store an upload; returns the generated object path."""

    @abc.abstractmethod
    def save_processed(self, path: str, data: bytes,
                       content_type: str = "") -> None:
        """Store a processed artifact at an exact path (idempotent overwrite,
        the reference's replay-safety property, SURVEY.md §5)."""

    @abc.abstractmethod
    def get_object(self, path: str) -> bytes:
        """Fetch a blob; raises ObjectNotFound (minio.go Stat-then-get :102-117)."""

    @abc.abstractmethod
    def delete_object(self, path: str) -> None:
        """Delete one blob (no error if missing)."""

    @abc.abstractmethod
    def delete_objects_with_prefix(self, prefix: str) -> int:
        """Delete all blobs under prefix; returns count (minio.go:146-176)."""

    @abc.abstractmethod
    def stat_object(self, path: str) -> ObjectInfo:
        """Metadata without the body; raises ObjectNotFound."""

    def close(self) -> None:  # noqa: B027 — optional hook
        pass

