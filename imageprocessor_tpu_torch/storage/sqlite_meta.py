# Copy of imageprocessor_tpu/storage/sqlite_meta.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""SQLite metadata store.

Schema mirrors the reference migration (reference:
migrations/001_create_images_table.sql): `images` + `processed_images`
with an FK CASCADE and the same three indexes. SQLite in WAL mode is the
default store so the framework runs durable-metadata-complete with zero
external services; the Postgres backend implements the same interface.
"""

from __future__ import annotations

import datetime as _dt
import sqlite3
import threading
import uuid

from imageprocessor_tpu_torch.domain import Image, ImageStatus, OperationType, ProcessedImage
from imageprocessor_tpu_torch.storage.metadata import (
    MetadataStore,
    NotFound,
    row_to_image,
    row_to_processed,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS images (
    id TEXT PRIMARY KEY,
    original_filename TEXT NOT NULL,
    original_size INTEGER NOT NULL,
    mime_type TEXT NOT NULL,
    status TEXT NOT NULL DEFAULT 'uploaded',
    original_path TEXT NOT NULL,
    bucket TEXT NOT NULL,
    created_at TEXT NOT NULL,
    updated_at TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS processed_images (
    id TEXT PRIMARY KEY,
    image_id TEXT NOT NULL REFERENCES images(id) ON DELETE CASCADE,
    operation TEXT NOT NULL,
    parameters TEXT,
    path TEXT NOT NULL,
    size INTEGER NOT NULL,
    mime_type TEXT NOT NULL,
    format TEXT NOT NULL,
    status TEXT NOT NULL DEFAULT 'processing',
    created_at TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_images_status ON images(status);
CREATE INDEX IF NOT EXISTS idx_processed_images_image_id
    ON processed_images(image_id);
CREATE INDEX IF NOT EXISTS idx_processed_images_operation
    ON processed_images(operation);
"""

# Dedup legacy duplicate (image_id, operation, path) rows — written by
# the pre-upsert code — keeping one row per key. Only executed when
# creating the unique replay index fails (see __init__), so the
# full-table scan runs at most once per database, not on every start.
_DEDUP_SQL = """
DELETE FROM processed_images WHERE id NOT IN (
    SELECT MIN(id) FROM processed_images
    GROUP BY image_id, operation, path)
"""
_REPLAY_INDEX_SQL = """
CREATE UNIQUE INDEX IF NOT EXISTS idx_processed_images_replay
    ON processed_images(image_id, operation, path)
"""


def _ts(dt: _dt.datetime) -> str:
    return dt.isoformat()


def _parse_ts(s: str) -> _dt.datetime:
    return _dt.datetime.fromisoformat(s)


class SQLiteMetadataStore(MetadataStore):
    def __init__(self, path: str = ":memory:"):
        if path != ":memory:":
            import os
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA foreign_keys=ON")
            self._conn.executescript(_SCHEMA)
            try:
                self._conn.execute(_REPLAY_INDEX_SQL)
            except sqlite3.IntegrityError:
                # legacy DB with pre-upsert duplicates: dedup once, retry
                self._conn.execute(_DEDUP_SQL)
                self._conn.execute(_REPLAY_INDEX_SQL)
            self._conn.commit()

    def save_image(self, image: Image) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO images (id, original_filename, original_size,"
                " mime_type, status, original_path, bucket, created_at,"
                " updated_at) VALUES (?,?,?,?,?,?,?,?,?)",
                (image.id, image.original_filename, image.original_size,
                 image.mime_type, str(image.status), image.original_path,
                 image.bucket, _ts(image.created_at), _ts(image.updated_at)))
            self._conn.commit()

    def get_image(self, image_id: str) -> Image:
        with self._lock:
            row = self._conn.execute(
                "SELECT id, original_filename, original_size, mime_type,"
                " status, original_path, bucket, created_at, updated_at"
                " FROM images WHERE id = ? AND status != 'deleted'",
                (image_id,)).fetchone()
        if row is None:
            raise NotFound(image_id)
        return row_to_image(row, _parse_ts)

    def update_status(self, image_id: str, status: ImageStatus) -> None:
        # Soft delete is FINAL: a worker callback landing after the user
        # deleted the image (its task was still queued) must not
        # resurrect it into list/get results with its blob already gone.
        with self._lock:
            cur = self._conn.execute(
                "UPDATE images SET status = ?, updated_at = ?"
                " WHERE id = ? AND status != 'deleted'",
                (str(status), _ts(_dt.datetime.now(_dt.timezone.utc)), image_id))
            self._conn.commit()
        if cur.rowcount == 0:
            raise NotFound(image_id)

    def save_processed_image(self, processed: ProcessedImage) -> None:
        pid = processed.id or str(uuid.uuid4())
        with self._lock:
            # Idempotent under at-least-once replay: output paths are
            # deterministic per (image, operation), so a redelivered task
            # re-recording the same artifact UPSERTs its row (unique
            # index idx_processed_images_replay) — atomic even when two
            # workers replay the same lease-expired message concurrently.
            self._conn.execute(
                "INSERT INTO processed_images (id, image_id, operation,"
                " parameters, path, size, mime_type, format, status,"
                " created_at) VALUES (?,?,?,?,?,?,?,?,?,?)"
                " ON CONFLICT (image_id, operation, path) DO UPDATE SET"
                " parameters=excluded.parameters, size=excluded.size,"
                " mime_type=excluded.mime_type, format=excluded.format,"
                " status=excluded.status, created_at=excluded.created_at",
                (pid, processed.image_id, str(processed.operation),
                 processed.parameters, processed.path, processed.size,
                 processed.mime_type, str(processed.format), processed.status,
                 _ts(processed.created_at)))
            self._conn.commit()

    def get_processed_by_operation(self, image_id: str,
                                   operation: str) -> ProcessedImage | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT id, image_id, operation, parameters, path, size,"
                " mime_type, format, status, created_at FROM processed_images"
                " WHERE image_id = ? AND operation = ?"
                " ORDER BY created_at DESC LIMIT 1",
                (image_id, operation)).fetchone()
        return self._row_to_processed(row) if row else None

    def list_processed(self, image_id: str) -> list[ProcessedImage]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, image_id, operation, parameters, path, size,"
                " mime_type, format, status, created_at FROM processed_images"
                " WHERE image_id = ? ORDER BY created_at", (image_id,)).fetchall()
        return [self._row_to_processed(r) for r in rows]

    def delete_processed_images(self, image_id: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM processed_images WHERE image_id = ?", (image_id,))
            self._conn.commit()

    def list_images(self, limit: int = 50, offset: int = 0) -> list[Image]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT id, original_filename, original_size, mime_type,"
                " status, original_path, bucket, created_at, updated_at"
                " FROM images WHERE status != 'deleted'"
                " ORDER BY created_at DESC LIMIT ? OFFSET ?",
                (limit, offset)).fetchall()
        return [Image(id=r[0], original_filename=r[1], original_size=r[2],
                      mime_type=r[3], status=ImageStatus(r[4]),
                      original_path=r[5], bucket=r[6],
                      created_at=_parse_ts(r[7]), updated_at=_parse_ts(r[8]))
                for r in rows]

    @staticmethod
    def _row_to_processed(row) -> ProcessedImage:
        return row_to_processed(row, _parse_ts)

    def close(self) -> None:
        with self._lock:
            self._conn.close()
