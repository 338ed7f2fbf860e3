# Copy of imageprocessor_tpu/storage/localfs.py: the port never imports the reference
# package. tests/test_torch_shared_copies.py holds it equal to the
# original until ROADMAP A.17 leaves one module where there are two.
"""Local-filesystem object store.

The zero-dependency default backend (the reference always needed MinIO;
this framework runs storage-complete on one machine). Writes are atomic
(temp file + rename) so a crashed worker never leaves a half-written
artifact — the idempotent-replay property the reference gets from MinIO
PutObject.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading

from imageprocessor_tpu_torch.storage.object_store import (
    ObjectInfo,
    ObjectNotFound,
    ObjectStore,
    original_object_path,
    sanitize_object_path,
)


class LocalFSObjectStore(ObjectStore):
    def __init__(self, root: str, fsync: bool = True):
        self.root = os.path.abspath(root)
        self.fsync = fsync
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()

    def _full(self, path: str) -> str:
        return os.path.join(self.root, sanitize_object_path(path))

    def _write_atomic(self, full: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(full), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(full), prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
                if self.fsync:
                    # fsync before the rename: a crash after os.replace
                    # but before the page cache flushes would otherwise
                    # leave a zero-length/partial file at the FINAL path
                    # — the name must never outlive the bytes it
                    # promises. LOCALFS_FSYNC=0 opts out (~10-15 ms per
                    # image on slow disks).
                    fh.flush()
                    os.fsync(fh.fileno())
            os.replace(tmp, full)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def save_original(self, filename: str, data: bytes,
                      content_type: str = "") -> str:
        # Keys carry per-call entropy (original_object_path), so
        # collisions are cryptographically unlikely even across
        # processes; the existence loop stays as a belt-and-braces
        # in-process guard.
        with self._lock:
            path = original_object_path(filename)
            full = self._full(path)
            while os.path.exists(full):
                path = original_object_path(filename)
                full = self._full(path)
            self._write_atomic(full, data)
        return path

    def save_processed(self, path: str, data: bytes,
                       content_type: str = "") -> None:
        self._write_atomic(self._full(path), data)

    def get_object(self, path: str) -> bytes:
        full = self._full(path)
        try:
            with open(full, "rb") as fh:
                return fh.read()
        except FileNotFoundError:
            raise ObjectNotFound(path) from None

    def delete_object(self, path: str) -> None:
        try:
            os.unlink(self._full(path))
        except FileNotFoundError:
            pass

    def delete_objects_with_prefix(self, prefix: str) -> int:
        # A trailing '/' means "this directory exactly" — normpath
        # strips it, and without remembering it the partial-stem branch
        # below would match SIBLING directories ('abc/' deleting
        # 'abcd/...'). Callers deleting per-image artifact dirs always
        # pass the slash (usecase delete, runtime/paths prefixes).
        dir_only = prefix.endswith("/")
        prefix = sanitize_object_path(prefix)
        base = os.path.join(self.root, prefix)
        count = 0
        if os.path.isdir(base):
            for dirpath, _dirs, files in os.walk(base):
                count += len(files)
            shutil.rmtree(base, ignore_errors=True)
            return count
        if dir_only:
            return 0  # directory-only prefix with no directory: nothing
        # Prefix may be a partial filename prefix, not a directory
        parent = os.path.dirname(base)
        stem = os.path.basename(base)
        if os.path.isdir(parent):
            for name in os.listdir(parent):
                if name.startswith(stem):
                    target = os.path.join(parent, name)
                    if os.path.isdir(target):
                        for _dp, _dn, files in os.walk(target):
                            count += len(files)
                        shutil.rmtree(target, ignore_errors=True)
                    else:
                        os.unlink(target)
                        count += 1
        return count

    def stat_object(self, path: str) -> ObjectInfo:
        full = self._full(path)
        try:
            size = os.path.getsize(full)
        except OSError:
            raise ObjectNotFound(path) from None
        return ObjectInfo(path=path, size=size)
