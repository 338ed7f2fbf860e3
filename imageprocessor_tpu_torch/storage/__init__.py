"""Blob and metadata storage for the port: local filesystem and SQLite.

Copies of the reference's jax-free storage modules (see each file's note);
the reference's S3 and Postgres backends are not ported yet.
"""

from imageprocessor_tpu_torch.storage.localfs import LocalFSObjectStore
from imageprocessor_tpu_torch.storage.metadata import MetadataStore
from imageprocessor_tpu_torch.storage.object_store import ObjectStore
from imageprocessor_tpu_torch.storage.sqlite_meta import SQLiteMetadataStore

__all__ = ["LocalFSObjectStore", "MetadataStore", "ObjectStore",
           "SQLiteMetadataStore"]
