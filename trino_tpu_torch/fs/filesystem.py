"""The filesystem SPI: what the engine may assume about storage.

Counterpart of trino_tpu/fs/filesystem.py (copied).

Reference parity: lib/trino-filesystem TrinoFileSystem /
TrinoInputFile / TrinoOutputFile, reduced to the five operations the
connectors actually use, plus compare-and-swap on a metadata pointer —
the one primitive that turns an eventually-listable object store into a
serializable commit log (Iceberg's commit protocol assumes exactly
this: atomic swap of the table-metadata pointer, everything else
immutable).

Contract every backend must honor:

- ``write_file`` is whole-object atomic: readers see the old bytes or
  the new bytes, never a torn prefix (S3 PUT semantics).
- ``read_file`` supports ranged reads (S3 GET Range) so footer-first
  formats stay one round trip per footer.
- ``compare_and_swap(path, expected, new)`` atomically replaces the
  object iff its current content equals ``expected`` (``None`` =
  "must not exist"); returns False on mismatch WITHOUT writing.
- transient errors (throttle, 5xx analogs) surface as
  :class:`TransientObjectStoreError` and are retried by the backend
  with bounded backoff; only exhaustion raises
  :class:`ObjectStoreError` to the caller.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class FileEntry:
    """One listed object (TrinoFileSystem FileEntry analog)."""

    path: str
    size: int
    mtime_ns: int


class ObjectStoreError(IOError):
    """A storage operation failed for good (retries exhausted, missing
    object, permission)."""


class TransientObjectStoreError(ObjectStoreError):
    """A retryable failure (S3 500/503 analog) — raised internally by
    fault sites and absorbed by the retry loop; callers only see it
    wrapped in ObjectStoreError after the budget is spent."""


class TrinoFileSystem:
    """Abstract store: slash-separated keys, whole-object semantics."""

    def list_files(self, prefix: str = "") -> List[FileEntry]:
        """All objects under ``prefix``, sorted by path (S3 LIST)."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read_file(
        self, path: str, offset: int = 0, length: Optional[int] = None
    ) -> bytes:
        """Ranged GET: ``length=None`` reads to the end."""
        raise NotImplementedError

    def write_file(self, path: str, data: bytes) -> None:
        """Atomic whole-object PUT (no partial visibility)."""
        raise NotImplementedError

    def delete_file(self, path: str) -> None:
        """DELETE; missing objects are not an error (S3 semantics)."""
        raise NotImplementedError

    def compare_and_swap(
        self, path: str, expected: Optional[bytes], new: bytes
    ) -> bool:
        """Atomically replace ``path`` iff its content is ``expected``
        (``None`` = the object must not exist).  True = swapped."""
        raise NotImplementedError
