"""Object-store filesystem abstraction (TrinoFileSystem analog).

Counterpart of trino_tpu/fs/ (copied; counters through the port's
utils/metrics).

Reference parity: lib/trino-filesystem's TrinoFileSystem — the engine
sees storage only through list / ranged-read / atomic-write / delete
plus one primitive object stores add over POSIX: compare-and-swap on a
small metadata pointer (S3 conditional PUT If-Match, GCS generation
preconditions), which is all a snapshot table format needs for ACID
commits (connectors/lakehouse.py).

The local-disk backend (:mod:`.objectstore`) keeps S3 semantics —
whole-object atomic writes, no partial visibility, transient
latency/error/throttle faults seeded through utils/faults.py and
absorbed by bounded-backoff retries — so every chaos scenario that runs
against it is reproducible from a spec + seed.
"""
from .filesystem import (  # noqa: F401
    FileEntry,
    ObjectStoreError,
    TransientObjectStoreError,
    TrinoFileSystem,
)
from .objectstore import LocalObjectStore  # noqa: F401
