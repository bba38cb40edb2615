"""Local-disk object store with S3 semantics + seeded chaos.

Counterpart of trino_tpu/fs/objectstore.py (copied; its counters are the
port's utils/metrics counters, which carry no op label).

The backend maps slash-separated keys onto a root directory but keeps
object-store discipline: whole-object atomic PUT (temp file +
``os.replace``), ranged GET, idempotent DELETE, LIST-by-prefix, and
compare-and-swap under an ``fcntl`` advisory lock so concurrent
processes serialize exactly like S3 conditional writes.

Chaos: every operation passes the seeded fault sites
``objstore_latency`` (stall), ``objstore_error`` (transient 500 analog)
and ``objstore_throttle`` (503 SlowDown analog), keyed ``"{op}:{path}"``
so a rule's ``match`` can target e.g. only metadata-pointer reads.
Transient faults are retried with bounded exponential backoff — the
Dean & Barroso tail-tolerance brief applied to storage: a rule with
small ``times`` is invisible to callers (absorbed, counted), while a
persistent rule exhausts the budget and surfaces a structured
:class:`ObjectStoreError`.

Dot-prefixed names (``.xxx``) are internal (lock files, temp parts) and
never listed — the same hidden-file convention the hive connector uses
for its stats sidecars.
"""
from __future__ import annotations

import os
import time
import uuid
from typing import List, Optional

from ..utils.metrics import counter
from .filesystem import (
    FileEntry,
    ObjectStoreError,
    TransientObjectStoreError,
    TrinoFileSystem,
)

# bounded backoff: MAX_ATTEMPTS tries, BASE_BACKOFF_S * 2^i between them
MAX_ATTEMPTS = 5
BASE_BACKOFF_S = 0.005


class LocalObjectStore(TrinoFileSystem):
    """S3-style store on a local directory root.

    ``injector`` is an optional utils.faults.FaultInjector carrying
    objstore_* rules; None disables chaos entirely (zero overhead)."""

    def __init__(self, root: str, injector=None,
                 max_attempts: int = MAX_ATTEMPTS):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.injector = injector
        self.max_attempts = max(1, int(max_attempts))

    # -- key mapping ---------------------------------------------------
    def _local(self, path: str) -> str:
        p = os.path.normpath(path.strip("/"))
        if p.startswith("..") or os.path.isabs(p):
            raise ObjectStoreError(f"key escapes the store root: {path!r}")
        return os.path.join(self.root, p)

    def local_path(self, path: str) -> str:
        """Escape hatch for libraries that need a real file path
        (pyarrow parquet readers).  Local-backend only by design; a
        networked backend would download to a scratch file here."""
        return self._local(path)

    # -- chaos + retry --------------------------------------------------
    def _faults(self, op: str, path: str):
        inj = self.injector
        if inj is None:
            return
        key = f"{op}:{path}"
        inj.stall("objstore_latency", key)
        if inj.fires("objstore_throttle", key):
            raise TransientObjectStoreError(
                f"objstore throttled (injected): {op} {path}"
            )
        if inj.fires("objstore_error", key):
            raise TransientObjectStoreError(
                f"objstore transient error (injected): {op} {path}"
            )

    def _run(self, op: str, path: str, fn):
        """Retry loop: transient faults (and transient OS-level races)
        back off and retry; exhaustion raises a structured error."""
        counter("trino_tpu_objstore_ops_total").inc(op=op)
        last: Optional[Exception] = None
        for attempt in range(self.max_attempts):
            if attempt:
                counter("trino_tpu_objstore_retries_total").inc(op=op)
                time.sleep(BASE_BACKOFF_S * (1 << (attempt - 1)))
            try:
                self._faults(op, path)
                return fn()
            except TransientObjectStoreError as exc:
                last = exc
        counter("trino_tpu_objstore_errors_total").inc(op=op)
        raise ObjectStoreError(
            f"{op} {path}: retries exhausted after "
            f"{self.max_attempts} attempts: {last}"
        )

    # -- operations -----------------------------------------------------
    def list_files(self, prefix: str = "") -> List[FileEntry]:
        def _list():
            base = self._local(prefix) if prefix else self.root
            out: List[FileEntry] = []
            if not os.path.isdir(base):
                # a prefix may name a single object (S3 LIST on a key)
                if os.path.isfile(base):
                    st = os.stat(base)
                    out.append(FileEntry(
                        prefix.strip("/"), st.st_size, st.st_mtime_ns
                    ))
                return out
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(
                    d for d in dirnames if not d.startswith(".")
                )
                for fn in sorted(filenames):
                    if fn.startswith("."):
                        continue  # internal: locks, temp parts
                    full = os.path.join(dirpath, fn)
                    st = os.stat(full)
                    out.append(FileEntry(
                        os.path.relpath(full, self.root).replace(
                            os.sep, "/"
                        ),
                        st.st_size, st.st_mtime_ns,
                    ))
            out.sort(key=lambda e: e.path)
            return out

        return self._run("list", prefix or "/", _list)

    def exists(self, path: str) -> bool:
        return self._run(
            "head", path, lambda: os.path.isfile(self._local(path))
        )

    def read_file(
        self, path: str, offset: int = 0, length: Optional[int] = None
    ) -> bytes:
        def _read():
            try:
                with open(self._local(path), "rb") as f:
                    if offset:
                        f.seek(offset)
                    return f.read(length) if length is not None else f.read()
            except FileNotFoundError:
                raise ObjectStoreError(f"no such object: {path}") from None

        return self._run("get", path, _read)

    def write_file(self, path: str, data: bytes) -> None:
        def _write():
            dest = self._local(path)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            tmp = os.path.join(
                os.path.dirname(dest),
                f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}",
            )
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, dest)  # atomic: readers see old or new bytes

        self._run("put", path, _write)
        counter("trino_tpu_objstore_written_bytes").inc(len(data))

    def delete_file(self, path: str) -> None:
        def _delete():
            try:
                os.remove(self._local(path))
            except FileNotFoundError:
                pass  # S3 DELETE is idempotent

        self._run("delete", path, _delete)

    def compare_and_swap(
        self, path: str, expected: Optional[bytes], new: bytes
    ) -> bool:
        """The commit primitive: serialize via an advisory flock on a
        dot-prefixed sibling so concurrent WRITER PROCESSES (not just
        threads) observe read-compare-replace as one step."""
        import fcntl

        def _cas():
            dest = self._local(path)
            os.makedirs(os.path.dirname(dest) or self.root, exist_ok=True)
            lock = os.path.join(
                os.path.dirname(dest),
                f".{os.path.basename(dest)}.lock",
            )
            with open(lock, "a+b") as lf:
                fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
                try:
                    try:
                        with open(dest, "rb") as f:
                            current: Optional[bytes] = f.read()
                    except FileNotFoundError:
                        current = None
                    if current != expected:
                        return False
                    tmp = dest + f".{os.getpid()}.casnew"
                    with open(tmp, "wb") as f:
                        f.write(new)
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, dest)
                    return True
                finally:
                    fcntl.flock(lf.fileno(), fcntl.LOCK_UN)

        return self._run("cas", path, _cas)
