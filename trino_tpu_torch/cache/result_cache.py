"""Fragment-level columnar result cache.

Counterpart of trino_tpu/cache/result_cache.py.  Presto's fragment
result caching (Sethi et al., ICDE'19) adapted to whole-plan execution:
entries are keyed by (canonical plan digest, parameterized literals,
per-table connector ``data_version`` fingerprints); the version
component makes DML invalidation implicit (a write bumps the table's
version, so the stale entry stops being addressable) while
``invalidate()`` eagerly reclaims its bytes.

Memory discipline: a byte-budgeted LRU accounted through utils.memory's
MemoryContext.  Cold (evicted) entries spill to disk as checksummed page
frames (serde.serialize_page); a corrupt spilled entry is a miss and a
heal (the frame is deleted and the query recomputes), never a query
error, and a heal is journaled (CACHE_HEAL).  `get`'s `injector` is the
session's FaultInjector (utils/faults.py), or any object with its
``corrupt(site, frame, key=)``: the ``cache_read`` site.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from ..page import Page
from ..serde import PageIntegrityError, deserialize_page, serialize_page
from ..utils.memory import MemoryContext


def page_nbytes(page: Page) -> int:
    """Retained-size estimate of a Page (values + validity + dictionaries)."""
    total = 0
    for col in page.columns:
        v = np.asarray(col.values)
        total += v.nbytes
        if col.validity is not None:
            total += np.asarray(col.validity).nbytes
        if col.dictionary is not None:
            d = np.asarray(col.dictionary, dtype=object)
            total += sum(len(str(s)) + 8 for s in d.ravel())
    return total


def key_digest(key) -> str:
    """Stable hex digest of a cache key tuple (also the spill filename)."""
    return hashlib.sha256(repr(key).encode()).hexdigest()


class _Entry:
    __slots__ = ("page", "nbytes", "tables", "path")

    def __init__(self, page, nbytes, tables, path=None):
        self.page = page  # None when spilled to disk
        self.nbytes = nbytes
        self.tables = tables  # ((catalog, table), ...) for invalidation
        self.path = path  # spill file when page is None


class FragmentResultCache:
    """Session-scoped byte-budgeted LRU of query result Pages.

    Session-scoped on purpose: catalog names do not identify data across
    sessions (two sessions' memory catalogs share names but not stores), so
    a process-global result cache would serve one session's rows to another.
    The compile cache is the process-global tier.
    """

    def __init__(
        self,
        max_bytes: int = 256 << 20,
        spill_dir: Optional[str] = None,
        spill_max_bytes: int = 1 << 30,
        max_entry_fraction: float = 0.5,
        on_event=None,
    ):
        self.max_bytes = int(max_bytes)
        self.spill_max_bytes = int(spill_max_bytes)
        self.max_entry_fraction = float(max_entry_fraction)
        self._spill_dir = spill_dir
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._spilled: "OrderedDict[str, _Entry]" = OrderedDict()
        self._lock = threading.Lock()
        self.memory = MemoryContext("result_cache")
        self._on_event = on_event
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.spills = 0
        self.spill_hits = 0
        self.heals = 0
        self.invalidations = 0
        self.rejected = 0

    # -- internals -------------------------------------------------------
    def _event(self, op: str, nbytes: int = 0) -> None:
        from ..utils.metrics import REGISTRY

        REGISTRY.counter(
            "trino_tpu_cache_op_total", "Cache operations by tier and op"
        ).inc(tier="result", op=op)
        if nbytes:
            REGISTRY.counter(
                "trino_tpu_cache_result_bytes", "Bytes moved through the result cache by op"
            ).inc(nbytes, op=op)
        if self._on_event is not None:
            self._on_event("result", op, nbytes)

    def _mem_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def _account(self) -> None:
        self.memory.set_bytes(self._mem_bytes())

    def _ensure_spill_dir(self) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="trino_tpu_torch_rcache_")
        else:
            os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    def _spill(self, digest: str, entry: _Entry) -> None:
        """Evict to disk (best effort: an unwritable spill dir degrades to
        a plain drop, never an error)."""
        try:
            frame = serialize_page(entry.page)
            spill_used = sum(e.nbytes for e in self._spilled.values())
            if len(frame) + spill_used > self.spill_max_bytes:
                return
            path = os.path.join(self._ensure_spill_dir(), digest + ".tpg")
            with open(path, "wb") as f:
                f.write(frame)
        except OSError:
            return
        self._spilled[digest] = _Entry(None, len(frame), entry.tables, path)
        self.spills += 1
        self._event("spill", len(frame))

    def _evict_to_budget(self) -> None:
        while self._entries and self._mem_bytes() > self.max_bytes:
            digest, entry = self._entries.popitem(last=False)
            self._spill(digest, entry)
            self.evictions += 1
            self._event("evict", entry.nbytes)
        self._account()

    def _drop_spilled(self, digest: str) -> None:
        entry = self._spilled.pop(digest, None)
        if entry is not None and entry.path:
            try:
                os.unlink(entry.path)
            except OSError:
                pass

    # -- public surface --------------------------------------------------
    def get(self, key, injector=None) -> Optional[Page]:
        """Lookup by key tuple.  ``injector`` is the session FaultInjector:
        the ``cache_read`` site corrupts spilled frames to exercise the
        miss-and-heal path."""
        digest = key_digest(key)
        with self._lock:
            entry = self._entries.get(digest)
            if entry is not None:
                self._entries.move_to_end(digest)
                self.hits += 1
                self._event("hit", entry.nbytes)
                return entry.page
            spilled = self._spilled.get(digest)
            if spilled is not None:
                page = self._read_spilled(digest, spilled, injector)
                if page is not None:
                    # promote back to the hot tier
                    self._drop_spilled(digest)
                    entry = _Entry(page, page_nbytes(page), spilled.tables)
                    self._entries[digest] = entry
                    self._evict_to_budget()
                    self.hits += 1
                    self.spill_hits += 1
                    self._event("hit", entry.nbytes)
                    return page
                # corrupt or unreadable: healed (deleted) inside the read
                self.misses += 1
                self._event("miss")
                return None
            self.misses += 1
            self._event("miss")
            return None

    def _read_spilled(self, digest, entry, injector) -> Optional[Page]:
        try:
            with open(entry.path, "rb") as f:
                frame = f.read()
        except OSError:
            self._drop_spilled(digest)
            self.heals += 1
            self._event("heal")
            self._journal_heal(digest, "unreadable spilled frame")
            return None
        if injector is not None:
            frame = injector.corrupt("cache_read", frame, key=digest)
        try:
            return deserialize_page(frame)
        except (PageIntegrityError, ValueError):
            # checksum mismatch / truncation: heal by deleting the frame;
            # the caller recomputes and re-caches
            self._drop_spilled(digest)
            self.heals += 1
            self._event("heal")
            self._journal_heal(digest, "checksum mismatch")
            return None

    @staticmethod
    def _journal_heal(digest: str, why: str):
        from ..obs import journal

        journal.emit(
            journal.CACHE_HEAL, severity=journal.WARN,
            digest=str(digest)[:16], reason=why,
        )

    def put(self, key, page: Page, tables=()) -> bool:
        nbytes = page_nbytes(page)
        with self._lock:
            if nbytes > self.max_bytes * self.max_entry_fraction:
                self.rejected += 1
                self._event("reject", nbytes)
                return False
            digest = key_digest(key)
            self._drop_spilled(digest)
            self._entries[digest] = _Entry(page, nbytes, tuple(tables))
            self._entries.move_to_end(digest)
            self.puts += 1
            self._event("put", nbytes)
            self._evict_to_budget()
            return True

    def invalidate(self, catalog: str, table: str) -> int:
        """Eagerly drop every entry that scanned (catalog, table); returns
        the number of entries removed.  Version-keying already prevents
        stale hits — this reclaims the bytes."""
        target = (catalog, table)
        with self._lock:
            doomed = [d for d, e in self._entries.items() if target in e.tables]
            for d in doomed:
                del self._entries[d]
            doomed_spill = [
                d for d, e in self._spilled.items() if target in e.tables
            ]
            for d in doomed_spill:
                self._drop_spilled(d)
            n = len(doomed) + len(doomed_spill)
            if n:
                self.invalidations += n
                self._event("invalidate")
            self._account()
            return n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            for d in list(self._spilled):
                self._drop_spilled(d)
            self._account()

    def stats(self) -> Dict[str, int]:
        return {
            "name": "result_cache",
            "hits": self.hits,
            "misses": self.misses,
            "puts": self.puts,
            "evictions": self.evictions,
            "entries": len(self._entries) + len(self._spilled),
            "bytes": self._mem_bytes(),
            "max_bytes": self.max_bytes,
            "heals": self.heals,
            "invalidations": self.invalidations,
        }
