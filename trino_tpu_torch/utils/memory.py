"""Memory accounting: the per-query limit error and a shared byte pool.

Counterpart of trino_tpu/utils/memory.py (ExceededMemoryLimitError,
MemoryPool and MemoryContext, copied; pure Python).  Reference parity: worker
memory/MemoryPool.java:44 with per-query tagging, and the
ExceededMemoryLimitException of query.max-memory enforcement.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional


class ExceededMemoryLimitError(RuntimeError):
    pass


class MemoryPool:
    """A byte budget shared by queries (worker MemoryPool analog)."""

    def __init__(self, size: int):
        self.size = size
        self.reserved = 0
        self.by_query: Dict[str, int] = {}
        self._lock = threading.Lock()

    def reserve(self, query_id: str, bytes_: int):
        with self._lock:
            if self.reserved + bytes_ > self.size:
                raise ExceededMemoryLimitError(
                    f"pool exhausted: reserved {self.reserved + bytes_} "
                    f"> {self.size} (query {query_id})"
                )
            self.reserved += bytes_
            self.by_query[query_id] = self.by_query.get(query_id, 0) + bytes_

    def try_reserve(self, query_id: str, bytes_: int) -> bool:
        """Reserve-if-fits (the LocalMemoryManager's non-raising probe)."""
        try:
            self.reserve(query_id, bytes_)
            return True
        except ExceededMemoryLimitError:
            return False

    def free_bytes(self) -> int:
        with self._lock:
            return max(0, self.size - self.reserved)

    def query_bytes(self, query_id: str) -> int:
        with self._lock:
            return self.by_query.get(query_id, 0)

    def free(self, query_id: str, bytes_: Optional[int] = None):
        with self._lock:
            have = self.by_query.get(query_id, 0)
            amount = have if bytes_ is None else min(bytes_, have)
            self.reserved -= amount
            if amount >= have:
                self.by_query.pop(query_id, None)
            else:
                self.by_query[query_id] = have - amount


class MemoryContext:
    """Tree-structured accounting (user/revocable split)."""

    def __init__(self, name: str, parent: Optional["MemoryContext"] = None,
                 pool: Optional[MemoryPool] = None, query_id: str = ""):
        self.name = name
        self.parent = parent
        self.pool = pool if pool is not None else (
            parent.pool if parent else None
        )
        self.query_id = query_id or (parent.query_id if parent else "")
        self.user_bytes = 0
        self.revocable_bytes = 0
        self.peak = 0
        self.children: List["MemoryContext"] = []
        if parent is not None:
            parent.children.append(self)

    def new_child(self, name: str) -> "MemoryContext":
        return MemoryContext(name, self)

    def set_bytes(self, bytes_: int, revocable: bool = False):
        prev = self.revocable_bytes if revocable else self.user_bytes
        delta = bytes_ - prev
        if delta > 0 and self.pool is not None:
            self.pool.reserve(self.query_id, delta)
        elif delta < 0 and self.pool is not None:
            self.pool.free(self.query_id, -delta)
        if revocable:
            self.revocable_bytes = bytes_
        else:
            self.user_bytes = bytes_
        self.peak = max(self.peak, self.total_bytes())

    def total_bytes(self) -> int:
        return (
            self.user_bytes
            + self.revocable_bytes
            + sum(c.total_bytes() for c in self.children)
        )

    def close(self):
        if self.pool is not None:
            self.pool.free(self.query_id, self.user_bytes + self.revocable_bytes)
        self.user_bytes = 0
        self.revocable_bytes = 0
        for c in self.children:
            c.close()
