"""Memory accounting: the per-query limit error and a shared byte pool.

Counterpart of trino_tpu/utils/memory.py (ExceededMemoryLimitError and
MemoryPool, copied; pure Python).  Reference parity: worker
memory/MemoryPool.java:44 with per-query tagging, and the
ExceededMemoryLimitException of query.max-memory enforcement.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional


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
