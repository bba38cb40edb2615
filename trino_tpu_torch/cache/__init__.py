"""Cache subsystem: one observable home for the session's cache tiers.

Counterpart of trino_tpu/cache/__init__.py:

- signature:     canonical plan digests + determinism analysis (keys) and
                 exact fragment fingerprints
- result_cache:  query result pages, LRU + checksummed disk spill
                 (session tier)
- compile_cache: the encoded megakernel programs (process tier) and, on
                 disk under ``compile_cache_dir``, the nvcc-built kernel
                 libraries with an index of the programs

The session-owned DeviceScanCache (exec/scan.py) is the fourth tier;
CacheManager adopts it for stats, so ``system.runtime.caches`` reports
every tier in one place.  The result cache's hits, misses and evictions
flow to utils.events listeners as CacheEvents.
"""
from __future__ import annotations

from typing import Dict, List

from .compile_cache import CompileCache, shared_compile_cache
from .result_cache import FragmentResultCache
from .signature import (
    PlanSignature,
    analyze_determinism,
    fragment_fingerprint,
    plan_signature,
)

__all__ = [
    "CacheManager",
    "CompileCache",
    "FragmentResultCache",
    "PlanSignature",
    "analyze_determinism",
    "fragment_fingerprint",
    "plan_signature",
    "shared_compile_cache",
]

_ROW_COLUMNS = (
    "hits", "misses", "puts", "evictions", "entries", "bytes", "max_bytes",
    "heals", "invalidations",
)


class CacheManager:
    """Per-session facade over the cache tiers: their stats for the
    system table, and a write's invalidation."""

    def __init__(self, result_cache: FragmentResultCache,
                 compile_cache: CompileCache, scan_cache=None):
        self.result_cache = result_cache
        self.compile_cache = compile_cache
        self.scan_cache = scan_cache

    def stats_rows(self) -> List[Dict[str, int]]:
        """Fixed-schema rows for system.runtime.caches (one per tier)."""
        rows = []
        for src in (self.result_cache, self.compile_cache, self.scan_cache):
            if src is None:
                continue
            st = src.stats()
            rows.append(
                {"name": st.get("name", type(src).__name__)}
                | {c: int(st.get(c, 0)) for c in _ROW_COLUMNS}
            )
        return rows

    def snapshot(self) -> List[dict]:
        """Full stats (a superset of stats_rows)."""
        return [dict(src.stats())
                for src in (self.result_cache, self.compile_cache, self.scan_cache)
                if src is not None]

    def invalidate_table(self, catalog: str, table: str) -> None:
        """After a write or DROP: the table's scans and cached results
        are keyed by its old data version and would only hold memory."""
        if self.scan_cache is not None:
            self.scan_cache.evict_table(catalog, table)
        self.result_cache.invalidate(catalog, table)
