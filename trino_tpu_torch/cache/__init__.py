"""Cache subsystem: one home for the session's cache tiers.

Counterpart of trino_tpu/cache/__init__.py, without the compiled-
fragment tier (the port compiles no fragment programs; its nvcc build
directory and the megakernel program cache wait for their slice):

- signature:     canonical plan digests + determinism analysis (keys)
- result_cache:  query result pages, LRU + checksummed disk spill

The session-owned DeviceScanCache (exec/local.py) is the other tier.
The result cache's hits, misses and evictions flow to utils.events
listeners as CacheEvents (its `on_event`).
"""
from __future__ import annotations

from .result_cache import FragmentResultCache
from .signature import PlanSignature, analyze_determinism, plan_signature

__all__ = [
    "CacheManager",
    "FragmentResultCache",
    "PlanSignature",
    "analyze_determinism",
    "plan_signature",
]


class CacheManager:
    """Per-session facade over the cache tiers."""

    def __init__(self, result_cache: FragmentResultCache, scan_cache=None):
        self.result_cache = result_cache
        self.scan_cache = scan_cache

    def invalidate_table(self, catalog: str, table: str) -> None:
        """After a write or DROP: the table's scans and cached results
        are keyed by its old data version and would only hold memory."""
        if self.scan_cache is not None:
            self.scan_cache.evict_table(catalog, table)
        self.result_cache.invalidate(catalog, table)
