"""Pluggable low-memory killer policies.

Counterpart of trino_tpu/memory/killer.py (copied).

Reference parity: memory/LowMemoryKiller.java and
TotalReservationOnBlockedNodesLowMemoryKiller.java — when a node's pool
is blocked and nothing can make progress, pick the victim whose total
reservation across the blocked nodes is largest.  Ties break on
query id so chaos tests are deterministic.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional


class LowMemoryKiller:
    """Base policy: never kills (LowMemoryKiller NONE)."""

    name = "none"

    def choose_victim(
        self,
        nodes: Iterable[dict],
        running: Optional[Iterable[str]] = None,
    ) -> Optional[str]:
        return None


class TotalReservationOnBlockedNodesLowMemoryKiller(LowMemoryKiller):
    """Kill the query reserving the most bytes on blocked nodes."""

    name = "total-reservation-on-blocked-nodes"

    def choose_victim(
        self,
        nodes: Iterable[dict],
        running: Optional[Iterable[str]] = None,
    ) -> Optional[str]:
        allowed = set(running) if running is not None else None
        totals: Dict[str, int] = {}
        for node in nodes:
            if not node.get("blocked"):
                continue
            for pool in (node.get("pools") or {}).values():
                for qid, bytes_ in (pool.get("byQuery") or {}).items():
                    if allowed is not None and qid not in allowed:
                        continue
                    totals[qid] = totals.get(qid, 0) + int(bytes_)
        if not totals:
            return None
        return max(totals.items(), key=lambda kv: (kv[1], kv[0]))[0]


class TotalReservationLowMemoryKiller(LowMemoryKiller):
    """Kill the biggest query cluster-wide, blocked nodes or not."""

    name = "total-reservation"

    def choose_victim(
        self,
        nodes: Iterable[dict],
        running: Optional[Iterable[str]] = None,
    ) -> Optional[str]:
        allowed = set(running) if running is not None else None
        totals: Dict[str, int] = {}
        for node in nodes:
            for pool in (node.get("pools") or {}).values():
                for qid, bytes_ in (pool.get("byQuery") or {}).items():
                    if allowed is not None and qid not in allowed:
                        continue
                    totals[qid] = totals.get(qid, 0) + int(bytes_)
        if not totals:
            return None
        return max(totals.items(), key=lambda kv: (kv[1], kv[0]))[0]


_POLICIES: List[type] = [
    LowMemoryKiller,
    TotalReservationOnBlockedNodesLowMemoryKiller,
    TotalReservationLowMemoryKiller,
]


def create_killer(policy: str) -> LowMemoryKiller:
    for cls in _POLICIES:
        if cls.name == policy:
            return cls()
    raise ValueError(
        f"unknown low_memory_killer_policy {policy!r}; "
        f"expected one of {[c.name for c in _POLICIES]}"
    )
