"""Per-worker memory arbitration: host pools + a device tier.

Counterpart of trino_tpu/memory/pools.py.  Not ported: the metrics
gauges and counters (utils/metrics.REGISTRY), the journal events the JAX
package emits on revocation and kills, the seeded `oom` fault site and
the heartbeat snapshots; the low-memory killer (which calls `kill`),
admission and the cluster view wait for the server slice.

Reference parity: memory/LocalMemoryManager.java (general + reserved
pools carved from the node budget) and MemoryPool.java:44 blocked-future
semantics — a reservation that does not fit first asks revocable
contexts to spill (MemoryRevokingScheduler analog), then blocks the
query until memory frees up or the coordinator's low-memory killer picks
a victim, and only then fails with a clean
ExceededMemoryLimitException-style error instead of crashing the
runtime.

The third pool, ``device``, accounts the card's memory: the executor
reserves a query's estimated device working set
(estimate_program_bytes / estimate_plan_scan_bytes in exec/streaming.py)
before it runs, so a query that would not fit is blocked, streamed or
refused cleanly instead of failing inside the caching allocator.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.memory import ExceededMemoryLimitError, MemoryPool

GENERAL_POOL = "general"
RESERVED_POOL = "reserved"
DEVICE_POOL = "device"

# fraction of the host budget carved out for the reserved pool, which
# admits exactly one query at a time when the general pool is exhausted
# (ReservedSystemMemoryConfig analog)
RESERVED_FRACTION = 0.1


class QueryKilledError(ExceededMemoryLimitError):
    """Raised to a blocked reservation whose query the killer chose."""


def detect_device_bytes(default: Optional[int] = None,
                        device=None) -> Optional[int]:
    """Total memory of the CUDA card (``torch.cuda.mem_get_info``);
    ``default`` on the CPU or when no card is present."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return default
    return int(torch.cuda.mem_get_info(dev)[1])


class LocalMemoryManager:
    """Arbitrates one node's host + HBM byte budgets across queries."""

    def __init__(
        self,
        host_bytes: int,
        device_bytes: Optional[int] = None,
    ):
        host_bytes = int(host_bytes)
        reserved_bytes = int(host_bytes * RESERVED_FRACTION)
        self.general = MemoryPool(host_bytes)
        self.reserved = MemoryPool(reserved_bytes)
        self.device = MemoryPool(
            int(device_bytes) if device_bytes is not None else host_bytes
        )
        self._cond = threading.Condition()
        self._reserved_owner: Optional[str] = None
        self._killed: Dict[str, str] = {}
        # (query_id, revocable bytes, listener) — listener() spills and
        # returns the number of bytes it released
        self._revocable: List[Tuple[str, int, Callable[[], int]]] = []

    # -- pools ---------------------------------------------------------
    def _pools(self) -> Dict[str, MemoryPool]:
        return {
            GENERAL_POOL: self.general,
            RESERVED_POOL: self.reserved,
            DEVICE_POOL: self.device,
        }

    def _tier_free(self, tier: str) -> int:
        if tier == "device":
            return self.device.free_bytes()
        free = self.general.free_bytes()
        if self._reserved_owner is None:
            free += self.reserved.free_bytes()
        return free

    def _try_reserve_locked(self, query_id: str, bytes_: int,
                            tier: str) -> bool:
        if tier == "device":
            return self.device.try_reserve(query_id, bytes_)
        if self.general.try_reserve(query_id, bytes_):
            return True
        # the reserved pool takes the single query that overflowed the
        # general pool (ClusterMemoryManager promoteQuery analog, done
        # locally here)
        if self._reserved_owner in (None, query_id):
            if self.reserved.try_reserve(query_id, bytes_):
                self._reserved_owner = query_id
                return True
        return False

    # -- revocation ----------------------------------------------------
    def register_revocable(self, query_id: str, bytes_: int,
                           listener: Callable[[], int]):
        """Register a spillable (revocable) reservation.

        ``listener`` is called under memory pressure; it must release
        memory (e.g. trigger exec/spill.py on its operator) and return
        the bytes freed."""
        with self._cond:
            self._revocable.append((query_id, int(bytes_), listener))

    def unregister_revocable(self, query_id: str):
        with self._cond:
            self._revocable = [
                r for r in self._revocable if r[0] != query_id
            ]

    def request_revoke(self, needed: int, exclude: str = "") -> int:
        """Ask revocable contexts (largest first) to spill ~needed bytes.

        Runs listeners outside the lock; returns bytes reported freed.
        MemoryRevokingScheduler.requestMemoryRevoking analog."""
        with self._cond:
            candidates = sorted(
                (r for r in self._revocable if r[0] != exclude),
                key=lambda r: -r[1],
            )
        revoked = 0
        fired = 0
        for _qid, _bytes, listener in candidates:
            if revoked >= needed:
                break
            try:
                freed = int(listener() or 0)
            except Exception:
                freed = 0
            if freed:
                fired += 1
                revoked += freed
        if fired:
            # listeners stay registered (a spilled context simply frees
            # nothing next time); they leave via unregister/free_query
            with self._cond:
                self._cond.notify_all()
        return revoked

    # -- reservation ---------------------------------------------------
    def reserve(
        self,
        query_id: str,
        bytes_: int,
        tier: str = "host",
        timeout: float = 0.0,
    ):
        """Reserve bytes for a query; revoke -> block -> clean error.

        With timeout == 0 the call still tries the revocation path once
        before failing, so a spillable neighbor is preferred over an
        error.  Raises ExceededMemoryLimitError (or QueryKilledError if
        the low-memory killer selected this query while it waited)."""
        bytes_ = int(bytes_)
        if bytes_ <= 0:
            return
        deadline = time.monotonic() + timeout
        revoked_once = False
        while True:
            with self._cond:
                if query_id in self._killed:
                    raise QueryKilledError(self._killed[query_id])
                if self._try_reserve_locked(query_id, bytes_, tier):
                    return
            # revocation first (once), then block until the deadline
            if not revoked_once:
                revoked_once = True
                shortfall = bytes_ - self._tier_free(tier)
                if self.request_revoke(max(shortfall, 1), exclude=query_id):
                    continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                with self._cond:
                    if query_id in self._killed:
                        raise QueryKilledError(self._killed[query_id])
                limit = (
                    self.device.size if tier == "device"
                    else self.general.size + self.reserved.size
                )
                kind = "device (HBM)" if tier == "device" else "host"
                raise ExceededMemoryLimitError(
                    f"Query exceeded per-node {kind} memory limit of "
                    f"{limit} bytes: cannot reserve {bytes_} bytes "
                    f"(query {query_id})"
                )
            with self._cond:
                self._cond.wait(min(remaining, 0.05))

    def free(self, query_id: str, bytes_: Optional[int] = None,
             tier: str = "host"):
        with self._cond:
            if tier == "device":
                self.device.free(query_id, bytes_)
            else:
                in_reserved = self.reserved.query_bytes(query_id)
                if in_reserved:
                    take = in_reserved if bytes_ is None else min(
                        bytes_, in_reserved
                    )
                    self.reserved.free(query_id, take)
                    if bytes_ is not None:
                        bytes_ -= take
                    if not self.reserved.query_bytes(query_id):
                        self._reserved_owner = None
                if bytes_ is None or bytes_ > 0:
                    self.general.free(query_id, bytes_)
            self._cond.notify_all()

    def free_query(self, query_id: str):
        """Release everything a query holds in every pool."""
        with self._cond:
            for pool in self._pools().values():
                pool.free(query_id)
            if self._reserved_owner == query_id:
                self._reserved_owner = None
            self._killed.pop(query_id, None)
            self._revocable = [
                r for r in self._revocable if r[0] != query_id
            ]
            self._cond.notify_all()

    # -- killer hook ---------------------------------------------------
    def kill(self, query_id: str, reason: str):
        """Mark a query killed; wakes any reservation blocked on it."""
        with self._cond:
            self._killed[query_id] = reason
            self._cond.notify_all()
