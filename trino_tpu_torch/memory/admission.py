"""Memory admission control: queue queries until their peak fits.

Counterpart of trino_tpu/memory/admission.py (copied).

Reference parity: the resource-group softMemoryLimit gate in
execution/resourcegroups/InternalResourceGroup.java — a query is not
started while the cluster is over its memory budget.  Here the gate is
byte-precise: each query declares its estimated peak
(estimate_program_bytes from exec/streaming.py) and waits FIFO until
admitted reservations leave room.  A query larger than the whole budget
is still admitted when it would run alone — the limit protects
concurrency, oversized singletons are the LocalMemoryManager's problem.

Multi-tenant serving adds per-tenant shares on top of the global FIFO:
a tenant with ``memoryShare`` 0.4 may never hold more than 40% of the
budget in admitted reservations, and — critically — a waiter blocked
ONLY by its own tenant's cap does not stall the queue: later waiters
from under-share tenants admit past it, so one flooding tenant cannot
exhaust the pool or starve everyone behind its backlog.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from ..utils.memory import ExceededMemoryLimitError
from ..utils.metrics import REGISTRY


class MemoryAdmissionController:
    """FIFO byte-budget gate in front of query execution."""

    def __init__(self, capacity_fn: Callable[[], int],
                 timeout_s: float = 60.0,
                 tenant_share_fn: Optional[Callable[[str], float]] = None):
        self.capacity_fn = capacity_fn
        self.timeout_s = timeout_s
        # tenant -> fraction of the budget it may hold (0 = unlimited);
        # wired to ResourceGroupManager.tenant_memory_share
        self.tenant_share_fn = tenant_share_fn
        self._cond = threading.Condition()
        self._admitted: Dict[str, Tuple[int, str]] = {}
        # insertion order == queue order (FIFO fairness: only the head
        # of the wait queue may admit — unless the head is blocked
        # purely by its tenant share, see _fits_locked)
        self._waiting: "OrderedDict[str, Tuple[int, str]]" = OrderedDict()
        self.queued_total = 0

    def _tenant_admitted_locked(self, tenant: str) -> int:
        return sum(
            b for b, t in self._admitted.values() if t == tenant
        )

    def _tenant_fits_locked(self, tenant: str, bytes_: int) -> bool:
        """True when admitting ``bytes_`` keeps the tenant within its
        configured share.  A tenant with nothing admitted always fits —
        the share protects concurrency, oversized singletons are the
        LocalMemoryManager's problem (same escape hatch as the global
        budget)."""
        if not tenant or self.tenant_share_fn is None:
            return True
        try:
            share = float(self.tenant_share_fn(tenant) or 0.0)
        except Exception:  # noqa: BLE001 — a broken share fn must not wedge
            return True
        if share <= 0:
            return True
        used = self._tenant_admitted_locked(tenant)
        if used == 0:
            return True
        cap = share * max(int(self.capacity_fn()), 0)
        return used + bytes_ <= cap

    def _fits_locked(self, query_id: str, bytes_: int,
                     tenant: str = "") -> bool:
        if not self._admitted:
            return True
        capacity = max(int(self.capacity_fn()), 0)
        admitted = sum(b for b, _t in self._admitted.values())
        for qid, (b, t) in self._waiting.items():
            if qid == query_id:
                return (
                    admitted + bytes_ <= capacity
                    and self._tenant_fits_locked(tenant, bytes_)
                )
            # an earlier waiter holds the head position.  FIFO only
            # yields when that waiter is blocked purely by its own
            # tenant share — the pool itself has room for it, so
            # bypassing it cannot starve it of capacity it could use
            if admitted + b > capacity:
                return False
            if self._tenant_fits_locked(t, b):
                return False  # head is admissible; it just hasn't woken
        return False

    def acquire(
        self,
        query_id: str,
        bytes_: int,
        timeout_s: Optional[float] = None,
        on_queue: Optional[Callable[[], None]] = None,
        tenant: str = "",
    ):
        """Block until the estimated peak fits; then admit the query.

        Raises ExceededMemoryLimitError on timeout so the caller can
        fail the query with a clean admission error."""
        bytes_ = max(int(bytes_), 0)
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + timeout_s
        notified = False
        with self._cond:
            self._waiting[query_id] = (bytes_, tenant)
            try:
                while not self._fits_locked(query_id, bytes_, tenant):
                    if not notified:
                        notified = True
                        self.queued_total += 1
                        REGISTRY.counter(
                            "trino_tpu_memory_admission_queued_total",
                            "Queries queued by memory admission control",
                        ).inc()
                        from ..obs import journal

                        journal.emit(
                            journal.ADMISSION_BLOCK, query_id=query_id,
                            severity=journal.WARN,
                            estimatedBytes=bytes_,
                            capacityBytes=int(self.capacity_fn()),
                            tenant=tenant,
                        )
                        if on_queue is not None:
                            on_queue()
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        from ..obs import journal

                        journal.emit(
                            journal.QUEUE_TIMEOUT, query_id=query_id,
                            severity=journal.WARN,
                            estimatedBytes=bytes_,
                            capacityBytes=int(self.capacity_fn()),
                            tenant=tenant,
                            waitedS=round(timeout_s, 3),
                        )
                        raise ExceededMemoryLimitError(
                            f"Query {query_id} timed out in the memory "
                            f"admission queue: estimated peak {bytes_} "
                            f"bytes does not fit the cluster budget of "
                            f"{int(self.capacity_fn())} bytes"
                        )
                    self._cond.wait(min(remaining, 0.05))
                self._admitted[query_id] = (bytes_, tenant)
            finally:
                self._waiting.pop(query_id, None)
                self._cond.notify_all()
        self._update_gauge()

    def release(self, query_id: str):
        with self._cond:
            self._admitted.pop(query_id, None)
            self._cond.notify_all()
        self._update_gauge()

    def tenant_reserved(self) -> Dict[str, int]:
        """tenant -> admitted bytes (system.runtime.resource_groups and
        the cluster memory view surface this)."""
        with self._cond:
            out: Dict[str, int] = {}
            for b, t in self._admitted.values():
                if t:
                    out[t] = out.get(t, 0) + b
            return out

    def stats(self) -> dict:
        with self._cond:
            return {
                "admitted": {q: b for q, (b, _t) in self._admitted.items()},
                "waiting": {q: b for q, (b, _t) in self._waiting.items()},
                "queuedTotal": self.queued_total,
                "capacity": int(self.capacity_fn()),
                "tenantReserved": {
                    t: sum(
                        b for b, t2 in self._admitted.values() if t2 == t
                    )
                    for _b, t in self._admitted.values() if t
                },
            }

    def _update_gauge(self):
        with self._cond:
            admitted = sum(b for b, _t in self._admitted.values())
            waiting = sum(b for b, _t in self._waiting.values())
        REGISTRY.gauge(
            "trino_tpu_memory_admission_reserved_bytes",
            "Estimated peak bytes of currently admitted queries",
        ).set(admitted)
        REGISTRY.gauge(
            "trino_tpu_memory_admission_waiting_bytes",
            "Estimated peak bytes of queries waiting for admission",
        ).set(waiting)
