"""Resource groups: hierarchical multi-tenant admission and scheduling.

Counterpart of trino_tpu/server/resource_groups.py (copied).

Reference parity: execution/resourcegroups/InternalResourceGroup +
InternalResourceGroupManager and the file-based configuration manager
(plugin/trino-resource-group-managers): a tree of groups with concurrency
and queue limits, selectors matching (user, source) to a group, per-group
scheduling policies (``fair`` | ``weighted_fair`` | ``query_priority``)
with ``schedulingWeight``, and QUERY_QUEUE_FULL rejection.

Beyond the flat tree this adds the overload posture of *The Tail at
Scale* (Dean & Barroso): per-group queue deadlines that SHED an aged
query with a structured retryable error instead of letting it hang,
decayed CPU/slot cost accounting so a flooding tenant's effective
priority sinks under weighted-fair arbitration (it self-throttles
against its own history, no operator action needed), and per-tenant
memory shares the admission controller enforces so one tenant's
reservations cannot exhaust the pool.  Every shed and every
starvation-averted start lands in the incident journal for the query
doctor's ``overload`` rule.
"""
from __future__ import annotations

import itertools
import math
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.metrics import REGISTRY

FAIR = "fair"
WEIGHTED_FAIR = "weighted_fair"
QUERY_PRIORITY = "query_priority"
SCHEDULING_POLICIES = (FAIR, WEIGHTED_FAIR, QUERY_PRIORITY)

# a queued query that waited longer than this before the scheduler got
# to it counts as a rescued near-starvation (journal starvation_averted)
STARVATION_GRACE_S = 5.0

# decayed cost half-life: a flooding tenant's charge fades over ~30s so
# a burst self-throttles without permanently demoting the group
COST_DECAY_HALF_LIFE_S = 30.0

_SEQ = itertools.count(1)


class QueryQueueFullError(RuntimeError):
    """Reference: StandardErrorCode.QUERY_QUEUE_FULL."""

    error_code = "QUERY_QUEUE_FULL"
    retryable = True


class QueryShedError(QueryQueueFullError):
    """A queued query crossed its group's queue deadline and was shed
    (load-shedding timeout, not a capacity rejection): retryable, mapped
    to ADMISSION_TIMEOUT so clients back off instead of hammering."""

    error_code = "ADMISSION_TIMEOUT"


class _DecayedCost:
    """Exponentially decayed scalar (CPU seconds + started-query slots):
    the weighted-fair arbiter divides this by the scheduling weight, so
    a group that recently consumed more than its share loses arbitration
    until the decay forgives it."""

    def __init__(self, half_life_s: float = COST_DECAY_HALF_LIFE_S):
        self.half_life_s = max(float(half_life_s), 1e-3)
        self._value = 0.0
        self._stamp = time.monotonic()

    def _decay_to(self, now: float):
        dt = now - self._stamp
        if dt > 0:
            self._value *= math.exp(-math.log(2.0) * dt / self.half_life_s)
            self._stamp = now

    def add(self, amount: float, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self._decay_to(now)
        self._value += float(amount)

    def value(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._decay_to(now)
        return self._value


class _QueuedQuery:
    """One waiting submission: the start thunk plus everything the
    scheduler arbitrates on (age, priority, deadline) and the shed
    callback that turns a deadline miss into a structured failure."""

    __slots__ = ("start", "on_shed", "query_id", "priority",
                 "enqueued", "deadline", "seq")

    def __init__(self, start, on_shed, query_id, priority, deadline_s):
        self.start = start
        self.on_shed = on_shed
        self.query_id = query_id
        self.priority = int(priority or 0)
        self.enqueued = time.monotonic()
        self.deadline = (
            self.enqueued + deadline_s if deadline_s and deadline_s > 0
            else None
        )
        self.seq = next(_SEQ)


class InternalResourceGroup:
    """One node of the group tree (InternalResourceGroup analog).

    hard_concurrency_limit caps simultaneously running queries; max_queued
    caps the wait queue; excess submissions are rejected.  A parent's
    limits bound the sum of its children (checked transitively on
    acquire).  ``scheduling_policy`` decides which child (or own queued
    query) starts when a slot frees: ``fair`` is global FIFO by enqueue
    order, ``weighted_fair`` picks the child with the lowest decayed
    cost per unit ``scheduling_weight``, ``query_priority`` starts the
    highest-priority queued query first."""

    def __init__(
        self,
        name: str,
        hard_concurrency_limit: int = 100,
        max_queued: int = 1000,
        parent: Optional["InternalResourceGroup"] = None,
        soft_memory_limit_bytes: int = 0,
        scheduling_policy: str = FAIR,
        scheduling_weight: int = 1,
        queue_deadline_s: float = 0.0,
        memory_share: float = 0.0,
    ):
        self.name = name
        self.hard_concurrency_limit = hard_concurrency_limit
        self.max_queued = max_queued
        # softMemoryLimit analog: while the group's tracked usage is at
        # or above this, new queries queue instead of starting
        # (0 = unlimited)
        self.soft_memory_limit_bytes = soft_memory_limit_bytes
        self.memory_usage_bytes = 0
        if scheduling_policy not in SCHEDULING_POLICIES:
            raise ValueError(
                f"unknown scheduling policy {scheduling_policy!r} "
                f"(one of {SCHEDULING_POLICIES})"
            )
        self.scheduling_policy = scheduling_policy
        self.scheduling_weight = max(int(scheduling_weight), 1)
        # queued queries older than this are shed with QueryShedError
        # instead of waiting forever (0 = never shed)
        self.queue_deadline_s = float(queue_deadline_s or 0.0)
        # fraction of the cluster memory budget this group's tenant may
        # hold in admitted reservations (0 = unlimited); enforced by
        # MemoryAdmissionController through ResourceGroupManager
        self.memory_share = float(memory_share or 0.0)
        self.parent = parent
        self.running = 0
        self.queue: deque = deque()  # _QueuedQuery entries
        self.lock = parent.lock if parent else threading.Lock()
        self.children: List["InternalResourceGroup"] = []
        # decayed charge the weighted-fair arbiter keys on: one unit per
        # started query plus the CPU seconds charge_cpu() reports back
        self.cost = _DecayedCost()
        self.started_total = 0
        self.shed_total = 0
        if parent is not None:
            parent.children.append(self)

    @property
    def full_name(self) -> str:
        if self.parent is None:
            return self.name
        return f"{self.parent.full_name}.{self.name}"

    @property
    def tenant(self) -> str:
        """The tenant a query in this group bills against: the top-level
        group (direct child of the root, or the root itself)."""
        g: InternalResourceGroup = self
        while g.parent is not None and g.parent.parent is not None:
            g = g.parent
        return g.name

    def root(self) -> "InternalResourceGroup":
        g: InternalResourceGroup = self
        while g.parent is not None:
            g = g.parent
        return g

    def effective_memory_share(self) -> float:
        """This group's memory share, inheriting the nearest ancestor's
        when unset (0 all the way up = unlimited)."""
        g: Optional[InternalResourceGroup] = self
        while g is not None:
            if g.memory_share > 0:
                return g.memory_share
            g = g.parent
        return 0.0

    def _effective_deadline_s(self) -> float:
        """Queue deadline, inheriting the nearest ancestor's when this
        group does not set one."""
        g: Optional[InternalResourceGroup] = self
        while g is not None:
            if g.queue_deadline_s > 0:
                return g.queue_deadline_s
            g = g.parent
        return 0.0

    def _can_run_locked(self) -> bool:
        g: Optional[InternalResourceGroup] = self
        while g is not None:
            if g.running >= g.hard_concurrency_limit:
                return False
            if (
                g.soft_memory_limit_bytes
                and g.memory_usage_bytes >= g.soft_memory_limit_bytes
            ):
                return False
            g = g.parent
        return True

    def _add_running_locked(self, delta: int):
        g: Optional[InternalResourceGroup] = self
        while g is not None:
            g.running += delta
            g = g.parent

    def _charge_start_locked(self, now: float):
        """One started query charges a slot unit against this group and
        every ancestor (the weighted-fair arbiter reads each level)."""
        self.started_total += 1
        g: Optional[InternalResourceGroup] = self
        while g is not None:
            g.cost.add(1.0, now)
            g = g.parent

    def charge_cpu(self, seconds: float):
        """Report a finished query's wall/CPU seconds: the decayed cost
        rises, so a tenant that just burned lots of compute loses
        weighted-fair arbitration until the decay forgives it (the
        self-throttle half of softCpuLimit / cpuQuotaGeneration)."""
        if seconds <= 0:
            return
        now = time.monotonic()
        with self.lock:
            g: Optional[InternalResourceGroup] = self
            while g is not None:
                g.cost.add(float(seconds), now)
                g = g.parent

    # -- scheduling ------------------------------------------------------
    def _own_candidate_locked(self) -> Optional[_QueuedQuery]:
        if not self.queue:
            return None
        if self.scheduling_policy == QUERY_PRIORITY:
            return max(self.queue, key=lambda e: (e.priority, -e.seq))
        return self.queue[0]

    def _pick_locked(
        self, now: float
    ) -> Optional[Tuple["InternalResourceGroup", _QueuedQuery]]:
        """The next (owner, entry) eligible to start in this subtree, or
        None.  Each level applies ITS scheduling policy across its own
        queue and its children's picks; limits gate every level."""
        if not self._can_run_locked():
            # checks ancestors too, but called top-down so ancestors
            # were already vetted; self's limits are what matter here
            return None
        candidates: List[Tuple[InternalResourceGroup, _QueuedQuery]] = []
        own = self._own_candidate_locked()
        if own is not None:
            candidates.append((self, own))
        for child in self.children:
            picked = child._pick_locked(now)
            if picked is not None:
                # the arbitration source is the DIRECT child, whatever
                # depth the entry came from
                candidates.append((child, picked[1]))
        if not candidates:
            return None
        if self.scheduling_policy == WEIGHTED_FAIR:
            chosen = min(
                candidates,
                key=lambda c: (
                    c[0].cost.value(now) / c[0].scheduling_weight,
                    c[1].seq,
                ),
            )
        elif self.scheduling_policy == QUERY_PRIORITY:
            chosen = max(
                candidates, key=lambda c: (c[1].priority, -c[1].seq)
            )
        else:  # fair: global FIFO by enqueue order
            chosen = min(candidates, key=lambda c: c[1].seq)
        src, entry = chosen
        if src is self:
            return (self, entry)
        # resolve the actual owner group by re-asking the child (its
        # pick is deterministic under the lock)
        return src._pick_locked(now)

    def _drain_startable_locked(
        self, now: float
    ) -> List[Tuple["InternalResourceGroup", _QueuedQuery]]:
        """Pop every entry the tree can start right now (caller holds
        the lock); running counters are charged before release so a
        concurrent submit cannot oversubscribe."""
        started: List[Tuple[InternalResourceGroup, _QueuedQuery]] = []
        while True:
            picked = self.root()._pick_locked(now)
            if picked is None:
                return started
            owner, entry = picked
            owner.queue.remove(entry)
            owner._add_running_locked(1)
            owner._charge_start_locked(now)
            started.append((owner, entry))

    def _shed_expired_locked(
        self, now: float
    ) -> List[Tuple["InternalResourceGroup", _QueuedQuery]]:
        shed: List[Tuple[InternalResourceGroup, _QueuedQuery]] = []
        stack: List[InternalResourceGroup] = [self]
        while stack:
            g = stack.pop()
            expired = [
                e for e in g.queue
                if e.deadline is not None and now >= e.deadline
            ]
            for e in expired:
                g.queue.remove(e)
                g.shed_total += 1
                shed.append((g, e))
            stack.extend(g.children)
        return shed

    @staticmethod
    def _fire_started(started) -> None:
        now = time.monotonic()
        for owner, entry in started:
            waited = now - entry.enqueued
            if waited >= STARVATION_GRACE_S:
                # the arbiter rescued an aged query before its deadline
                # shed it: record the near-starvation for the doctor
                from ..obs import journal

                journal.emit(
                    journal.STARVATION_AVERTED,
                    query_id=entry.query_id,
                    severity=journal.WARN,
                    group=owner.full_name,
                    waitedS=round(waited, 3),
                )
                REGISTRY.counter(
                    "trino_tpu_resource_group_starvation_averted_total",
                    "Aged queued queries started before their deadline shed",
                ).inc(group=owner.full_name)
            owner._observe_gauges()
            entry.start()

    @staticmethod
    def _fire_shed(shed) -> None:
        from ..obs import journal

        for owner, entry in shed:
            waited = time.monotonic() - entry.enqueued
            err = QueryShedError(
                f"Query shed after {waited:.1f}s in the queue of resource "
                f"group \"{owner.full_name}\" (queue deadline "
                f"{owner._effective_deadline_s():.1f}s): the group is "
                f"overloaded; retry with backoff"
            )
            journal.emit(
                journal.QUERY_SHED,
                query_id=entry.query_id,
                severity=journal.WARN,
                group=owner.full_name,
                waitedS=round(waited, 3),
                queued=len(owner.queue),
            )
            REGISTRY.counter(
                "trino_tpu_resource_group_shed_total",
                "Queued queries shed past their group's queue deadline",
            ).inc(group=owner.full_name)
            owner._observe_gauges()
            if entry.on_shed is not None:
                try:
                    entry.on_shed(err)
                except Exception:  # noqa: BLE001 — shed fan-out is best-effort
                    pass

    def _observe_gauges(self):
        REGISTRY.gauge(
            "trino_tpu_resource_group_running_state",
            "Queries currently running per resource group",
        ).set(self.running, group=self.full_name)
        REGISTRY.gauge(
            "trino_tpu_resource_group_queued_state",
            "Queries currently queued per resource group",
        ).set(len(self.queue), group=self.full_name)

    # -- lifecycle -------------------------------------------------------
    def submit(
        self,
        start: Callable[[], None],
        query_id: str = "",
        priority: int = 0,
        on_shed: Optional[Callable[[Exception], None]] = None,
    ) -> str:
        """Either starts the query now (returns 'running'), queues it
        (returns 'queued'; `start` runs later — or `on_shed(err)` if the
        group's queue deadline passes first), or raises
        QueryQueueFullError."""
        now = time.monotonic()
        reject = run_now = False
        with self.lock:
            shed = self.root()._shed_expired_locked(now)
            if self._can_run_locked():
                self._add_running_locked(1)
                self._charge_start_locked(now)
                run_now = True
            elif len(self.queue) >= self.max_queued:
                reject = True
            else:
                self.queue.append(_QueuedQuery(
                    start, on_shed, query_id, priority,
                    self._effective_deadline_s(),
                ))
        self._fire_shed(shed)
        self._observe_gauges()
        if reject:
            REGISTRY.counter(
                "trino_tpu_resource_group_rejected_total",
                "Submissions rejected because the group queue was full",
            ).inc(group=self.full_name)
            raise QueryQueueFullError(
                f"Too many queued queries for \"{self.full_name}\" "
                f"(max {self.max_queued})"
            )
        if run_now:
            start()
            return "running"
        return "queued"

    def finish(self):
        """Release one running slot and start queued queries anywhere in
        the tree that now fit (processQueuedQueries walks from the root:
        a slot freed under a shared parent can admit a sibling's query),
        honoring each level's scheduling policy."""
        now = time.monotonic()
        with self.lock:
            self._add_running_locked(-1)
            shed = self.root()._shed_expired_locked(now)
            started = self._drain_startable_locked(now)
        self._fire_shed(shed)
        self._observe_gauges()
        self._fire_started(started)

    def shed_expired(self) -> int:
        """Shed every queued entry in this tree past its deadline (the
        coordinator's enforcement loop ticks this so an idle group still
        sheds on time); returns the number shed."""
        now = time.monotonic()
        with self.lock:
            shed = self.root()._shed_expired_locked(now)
            # shedding freed queue slots, never running slots, but a
            # deadline pass may coincide with startable work
            started = self._drain_startable_locked(now)
        self._fire_shed(shed)
        self._fire_started(started)
        return len(shed)

    def add_memory_usage(self, delta: int):
        """Track admitted-query memory against this group (and its
        ancestors); a negative delta re-processes the queue, since a
        group blocked on its soft memory limit may now admit."""
        now = time.monotonic()
        started = []
        with self.lock:
            g: Optional[InternalResourceGroup] = self
            while g is not None:
                g.memory_usage_bytes = max(0, g.memory_usage_bytes + delta)
                g = g.parent
            if delta < 0:
                started = self._drain_startable_locked(now)
        self._fire_started(started)

    def stats(self) -> dict:
        with self.lock:
            return {
                "name": self.full_name,
                "running": self.running,
                "queued": len(self.queue),
                "hardConcurrencyLimit": self.hard_concurrency_limit,
                "maxQueued": self.max_queued,
                "softMemoryLimitBytes": self.soft_memory_limit_bytes,
                "memoryUsageBytes": self.memory_usage_bytes,
                "schedulingPolicy": self.scheduling_policy,
                "schedulingWeight": self.scheduling_weight,
                "queueDeadlineS": self.queue_deadline_s,
                "memoryShare": self.memory_share,
                "decayedCost": round(self.cost.value(), 4),
                "startedTotal": self.started_total,
                "shedTotal": self.shed_total,
            }


class ResourceGroupManager:
    """Selector-based group assignment (InternalResourceGroupManager +
    the file-based SelectorSpec: first selector whose user/source regexes
    match wins; no match falls through to the root 'global' group)."""

    def __init__(self, config: Optional[dict] = None):
        # config: {"groups": [{"name", "hardConcurrencyLimit", "maxQueued",
        #                      "schedulingPolicy", "schedulingWeight",
        #                      "queueDeadlineS", "memoryShare",
        #                      "subGroups": [...]}, ...],
        #          "selectors": [{"user": regex, "source": regex,
        #                         "group": dotted.name}, ...]}
        self.groups: Dict[str, InternalResourceGroup] = {}
        self.selectors: List[dict] = []
        cfg = config or {}
        for g in cfg.get("groups", ()) or ():
            self._build_group(g, None)
        if "global" not in self.groups:
            self._build_group({"name": "global"}, None)
        for sel in cfg.get("selectors", ()) or ():
            self.selectors.append(sel)

    def _build_group(self, spec: dict, parent):
        g = InternalResourceGroup(
            spec["name"],
            int(spec.get("hardConcurrencyLimit", 100)),
            int(spec.get("maxQueued", 1000)),
            parent,
            soft_memory_limit_bytes=int(
                spec.get("softMemoryLimitBytes", 0)
            ),
            scheduling_policy=str(
                spec.get("schedulingPolicy", FAIR)
            ),
            scheduling_weight=int(spec.get("schedulingWeight", 1)),
            queue_deadline_s=float(spec.get("queueDeadlineS", 0.0)),
            memory_share=float(spec.get("memoryShare", 0.0)),
        )
        self.groups[g.full_name] = g
        REGISTRY.gauge(
            "trino_tpu_resource_group_weight_state",
            "Configured scheduling weight per resource group",
        ).set(g.scheduling_weight, group=g.full_name)
        for sub in spec.get("subGroups", ()) or ():
            self._build_group(sub, g)
        return g

    def select(self, user: str, source: str = "") -> InternalResourceGroup:
        for sel in self.selectors:
            if "user" in sel and not re.fullmatch(sel["user"], user or ""):
                continue
            if "source" in sel and not re.fullmatch(
                sel["source"], source or ""
            ):
                continue
            g = self.groups.get(sel["group"])
            if g is not None:
                return g
        return self.groups["global"]

    def tenant_memory_share(self, tenant: str) -> float:
        """The memory-share fraction configured for a tenant (top-level
        group name); 0 = unlimited.  The admission controller calls this
        to cap one tenant's total admitted reservations."""
        g = self.groups.get(tenant)
        if g is None:
            # tenants are bare top-level names while self.groups keys
            # dotted full names: resolve "interactive" to the root (or
            # direct child of a root) called that
            for cand in self.groups.values():
                if cand.name == tenant and (
                    cand.parent is None or cand.parent.parent is None
                ):
                    g = cand
                    break
        if g is None:
            return 0.0
        return g.effective_memory_share()

    def shed_expired(self) -> int:
        """Deadline-shed pass over every root (enforcement-loop tick)."""
        shed = 0
        for g in self.groups.values():
            if g.parent is None:
                shed += g.shed_expired()
        return shed

    def total_queued(self) -> int:
        """Queries queued across every root (autoscaler backlog signal);
        roots already aggregate nothing — queues live per group, so sum
        every group."""
        return sum(len(g.queue) for g in self.groups.values())

    def total_running(self) -> int:
        return sum(
            g.running for g in self.groups.values() if g.parent is None
        )

    def info(self) -> List[dict]:
        return [g.stats() for g in self.groups.values()]
