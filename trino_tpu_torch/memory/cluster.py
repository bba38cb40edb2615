"""Coordinator-side cluster memory view + OOM arbitration.

Counterpart of trino_tpu/memory/cluster.py.  One difference: the killer
waits until its last victim has left the view before choosing another
(``_last_kill_pending``), as the reference's isLastKillTargetGone does;
the JAX package's does not wait, and a stale heartbeat then kills a
second query.

Reference parity: memory/ClusterMemoryManager.java:91 — worker
heartbeats carry pool snapshots; the coordinator aggregates them into a
cluster view, enforces query.max-total-memory
(``query_max_total_memory_bytes`` here), and when a node has been
blocked past a grace period with no progress possible, delegates victim
selection to the pluggable LowMemoryKiller and fails that query with a
structured CLUSTER_OUT_OF_MEMORY-style error.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils.metrics import REGISTRY
from .killer import LowMemoryKiller, create_killer

# a node must stay blocked this long before the killer may act
# (LowMemoryKiller delay / killOnOutOfMemoryDelay analog)
KILL_GRACE_S = 0.2

CLUSTER_OOM_MESSAGE = (
    "Query killed because the cluster is out of memory. "
    "Please try again in a few minutes."
)


class ClusterMemoryManager:
    """Aggregates per-node pool snapshots and runs OOM enforcement."""

    def __init__(
        self,
        killer: Optional[LowMemoryKiller] = None,
        kill_grace_s: float = KILL_GRACE_S,
    ):
        self.killer = killer or create_killer(
            "total-reservation-on-blocked-nodes"
        )
        self.kill_grace_s = kill_grace_s
        self._lock = threading.Lock()
        self._nodes: Dict[str, dict] = {}
        self._node_seen: Dict[str, float] = {}
        self._blocked_since: Dict[str, float] = {}
        self.kills: List[dict] = []
        # the killer's last victim: no other query is chosen while its
        # reservations still show in the view (ClusterMemoryManager's
        # isLastKillTargetGone).  A heartbeat taken before the kill woke
        # the victim's blocked reservation still reports the node blocked;
        # without this wait the next pass, past the grace already, killed
        # whichever query was running beside it
        self._last_kill: Optional[str] = None
        # query -> tenant (top-level resource group) so the cluster view
        # can bill reservations per tenant; registered by the
        # coordinator at submit, dropped when the query finalizes
        self._query_tenants: Dict[str, str] = {}

    # -- view ----------------------------------------------------------
    def update_node(self, node_id: str, snapshot: Optional[dict]):
        if not snapshot:
            return
        now = time.monotonic()
        with self._lock:
            self._nodes[node_id] = snapshot
            self._node_seen[node_id] = now
            if snapshot.get("blocked"):
                self._blocked_since.setdefault(node_id, now)
            else:
                self._blocked_since.pop(node_id, None)
        REGISTRY.gauge(
            "trino_tpu_memory_cluster_reserved_bytes",
            "Cluster-wide reserved bytes aggregated from heartbeats",
        ).set(self.cluster_reserved_bytes())

    def remove_node(self, node_id: str) -> bool:
        """Evict a dead node's snapshot from the aggregation (node went
        GONE): its reservations no longer exist anywhere, so leaving the
        snapshot in place would overstate cluster pressure, hold phantom
        per-query totals, and let the killer blame a corpse.  Returns
        whether the node was known."""
        with self._lock:
            known = self._nodes.pop(node_id, None) is not None
            self._node_seen.pop(node_id, None)
            self._blocked_since.pop(node_id, None)
        if known:
            REGISTRY.gauge(
                "trino_tpu_memory_cluster_reserved_bytes",
                "Cluster-wide reserved bytes aggregated from heartbeats",
            ).set(self.cluster_reserved_bytes())
        return known

    def nodes_view(self) -> List[dict]:
        with self._lock:
            return [dict(s, nodeId=nid) for nid, s in self._nodes.items()]

    def cluster_reserved_bytes(self) -> int:
        total = 0
        for node in self.nodes_view():
            for pool in (node.get("pools") or {}).values():
                total += int(pool.get("reserved", 0))
        return total

    def cluster_total_bytes(self) -> int:
        total = 0
        for node in self.nodes_view():
            for pool in (node.get("pools") or {}).values():
                total += int(pool.get("size", 0))
        return total

    def query_totals(self) -> Dict[str, int]:
        """Per-query reservation summed across every node and pool."""
        totals: Dict[str, int] = {}
        for node in self.nodes_view():
            for pool in (node.get("pools") or {}).values():
                for qid, bytes_ in (pool.get("byQuery") or {}).items():
                    totals[qid] = totals.get(qid, 0) + int(bytes_)
        return totals

    # -- tenancy -------------------------------------------------------
    def note_query_tenant(self, query_id: str, tenant: str):
        if tenant:
            with self._lock:
                self._query_tenants[query_id] = tenant

    def forget_query_tenant(self, query_id: str):
        with self._lock:
            self._query_tenants.pop(query_id, None)

    def tenant_totals(self) -> Dict[str, int]:
        """Per-tenant reservation: query_totals() rolled up through the
        registered query->tenant map (one tenant's live footprint, the
        share the admission controller is holding it to)."""
        with self._lock:
            tenants = dict(self._query_tenants)
        totals: Dict[str, int] = {}
        for qid, bytes_ in self.query_totals().items():
            tenant = tenants.get(qid)
            if tenant:
                totals[tenant] = totals.get(tenant, 0) + bytes_
        for tenant, bytes_ in totals.items():
            REGISTRY.gauge(
                "trino_tpu_memory_tenant_reserved_bytes",
                "Cluster-wide reserved bytes per tenant (top-level "
                "resource group)",
            ).set(bytes_, tenant=tenant)
        return totals

    def blocked_nodes(self) -> List[str]:
        now = time.monotonic()
        with self._lock:
            return [
                nid for nid, since in self._blocked_since.items()
                if now - since >= self.kill_grace_s
            ]

    # -- enforcement ---------------------------------------------------
    def process(
        self,
        kill_cb: Callable[[str, str], None],
        total_limit: Optional[int] = None,
        running: Optional[List[str]] = None,
    ) -> List[str]:
        """One enforcement pass; returns the query ids killed.

        ``kill_cb(query_id, reason)`` must fail the query with the
        structured reason (and propagate the kill to worker-local
        managers so blocked reservations wake up)."""
        killed: List[str] = []
        totals = self.query_totals()
        if total_limit:
            for qid, bytes_ in sorted(totals.items()):
                if bytes_ > total_limit:
                    self._record_kill(
                        qid,
                        f"Query exceeded distributed total memory limit "
                        f"of {total_limit} bytes: reserved {bytes_} "
                        f"bytes across the cluster",
                        kill_cb, killed,
                    )
        blocked = self.blocked_nodes()
        if blocked and not self._last_kill_pending(totals):
            view = self.nodes_view()
            victim = self.killer.choose_victim(
                view, running=running
            )
            if victim is not None and victim not in killed:
                self._record_kill(
                    victim, CLUSTER_OOM_MESSAGE, kill_cb, killed
                )
                if victim in killed:
                    self._last_kill = victim
        return killed

    def _last_kill_pending(self, totals: Dict[str, int]) -> bool:
        """True while the last victim still holds or waits for memory on
        some node (its kill has not reached the view yet)."""
        qid = self._last_kill
        if qid is None:
            return False
        with self._lock:
            waiting = any(qid in (n.get("blocked") or {})
                          for n in self._nodes.values())
        if totals.get(qid, 0) > 0 or waiting:
            return True
        self._last_kill = None
        return False

    def _record_kill(self, qid: str, reason: str, kill_cb, killed):
        try:
            kill_cb(qid, reason)
        except Exception:
            return
        killed.append(qid)
        self.kills.append({
            "queryId": qid,
            "reason": reason,
            "policy": self.killer.name,
        })
        REGISTRY.counter(
            "trino_tpu_memory_cluster_killed_total",
            "Queries killed by coordinator OOM enforcement",
        ).inc(policy=self.killer.name)

    # -- reporting -----------------------------------------------------
    def info(self) -> dict:
        """Payload for GET /v1/memory on the coordinator."""
        return {
            "totalBytes": self.cluster_total_bytes(),
            "reservedBytes": self.cluster_reserved_bytes(),
            "nodes": self.nodes_view(),
            "blockedNodes": self.blocked_nodes(),
            "queryTotals": self.query_totals(),
            "tenantTotals": self.tenant_totals(),
            "killerPolicy": self.killer.name,
            "kills": list(self.kills),
        }
