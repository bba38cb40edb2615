"""Discovery, heartbeat failure detection, and node lifecycle (coordinator).

Counterpart of trino_tpu/server/discovery.py (copied).

Reference parity: airlift discovery announcements maintained by
DiscoveryNodeManager plus active HTTP heartbeats with an exponentially
decayed failure ratio in failuredetector/HeartbeatFailureDetector.java:76
(ping:344, failureRatio:377 vs threshold), composed with the NodeState.java
lifecycle (ACTIVE / SHUTTING_DOWN / DRAINING / DRAINED / INACTIVE).  Here
every announced worker walks an explicit state machine:

    ACTIVE ----(missed beats / failed pings)----> SUSPECT --(silence
        past the gone grace)--> GONE
    ACTIVE --(worker announces DRAINING via PUT /v1/info/state)-->
        DRAINING --(worker drains, announces DRAINED)--> DRAINED
        --(operator terminates the process, silence)--> GONE

SUSPECT is the missed-beat suspicion window: the node is unschedulable
but NOT declared dead, so a GC pause or dropped announcement round can
recover back to ACTIVE instead of triggering task reassignment.  GONE is
the terminal verdict that fans out to the schedulers (FTE reassigns the
node's unfinished tasks) and the coordinator cleanup listeners (memory
pool eviction, opstats ghost retirement).  A GONE node that announces
again rejoins as ACTIVE — late joiners and restarts become schedulable
for new stages without a coordinator restart.
"""
from __future__ import annotations

import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..utils.metrics import REGISTRY

ANNOUNCEMENT_TTL = 5.0
NODE_EXPIRY = 30.0  # forget nodes silent this long (restart churn cleanup)
FAILURE_RATIO_THRESHOLD = 0.5
DECAY = 0.7  # EMA weight of history per heartbeat
# continuous silence (no successful ping OR announcement) before a
# SUSPECT/DRAINING/DRAINED node is declared GONE; overridable per
# coordinator via the node_gone_grace_s session property
GONE_GRACE = 10.0

ACTIVE = "ACTIVE"
SUSPECT = "SUSPECT"
DRAINING = "DRAINING"
DRAINED = "DRAINED"
GONE = "GONE"
LIFECYCLE_STATES = (ACTIVE, SUSPECT, DRAINING, DRAINED, GONE)

# wire schema of one nodes_snapshot() entry (system.runtime.nodes and the
# monitor consume it); field naming linted by scripts/check_metric_names.py
NODE_FIELDS = (
    "nodeId",
    "uri",
    "state",
    "stateSince",
    "failureRatio",
    "device",
    "host",
    "processIndex",
    "localDevices",
)


class NodeState:
    def __init__(self, node_id: str, uri: str):
        self.node_id = node_id
        self.uri = uri
        now = time.time()
        self.last_announced = now
        # last successful contact of ANY kind (announcement or ping):
        # the gone-grace silence clock measures from here
        self.last_ok = now
        self.failure_ratio = 0.0
        self.last_ping_ok = True
        self.state = ACTIVE
        self.state_since = now
        # latest pool snapshot piggybacked on the announcement (consumed
        # by the coordinator-side ClusterMemoryManager)
        self.memory: Optional[dict] = None
        # latest device-health snapshot (runtime/supervisor.py): node
        # state ACTIVE/DEGRADED/QUARANTINED + per-device strike counts,
        # consumed by scheduler placement and system.runtime.nodes
        self.device: Optional[dict] = None
        # announced multi-host topology (distributed/topology.py
        # TOPOLOGY_FIELDS: host, processIndex, localDevices, ...): a node
        # carrying one is a host-sized capacity unit — losing it fires
        # HOST_GONE in addition to NODE_GONE
        self.topology: Optional[dict] = None


class NodeManager:
    """Tracks announced workers, their health, and their lifecycle."""

    def __init__(self, gone_grace: float = GONE_GRACE):
        self.nodes: Dict[str, NodeState] = {}
        self.lock = threading.Lock()
        self.gone_grace = float(gone_grace)
        # fired (node_id, uri) OUTSIDE the lock on every transition to
        # GONE: coordinator cleanup (memory eviction, opstats ghosts) and
        # anything else that must react to a node death exactly once
        self._gone_listeners: List[Callable[[str, str], None]] = []

    def add_gone_listener(self, cb: Callable[[str, str], None]):
        self._gone_listeners.append(cb)

    # -- state machine --------------------------------------------------
    def _set_state(self, n: NodeState, state: str, now: float):
        """Transition one node (caller holds the lock); returns the
        (node_id, uri, prev, new) event or None when it's a no-op."""
        if n.state == state:
            return None
        prev, n.state, n.state_since = n.state, state, now
        REGISTRY.gauge(
            "trino_tpu_node_lifecycle_state",
            "Node lifecycle ordinal (ACTIVE=0 SUSPECT=1 DRAINING=2 "
            "DRAINED=3 GONE=4)",
        ).set(LIFECYCLE_STATES.index(state), node=n.node_id)
        if state == DRAINED:
            REGISTRY.counter(
                "trino_tpu_node_drained_total",
                "Nodes that completed a graceful drain",
            ).inc()
        if state == GONE:
            REGISTRY.counter(
                "trino_tpu_node_gone_total",
                "Nodes declared GONE after the suspicion window",
            ).inc()
        from ..obs import journal

        if state == ACTIVE:
            if prev == GONE:
                journal.emit(journal.NODE_REJOIN, node_id=n.node_id)
        else:
            journal.emit(
                {
                    SUSPECT: journal.NODE_SUSPECT,
                    DRAINING: journal.NODE_DRAINING,
                    DRAINED: journal.NODE_DRAINED,
                    GONE: journal.NODE_GONE,
                }[state],
                node_id=n.node_id,
                severity=journal.ERROR if state == GONE
                else journal.WARN if state == SUSPECT else journal.INFO,
                prev=prev,
            )
            if state == GONE and n.topology:
                # host-sized unit lost: its whole device slice left the
                # mesh at once — a distinct event so the doctor can rank
                # a host loss above single-node churn
                journal.emit(
                    journal.HOST_GONE,
                    node_id=n.node_id,
                    severity=journal.ERROR,
                    host=n.topology.get("host", ""),
                    processIndex=n.topology.get("processIndex", 0),
                    localDevices=n.topology.get("localDevices", 0),
                )
                REGISTRY.counter(
                    "trino_tpu_host_gone_total",
                    "Host-sized capacity units declared GONE",
                ).inc()
                # the GLOBAL logical mesh shrank: every device in the
                # dead process's slice left at once (the cluster-level
                # analog of a quarantined device dropping out of the
                # local SPMD mesh)
                journal.emit(
                    journal.MESH_SHRINK,
                    node_id=n.node_id,
                    severity=journal.WARN,
                    host=n.topology.get("host", ""),
                    devicesLost=n.topology.get("localDevices", 0),
                )
        return (n.node_id, n.uri, prev, state)

    def _fire(self, events):
        for ev in events or ():
            if ev is None:
                continue
            node_id, uri, _prev, state = ev
            if state != GONE:
                continue
            for cb in self._gone_listeners:
                try:
                    cb(node_id, uri)
                except Exception:
                    pass

    def tick(self, now: Optional[float] = None):
        """Apply time-driven transitions: ACTIVE nodes with stale
        announcements or a tripped failure ratio become SUSPECT; any
        unreachable node (SUSPECT, or DRAINING/DRAINED whose process was
        terminated) silent past the gone grace becomes GONE."""
        now = time.time() if now is None else now
        events = []
        with self.lock:
            for n in self.nodes.values():
                if n.state == GONE:
                    continue
                unhealthy = (
                    now - n.last_announced > ANNOUNCEMENT_TTL
                    or n.failure_ratio >= FAILURE_RATIO_THRESHOLD
                )
                if n.state == ACTIVE and unhealthy:
                    events.append(self._set_state(n, SUSPECT, now))
                if (
                    n.state in (SUSPECT, DRAINING, DRAINED)
                    and now - n.last_ok > self.gone_grace
                ):
                    events.append(self._set_state(n, GONE, now))
        self._fire(events)

    # -- inputs ---------------------------------------------------------
    def announce(self, node_id: str, uri: str,
                 memory: Optional[dict] = None,
                 device: Optional[dict] = None,
                 state: Optional[str] = None,
                 topology: Optional[dict] = None):
        now = time.time()
        events = []
        with self.lock:
            n = self.nodes.get(node_id)
            if n is None:
                n = NodeState(node_id, uri)
                self.nodes[node_id] = n
            n.uri = uri
            n.last_announced = now
            n.last_ok = now
            if memory is not None:
                n.memory = memory
            if device is not None:
                n.device = device
            if topology is not None:
                n.topology = topology
            announced = state or ACTIVE
            if announced == "SHUTTING_DOWN":
                # legacy full-shutdown drain maps onto DRAINING: it also
                # refuses new work and finishes running tasks, it just
                # stops the process itself afterwards
                announced = DRAINING
            if announced in (DRAINING, DRAINED):
                events.append(self._set_state(n, announced, now))
            else:
                if n.state == GONE:
                    REGISTRY.counter(
                        "trino_tpu_node_rejoin_total",
                        "GONE nodes that announced again and rejoined",
                    ).inc()
                # new node, flap recovery, rejoin, or a drain cancelled
                # by a worker restart: the worker's word wins
                events.append(self._set_state(n, ACTIVE, now))
        self._fire(events)

    def record_ping(self, node_id: str, ok: bool):
        now = time.time()
        events = []
        with self.lock:
            n = self.nodes.get(node_id)
            if n is not None:
                n.failure_ratio = DECAY * n.failure_ratio + (1 - DECAY) * (
                    0.0 if ok else 1.0
                )
                n.last_ping_ok = ok
                if ok:
                    n.last_ok = now
                    if (
                        n.state == SUSPECT
                        and n.failure_ratio < FAILURE_RATIO_THRESHOLD
                        and now - n.last_announced < ANNOUNCEMENT_TTL
                    ):
                        # flap tolerance: the suspicion window closed
                        # without the node dying — a GC pause, not a death
                        events.append(self._set_state(n, ACTIVE, now))
        self._fire(events)

    # -- views ----------------------------------------------------------
    def alive(self) -> List[Tuple[str, str]]:
        """(node_id, uri) of schedulable workers (lifecycle ACTIVE),
        stable order.  DRAINING/DRAINED/SUSPECT/GONE nodes never appear:
        zero new placements land on a node leaving the cluster."""
        self.tick()
        with self.lock:
            out = [
                (n.node_id, n.uri)
                for n in self.nodes.values()
                if n.state == ACTIVE
            ]
        return sorted(out)

    def await_alive(
        self, min_nodes: int = 1, timeout: float = 10.0
    ) -> List[Tuple[str, str]]:
        """Block until at least ``min_nodes`` workers are ACTIVE or the
        timeout lapses; returns the alive view either way.  A restarted
        coordinator uses this to re-adopt the surviving worker set from
        discovery re-announcements (workers target the fixed coordinator
        URI, so survivors re-announce within one heartbeat interval)
        before dispatching any resumed work."""
        deadline = time.time() + max(float(timeout), 0.0)
        while True:
            alive = self.alive()
            if len(alive) >= int(min_nodes) or time.time() >= deadline:
                return alive
            time.sleep(0.05)

    def lifecycle_states(self) -> Dict[str, str]:
        """node_id -> lifecycle state (the scheduler's exclusion map)."""
        self.tick()
        with self.lock:
            return {n.node_id: n.state for n in self.nodes.values()}

    def gone_uris(self) -> Set[str]:
        """URIs of GONE nodes: FTE fails attempts on these immediately
        instead of burning the poll-failure tolerance."""
        self.tick()
        with self.lock:
            return {n.uri for n in self.nodes.values() if n.state == GONE}

    def nodes_snapshot(self) -> List[dict]:
        """One NODE_FIELDS record per known node (system.runtime.nodes)."""
        self.tick()
        with self.lock:
            return [
                {
                    "nodeId": n.node_id,
                    "uri": n.uri,
                    "state": n.state,
                    "stateSince": n.state_since,
                    "failureRatio": round(n.failure_ratio, 4),
                    "device": n.device,
                    "host": (n.topology or {}).get("host"),
                    "processIndex": (n.topology or {}).get("processIndex"),
                    "localDevices": (n.topology or {}).get("localDevices"),
                }
                for n in self.nodes.values()
            ]

    def device_states(self) -> Dict[str, dict]:
        """node_id -> latest announced device-health snapshot (nodes
        that predate the supervisor, or haven't announced one, are
        absent — callers treat missing as healthy)."""
        with self.lock:
            return {
                n.node_id: n.device
                for n in self.nodes.values()
                if n.device is not None
            }

    def all_nodes(self) -> List[NodeState]:
        """Live view for the heartbeat loop; prunes long-dead entries so
        restart churn (fresh node ids per restart) doesn't accumulate."""
        self.tick()
        now = time.time()
        with self.lock:
            dead = [
                nid
                for nid, n in self.nodes.items()
                if now - n.last_ok > NODE_EXPIRY
            ]
            for nid in dead:
                del self.nodes[nid]
            return list(self.nodes.values())


class HeartbeatFailureDetector:
    """Actively pings every announced worker's /v1/info."""

    def __init__(self, nodes: NodeManager, interval: float = 0.25):
        self.nodes = nodes
        self.interval = interval
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> "HeartbeatFailureDetector":
        self.thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.is_set():
            for n in self.nodes.all_nodes():
                if n.state == GONE:
                    # a GONE node must re-ANNOUNCE to rejoin; pinging a
                    # corpse (or its reused port) proves nothing
                    continue
                ok = True
                try:
                    with urllib.request.urlopen(
                        f"{n.uri}/v1/info", timeout=1.0
                    ) as resp:
                        ok = resp.status == 200
                except Exception:
                    ok = False
                self.nodes.record_ping(n.node_id, ok)
            self._stop.wait(self.interval)
