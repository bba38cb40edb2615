"""Coordinator autoscaler: elastic worker count with zero failed queries.

Counterpart of trino_tpu/server/autoscaler.py (copied).  A worker is one
device's share: the runner's scale-out spawns a worker_main subprocess on
the runner's device with a device pool sized so that the in-process
workers and ``max_workers`` subprocess workers never exceed the card.

The control loop watches three signals every tick — resource-group
backlog (queries queued across the tree), memory-admission wait, and
cluster pool pressure — and moves the worker count between
``min_workers`` and ``max_workers``:

  * **scale-out**: sustained backlog or pool pressure adds a worker via
    the pluggable ``scale_out`` callback (the test/bench harness wires
    ``DistributedQueryRunner.add_subprocess_worker``; late joiners are
    schedulable the moment they announce).
  * **scale-in**: sustained surplus capacity drains the
    highest-lexicographic ACTIVE worker through the node lifecycle: the
    coordinator marks it DRAINING in the node manager FIRST (so the
    scheduler stops placing on it before the worker even hears), then
    PUTs ``/v1/info/state DRAINING``; the worker finishes running tasks,
    flushes telemetry, and announces DRAINED.  Running queries never
    notice — scale-in mid-traffic completes with zero failed queries.

Every action lands in the incident journal (``scale_out`` /
``scale_in`` events) so the query doctor's overload rule can tell
"the cluster was saturated and grew" from "the cluster fell over".
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Callable, List, Optional

from ..utils.metrics import REGISTRY

# how long a signal must persist before the loop acts on it: reactive
# enough for a serving bench, calm enough not to flap on one burst
DEFAULT_HOLD_S = 0.5
DEFAULT_COOLDOWN_S = 2.0
DEFAULT_IDLE_GRACE_S = 1.5
DEFAULT_BACKLOG_HIGH = 4
DEFAULT_PRESSURE_HIGH = 0.85


class Autoscaler:
    """Queue-depth + pool-pressure driven worker elasticity."""

    def __init__(
        self,
        coordinator,
        scale_out: Optional[Callable[[], object]] = None,
        min_workers: int = 1,
        max_workers: int = 4,
        backlog_high: int = DEFAULT_BACKLOG_HIGH,
        pressure_high: float = DEFAULT_PRESSURE_HIGH,
        hold_s: float = DEFAULT_HOLD_S,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        idle_grace_s: float = DEFAULT_IDLE_GRACE_S,
    ):
        self.coordinator = coordinator
        self.scale_out_cb = scale_out
        self.min_workers = max(int(min_workers), 1)
        self.max_workers = max(int(max_workers), self.min_workers)
        self.backlog_high = max(int(backlog_high), 1)
        self.pressure_high = float(pressure_high)
        self.hold_s = float(hold_s)
        self.cooldown_s = float(cooldown_s)
        self.idle_grace_s = float(idle_grace_s)
        self._lock = threading.Lock()
        self._hot_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_action = 0.0
        self._busy = False
        # action records for bench/system-table reporting:
        # {"action", "nodeId", "workers", "backlog", "ts"}
        self.events: List[dict] = []

    # -- signals --------------------------------------------------------
    def _backlog(self) -> int:
        co = self.coordinator
        queued = co.resource_groups.total_queued()
        waiting = len(co.admission.stats().get("waiting") or ())
        return queued + waiting

    def _pressure(self) -> float:
        cm = self.coordinator.cluster_memory
        total = cm.cluster_total_bytes()
        if total <= 0:
            return 0.0
        return cm.cluster_reserved_bytes() / total

    def _topology_of(self, node_id: str) -> Optional[dict]:
        """The node's announced multi-host topology, if it has one —
        when set, this capacity unit is HOST-sized (a whole process with
        its own device slice), and the scale event says so."""
        nm = self.coordinator.node_manager
        try:
            with nm.lock:
                n = nm.nodes.get(node_id)
                if n is not None and n.topology:
                    return dict(n.topology)
        except Exception:  # noqa: BLE001 — telemetry only
            pass
        return None

    def _record(self, action: str, node_id: str, workers: int,
                backlog: int, topology: Optional[dict] = None):
        from ..obs import journal

        detail = {}
        if topology:
            # host-granular elasticity: the unit admitted/retired is a
            # whole host process and its device slice, not a bare node
            detail = {
                "host": topology.get("host", ""),
                "processIndex": topology.get("processIndex", 0),
                "localDevices": topology.get("localDevices", 0),
            }
        event_id = journal.emit(
            journal.SCALE_OUT if action == "scale_out"
            else journal.SCALE_IN,
            node_id=node_id,
            severity=journal.INFO,
            workers=workers,
            backlog=backlog,
            **detail,
        )
        REGISTRY.counter(
            "trino_tpu_autoscaler_actions_total",
            "Autoscaler scale actions, by direction",
        ).inc(action=action)
        self.events.append({
            "action": action,
            "nodeId": node_id,
            "workers": workers,
            "backlog": backlog,
            "eventId": event_id,
            "ts": time.time(),
            **detail,
        })

    # -- the loop body --------------------------------------------------
    def tick(self, now: Optional[float] = None):
        """One control decision; called from the coordinator's
        enforcement loop (so it shares that loop's cadence).  Actions
        run on a helper thread — ``add_subprocess_worker`` blocks until
        the new worker announces, and the enforcement loop must keep
        enforcing memory limits meanwhile."""
        nm = self.coordinator.node_manager
        if nm is None:
            return
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._busy:
                return
            backlog = self._backlog()
            pressure = self._pressure()
            alive = nm.alive()
            hot = backlog >= self.backlog_high or (
                pressure >= self.pressure_high
            )
            idle = backlog == 0 and pressure < self.pressure_high / 2
            self._hot_since = (
                (self._hot_since or now) if hot else None
            )
            self._idle_since = (
                (self._idle_since or now) if idle else None
            )
            if now - self._last_action < self.cooldown_s:
                return
            if (
                hot
                and self._hot_since is not None
                and now - self._hot_since >= self.hold_s
                and len(alive) < self.max_workers
                and self.scale_out_cb is not None
            ):
                self._busy = True
                self._last_action = now
                self._hot_since = None
                action = ("out", None, backlog, len(alive))
            elif (
                idle
                and self._idle_since is not None
                and now - self._idle_since >= self.idle_grace_s
                and len(alive) > self.min_workers
            ):
                self._busy = True
                self._last_action = now
                self._idle_since = None
                # drain the LAST worker in stable order: the runner's
                # most recently added subprocess worker sorts after the
                # long-lived in-process ones in the common harness
                victim = alive[-1]
                action = ("in", victim, backlog, len(alive))
            else:
                return
        threading.Thread(
            target=self._act, args=(action,), daemon=True
        ).start()

    def _act(self, action):
        direction, victim, backlog, workers = action
        try:
            if direction == "out":
                try:
                    added = self.scale_out_cb()
                except Exception:  # noqa: BLE001 — a failed spawn must
                    return         # not wedge the loop; cooldown retries
                # the harness spawner returns (Popen, node_id, uri):
                # resolve the admitted node's topology so a host-sized
                # admission is journaled as one
                new_id = ""
                if isinstance(added, (tuple, list)) and len(added) >= 2:
                    new_id = str(added[1])
                self._record(
                    "scale_out", new_id, workers + 1, backlog,
                    topology=self._topology_of(new_id) if new_id else None,
                )
            else:
                node_id, uri = victim
                topo = self._topology_of(node_id)
                self._drain(node_id, uri)
                self._record(
                    "scale_in", node_id, workers - 1, backlog,
                    topology=topo,
                )
        finally:
            with self._lock:
                self._busy = False

    def _drain(self, node_id: str, uri: str):
        """Graceful decommission: unschedule FIRST (node manager state
        wins immediately — zero new placements race the drain), then
        tell the worker, which finishes running tasks and announces
        DRAINED on its own."""
        nm = self.coordinator.node_manager
        nm.announce(node_id, uri, state="DRAINING")
        try:
            req = urllib.request.Request(
                f"{uri}/v1/info/state",
                data=json.dumps("DRAINING").encode(),
                headers={"Content-Type": "application/json"},
                method="PUT",
            )
            urllib.request.urlopen(req, timeout=5.0).read()
        except Exception:  # noqa: BLE001 — a dead victim is already
            pass           # unscheduled; the failure detector escalates

    def stats(self) -> dict:
        with self._lock:
            return {
                "minWorkers": self.min_workers,
                "maxWorkers": self.max_workers,
                "backlogHigh": self.backlog_high,
                "pressureHigh": self.pressure_high,
                "events": list(self.events),
            }
