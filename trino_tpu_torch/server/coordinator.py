"""Coordinator HTTP server: statement protocol + introspection endpoints.

Reference parity:
  - POST /v1/statement + GET /v1/statement/executing/{id}/{slug}/{token}
    (dispatcher/QueuedStatementResource.java:158,
     server/protocol/ExecutingStatementResource.java:154)
  - DELETE cancel (:283), /v1/info, /v1/status, /v1/query list
    (ServerInfoResource, StatusResource, QueryResource)
  - query lifecycle states mirror QueryState.java:21
    (QUEUED -> PLANNING -> RUNNING -> FINISHED/FAILED)
  - dispatch/queue/track roles of DispatchManager.java:67 + QueryTracker

Implementation: stdlib ThreadingHTTPServer; queries execute on a worker
thread pool; results paged to the client in fixed-size chunks via nextUri
tokens (the long-poll pull loop of StatementClientV1.advance()).

Counterpart of trino_tpu/server/coordinator.py.  The coordinator's
session names its device (CUDA unless the caller asked for "cpu"); with
`distributed` the queries run on the announced workers, each on its own
device, pipelined or under `retry_policy` (task: fault-tolerant
execution over the spool, server/fte.py; query: whole-query re-runs).
A `coordinator_recovery_dir` turns on the write-ahead intent log and
restart recovery (server/recovery.py); `enable_autoscaler` the
elasticity loop (server/autoscaler.py); every finished query feeds the
serving observatory's census and SLOs (obs/serving_observatory.py).
The remote tasks get the session's `megakernels` too, so a worker fuses
(or not) as the session asked.
"""
from __future__ import annotations

import json
import secrets
import threading
import time
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..memory import ClusterMemoryManager, MemoryAdmissionController, create_killer
from .. import device as D
from ..page import Page
from ..session import Session
from ..sql import ast
from ..sql.parser import parse
from ..utils.metrics import REGISTRY
from ..utils.tracing import TRACER
from . import protocol
from . import recovery as _recovery
from .discovery import HeartbeatFailureDetector, NodeManager
from .resource_groups import QueryQueueFullError, ResourceGroupManager

PAGE_ROWS = 4096
# retry-policy=query backoff (QueryRetryPolicy / RetryingQueryRunner role):
# first retry waits BASE, doubling per attempt — long enough for the
# failure detector (~0.5-0.75s EMA decay) to drop a dead worker from the
# alive set before placement is re-chosen
QUERY_RETRY_BASE_S = 1.0
QUERY_RETRY_ATTEMPTS = 2


class QueryExecution:
    """One tracked query (QueryStateMachine + QueryTracker entry)."""

    def __init__(self, query_id: str, sql: str, user: str = "user"):
        self.query_id = query_id
        self.slug = secrets.token_hex(8)
        self.sql = sql
        self.user = user
        self.group = None  # resource group holding our slot
        self.state = "QUEUED"
        self.error: Optional[str] = None
        self.retry_count = 0  # whole-query re-runs under retry_policy=query
        self.adaptive_actions: list = []  # FTE mid-query replan records
        self.task_stats: list = []  # per-task stats docs (TaskInfo rollup)
        self.timeline: Optional[dict] = None  # merged operator timeline
        self.diagnosis: Optional[dict] = None  # doctor's finalize verdict
        self.straggler_flags: list = []  # dispersion-detector verdicts
        self.session_executed = False  # ran via session.execute (history
        #                                already recorded there)
        self.tenant = ""  # top-level resource group (serving observatory)
        self.plan_signature = ""  # canonical plan digest (census key)
        self.kernel_families: tuple = ()  # per-fragment family digests
        self.result_cache_hit: Optional[bool] = None  # None = not keyed
        self.result_cache_stored = False
        self.recovered = False  # re-registered from the WAL after restart
        self.resume_event_id: Optional[int] = None  # QUERY_RESUMED citation
        self.orphan_event_id: Optional[int] = None  # QUERY_ORPHANED citation
        self.page: Optional[Page] = None
        self.types = None
        # host walls of a distributed run: planning, and the scheduler's
        # dispatch / root fetch / stats reads (DistributedScheduler.timings)
        self.plan_s = 0.0
        self.sched_timings: dict = {}
        self.created = time.time()
        self.finished: Optional[float] = None
        self.lock = threading.Lock()

    def uri(self, token: int) -> str:
        return f"/v1/statement/executing/{self.query_id}/{self.slug}/{token}"


class Coordinator:
    def __init__(
        self,
        session: Session,
        workers: int = 4,
        distributed: bool = False,
        resource_groups: Optional[dict] = None,
        authenticator=None,
        fault_injection: Optional[dict] = None,
    ):
        self.session = session
        # admission control (InternalResourceGroupManager)
        self.resource_groups = ResourceGroupManager(resource_groups)
        # optional PasswordAuthenticator (security.py); None = open access
        self.authenticator = authenticator
        self.queries: Dict[str, QueryExecution] = {}
        # dispatch pool: sized above the typical resource-group
        # hard_concurrency_limit so the groups, not this executor, are
        # the concurrency authority (idle threads are cheap; a 4-thread
        # pool under a 10-slot group would silently serialize dispatch)
        self.pool = ThreadPoolExecutor(max_workers=max(workers, 16))
        self.node_id = f"coordinator-{uuid.uuid4().hex[:8]}"
        self.started = time.time()
        self.distributed = distributed
        self.node_manager = (
            NodeManager(
                gone_grace=float(
                    session.properties.get("node_gone_grace_s") or 10.0
                )
            )
            if distributed
            else None
        )
        self.failure_detector = (
            HeartbeatFailureDetector(self.node_manager).start()
            if distributed
            else None
        )
        # cluster memory view + OOM arbitration (ClusterMemoryManager
        # analog), fed by announcement-piggybacked pool snapshots and
        # the coordinator-local session manager
        self.cluster_memory = ClusterMemoryManager(
            killer=create_killer(
                session.properties.get("low_memory_killer_policy")
            )
        )
        session.cluster_memory = self.cluster_memory
        # system.runtime.nodes reads announced node + device health
        # through the session (coordinator_only system scans)
        session.node_manager = self.node_manager
        # multi-host cluster shape: host-sized units announce their
        # slice of the global mesh here (distributed/topology.py)
        from ..distributed import ClusterTopology

        self.cluster_topology = ClusterTopology()
        # memory admission gate (resource-group softMemoryLimit role):
        # queries wait in QUEUED until their estimated peak fits; tenant
        # shares cap how much of the budget one tenant's admitted
        # reservations may hold
        self.admission = MemoryAdmissionController(
            self._memory_capacity,
            tenant_share_fn=self.resource_groups.tenant_memory_share,
        )
        # system.runtime.resource_groups reads live group state through
        # the session (coordinator_only system scans)
        session.resource_group_manager = self.resource_groups
        # a session-wide default queue deadline applies to root groups
        # that don't configure their own (0 = queue forever)
        default_deadline = float(
            session.properties.get("resource_group_queue_deadline_s")
            or 0.0
        )
        if default_deadline > 0:
            for g in self.resource_groups.groups.values():
                if g.parent is None and g.queue_deadline_s <= 0:
                    g.queue_deadline_s = default_deadline
        # elasticity control loop (enable_autoscaler wires the harness's
        # scale-out hook); ticked from the enforcement loop
        self.autoscaler = None
        # live straggler detector fed by announcement-piggybacked task
        # rollups (obs/opstats); one summary per task id, ever
        from ..obs.opstats import StragglerDetector

        self.straggler_detector = StragglerDetector(
            factor=float(
                session.properties.get("straggler_dispersion_factor")
                or 2.0
            ),
            min_s=float(
                session.properties.get("fte_speculation_min_s") or 0.75
            ),
        )
        self._opstats_seen: set = set()
        self._opstats_by_stage: Dict[tuple, list] = {}
        self._opstats_lock = threading.Lock()
        if self.node_manager is not None:
            # node-death fan-out: memory-pool eviction + opstats ghost
            # retirement the moment a node is declared GONE
            self.node_manager.add_gone_listener(self._on_node_gone)
        # -- coordinator crash recovery (server/recovery.py) ------------
        # WAL + restart-time resume; the chaos injector arming the
        # seeded coordinator_death site is only ever passed by
        # coordinator_main (a subprocess coordinator) — an in-process
        # coordinator firing os._exit would take the test runner down,
        # exactly the worker_death containment rule
        self.recovered_queries = 0
        self.orphaned_queries = 0
        self.wal = None
        self.recovery = None
        recovery_dir = str(
            session.properties.get("coordinator_recovery_dir") or ""
        )
        if recovery_dir and distributed:
            from ..utils.faults import FaultInjector

            injector = (
                FaultInjector.from_spec(fault_injection)
                if fault_injection
                else None
            )
            self.wal = _recovery.CoordinatorWAL(
                recovery_dir, injector=injector
            )
            self.recovery = _recovery.RecoveryManager(
                self, recovery_dir,
                window_s=float(
                    session.properties.get("coordinator_recovery_window_s")
                    or 10.0
                ),
            )
            # synchronous: every non-terminal WAL query is back in the
            # tracker (same id, same slug) before the HTTP server ever
            # answers a poll; the resume/orphan pass runs in background
            # once discovery re-announcements rebuild the worker set
            self.recovery.register()
            threading.Thread(
                target=self.recovery.run, daemon=True
            ).start()
        # -- serving observatory (obs/serving_observatory.py) -----------
        # per-signature census + cache-affinity map + per-tenant SLO
        # burn monitor; persisted census when serving_observatory_dir is
        # set, backfilled from whatever query history survived restarts
        self.serving = self._configure_serving_observatory(
            resource_groups
        )
        self._stop_enforcement = threading.Event()
        if distributed:
            threading.Thread(
                target=self._enforcement_loop, daemon=True
            ).start()
        elif any(
            g.queue_deadline_s > 0
            for g in self.resource_groups.groups.values()
        ):
            # coordinator-only clusters with queue deadlines still need
            # a ticker: an idle queue must shed on time, not on the next
            # submit
            threading.Thread(target=self._shed_loop, daemon=True).start()

    def _configure_serving_observatory(self, resource_groups):
        """Boot the process-global serving observatory from session
        properties, declare per-tenant SLO objectives from the raw
        resource-group spec (``sloLatencyTargetS``/``sloErrorBudget``
        on top-level groups), and backfill the signature census from
        whatever persisted query history survived earlier processes."""
        from ..obs import serving_observatory as _so
        from ..obs.history import get_store

        props = self.session.properties

        def _num(key, default):
            try:
                return float(props.get(key) or default)
            except (TypeError, ValueError):
                return default

        obs = _so.configure(
            props.get("serving_observatory_dir") or None,
            max_bytes=props.get("serving_observatory_max_bytes"),
            max_signatures=int(
                props.get("signature_census_max")
                or _so.DEFAULT_MAX_SIGNATURES
            ),
            slo={
                "latency_target_s": _num(
                    "slo_latency_target_s", _so.DEFAULT_LATENCY_TARGET_S
                ),
                "error_budget": _num(
                    "slo_error_budget", _so.DEFAULT_ERROR_BUDGET
                ),
                "fast_window_s": _num(
                    "slo_fast_window_s", _so.DEFAULT_FAST_WINDOW_S
                ),
                "slow_window_s": _num(
                    "slo_slow_window_s", _so.DEFAULT_SLOW_WINDOW_S
                ),
                "burn_threshold": _num(
                    "slo_burn_threshold", _so.DEFAULT_BURN_THRESHOLD
                ),
            },
        )
        # tenants are top-level groups OR the direct children of one
        # (InternalResourceGroup.tenant), so SLO spec keys are honored
        # on both levels of the tree
        def _declare(spec):
            if not isinstance(spec, dict) or not spec.get("name"):
                return
            target = spec.get("sloLatencyTargetS")
            budget = spec.get("sloErrorBudget")
            if target is not None or budget is not None:
                obs.slo.set_objective(
                    str(spec["name"]),
                    latency_target_s=target,
                    error_budget=budget,
                )

        for spec in (resource_groups or {}).get("groups") or []:
            _declare(spec)
            for sub in (
                spec.get("subGroups") or ()
                if isinstance(spec, dict)
                else ()
            ):
                _declare(sub)
        try:
            store = get_store(
                props.get("query_history_dir") or None,
                max_bytes=int(
                    props.get("query_history_max_bytes") or (1 << 20)
                ),
            )
            obs.backfill_from_history(store.entries())
        except Exception:  # noqa: BLE001 — backfill is best-effort
            pass
        # system-table scans run through the session; the affinity map
        # needs to know which node id "this process" is
        self.session.serving_node_id = self.node_id
        return obs

    def _stash_plan_telemetry(self, q: QueryExecution, plan) -> None:
        """Stamp the query with its canonical plan signature (its query
        history record's key) and the per-fragment kernel-family digests
        (the same ``stable_key_digest(("family", fragment_fingerprint))``
        the executors' compile ledger records)."""
        try:
            from ..cache.compile_cache import stable_key_digest
            from ..cache.signature import (
                fragment_fingerprint,
                plan_signature,
            )
            from ..plan.fragment import fragment_plan

            q.plan_signature = plan_signature(plan).digest
            q.kernel_families = tuple(sorted({
                stable_key_digest(
                    ("family", fragment_fingerprint(f.root))
                )[:12]
                for f in fragment_plan(plan)
            }))
        except Exception:  # noqa: BLE001 — telemetry must not fail planning
            pass

    def enable_autoscaler(self, scale_out=None, **overrides):
        """Attach the elasticity control loop.  ``scale_out`` is the
        add-a-worker hook (DistributedQueryRunner.add_subprocess_worker
        in the harness); knobs default from session properties."""
        from .autoscaler import Autoscaler

        props = self.session.properties
        kw = {
            "min_workers": int(
                props.get("autoscale_min_workers") or 1
            ),
            "max_workers": int(
                props.get("autoscale_max_workers") or 4
            ),
            "backlog_high": int(
                props.get("autoscale_backlog_high") or 4
            ),
            "cooldown_s": float(
                props.get("autoscale_cooldown_s") or 2.0
            ),
            "idle_grace_s": float(
                props.get("autoscale_idle_grace_s") or 1.5
            ),
        }
        kw.update(overrides)
        self.autoscaler = Autoscaler(self, scale_out=scale_out, **kw)
        return self.autoscaler

    def _memory_capacity(self) -> int:
        """Admission budget: announced host pools, or the coordinator's
        own manager when no worker has announced yet."""
        total = 0
        for node in self.cluster_memory.nodes_view():
            pools = node.get("pools") or {}
            for name in ("general", "reserved"):
                total += int((pools.get(name) or {}).get("size", 0))
        if total:
            return total
        mm = self.session.memory_manager
        return mm.general.size + mm.reserved.size

    def _enforcement_loop(self):
        while not self._stop_enforcement.wait(0.1):
            try:
                self.check_cluster_memory()
            except Exception:
                pass
            try:
                self.resource_groups.shed_expired()
            except Exception:
                pass
            if self.autoscaler is not None:
                try:
                    self.autoscaler.tick()
                except Exception:
                    pass

    def _shed_loop(self):
        """Deadline-shed ticker for coordinator-only clusters (the
        distributed enforcement loop already covers this)."""
        while not self._stop_enforcement.wait(0.1):
            try:
                self.resource_groups.shed_expired()
            except Exception:
                pass

    def check_cluster_memory(self):
        """One enforcement pass: refresh the cluster view from the
        latest heartbeats, then enforce query_max_total_memory_bytes and
        the low-memory killer.  Returns the query ids killed."""
        cm = self.cluster_memory
        if self.node_manager is not None:
            for n in self.node_manager.all_nodes():
                # a GONE node's last snapshot must not resurrect the
                # eviction done by _on_node_gone
                if n.memory and n.state != "GONE":
                    cm.update_node(n.node_id, n.memory)
        cm.update_node(
            self.node_id, self.session.memory_manager.snapshot()
        )
        running = [
            q.query_id for q in self.queries.values()
            if q.state in ("QUEUED", "PLANNING", "RUNNING")
        ]
        limit = int(
            self.session.properties.get("query_max_total_memory_bytes")
            or 0
        )
        return cm.process(
            self.kill_query, total_limit=limit or None, running=running
        )

    def kill_query(self, query_id: str, reason: str):
        """Fail a query with a structured OOM reason and wake any of its
        blocked reservations on every node (killer verdict fan-out)."""
        q = self.queries.get(query_id)
        if q is None:
            raise KeyError(query_id)
        with q.lock:
            if q.state in ("FINISHED", "FAILED"):
                raise RuntimeError(f"query {query_id} already done")
            q.error = reason
            q.state = "FAILED"
            q.finished = time.time()
        self.session.memory_manager.kill(query_id, reason)
        if self.node_manager is not None:
            for _node_id, uri in self.node_manager.alive():
                try:
                    req = urllib.request.Request(
                        f"{uri}/v1/memory/kill",
                        data=json.dumps({
                            "queryId": query_id, "reason": reason,
                        }).encode(),
                        headers={"Content-Type": "application/json"},
                    )
                    urllib.request.urlopen(req, timeout=2.0).read()
                except Exception:
                    pass

    # -- lifecycle ------------------------------------------------------
    def submit(self, sql: str, user: str = "user",
               source: str = "") -> QueryExecution:
        q = QueryExecution(f"q_{uuid.uuid4().hex[:16]}", sql, user)
        self.queries[q.query_id] = q
        REGISTRY.counter(
            "trino_tpu_query_submitted_total", "Queries accepted for dispatch"
        ).inc()
        group = self.resource_groups.select(user, source)
        q.group = group
        # the tenant survives on the query even after shed/queue-full
        # paths null q.group — finalize charges the SLO monitor by it
        q.tenant = group.tenant
        self.cluster_memory.note_query_tenant(q.query_id, group.tenant)
        if self.wal is not None:
            # intent first: the query durably exists (sql + slug + group
            # + retry policy) before any dispatch — a crash from here on
            # is recoverable, and the recorded slug keeps the client's
            # nextUri valid across the restart
            self.wal.record(
                _recovery.QUERY_SUBMITTED, q.query_id,
                sql=sql, user=user, source=source, slug=q.slug,
                resourceGroup=getattr(group, "name", ""),
                retryPolicy=str(
                    self.session.properties.get("retry_policy") or ""
                ),
            )

        def on_shed(err):
            # queue-deadline shed: structured, retryable, and journaled
            # (the group emitted query_shed before calling us)
            with q.lock:
                if q.state in ("FINISHED", "FAILED"):
                    return
                q.state = "FAILED"
                q.error = f"{getattr(err, 'error_code', 'ADMISSION_TIMEOUT')}: {err}"
                q.finished = time.time()
                q.group = None
            REGISTRY.counter(
                "trino_tpu_query_failed_total",
                "Queries that reached FAILED",
            ).inc()
            try:
                self._finalize_query(q)
            except Exception:
                pass

        try:
            group.submit(
                lambda: self.pool.submit(self._run, q),
                query_id=q.query_id,
                on_shed=on_shed,
            )
        except QueryQueueFullError as e:
            with q.lock:
                q.state = "FAILED"
                q.error = f"QUERY_QUEUE_FULL: {e}"
                q.finished = time.time()
                q.group = None
            try:
                self._finalize_query(q)
            except Exception:
                pass
        return q

    def _estimated_peak_bytes(self, sql: str) -> int:
        """Static estimate of a query's peak reservation for admission
        (estimate_program_bytes over the optimized plan); 0 for utility
        statements and anything that fails to plan — those carry no scan
        working set and must not wait behind the gate."""
        try:
            stmt = parse(sql)
            if not isinstance(stmt, ast.Query):
                return 0
            plan = self.session._plan_stmt(stmt)
            from ..exec.streaming import estimate_program_bytes

            ex = self.session._executor()
            return int(estimate_program_bytes(ex, plan))
        except Exception:
            return 0

    def _run(self, q: QueryExecution):
        cancelled_group = None
        with q.lock:
            if q.state == "FAILED":  # cancelled while queued
                cancelled_group, q.group = q.group, None
                cancelled = True
            else:
                cancelled = False
        if cancelled:
            if cancelled_group is not None:
                # the dequeue charged a running slot before cancel won
                # the race: release it or the group leaks capacity
                cancelled_group.finish()
            # cancelled-while-queued queries died before the normal
            # finally-block finalize: persist them with an errorCode too,
            # or system.runtime.completed_queries never shows them
            try:
                self._finalize_query(q)
            except Exception:
                pass
            return
        admitted = False
        try:
            est = self._estimated_peak_bytes(q.sql)
            q.estimated_memory_bytes = est
            if est > 0:
                # stays QUEUED while waiting for memory headroom
                self.admission.acquire(
                    q.query_id, est,
                    timeout_s=float(
                        self.session.properties.get(
                            "memory_admission_timeout_s"
                        ) or 60.0
                    ),
                    tenant=q.group.tenant if q.group is not None else "",
                )
                admitted = True
                if q.group is not None:
                    q.group.add_memory_usage(est)
            with q.lock:
                if q.state == "FAILED":  # cancelled/killed while queued
                    return
                q.state = "PLANNING"
            page = self._execute(q)
            with q.lock:
                if q.state == "FAILED":  # killed mid-flight (OOM killer)
                    return
                q.page = page
                q.types = [c.type for c in page.columns]
                q.state = "FINISHED"
                q.finished = time.time()
            REGISTRY.counter(
                "trino_tpu_query_finished_total", "Queries that reached FINISHED"
            ).inc()
        except Exception as e:  # surfaced via the protocol error field
            with q.lock:
                if q.error is None:  # keep a killer's structured reason
                    q.error = f"{type(e).__name__}: {e}"
                q.state = "FAILED"
                q.finished = time.time()
            REGISTRY.counter(
                "trino_tpu_query_failed_total", "Queries that reached FAILED"
            ).inc()
            try:
                from ..obs import doctor, journal

                journal.emit(
                    journal.QUERY_FAILED, query_id=q.query_id,
                    severity=journal.ERROR, error=str(q.error)[:400],
                    errorCode=doctor.classify_error(q.error),
                )
            except Exception:  # noqa: BLE001 — journaling is best-effort
                pass
        finally:
            if admitted:
                self.admission.release(q.query_id)
                if q.group is not None:
                    q.group.add_memory_usage(
                        -getattr(q, "estimated_memory_bytes", 0)
                    )
            # drop any leftover local reservations/kill marks (worker
            # managers clean up in their executors' finally blocks)
            self.session.memory_manager.free_query(q.query_id)
            REGISTRY.histogram(
                "trino_tpu_query_wall_seconds", "End-to-end query wall time"
            ).observe((q.finished or time.time()) - q.created)
            try:
                self._finalize_query(q)
            except Exception:
                pass  # observability must never fail the query
            if q.group is not None:
                # decayed CPU/slot cost: a flooding tenant's charge
                # rises with every second it burns, sinking its
                # weighted-fair arbitration until the decay forgives it
                q.group.charge_cpu(
                    (q.finished or time.time()) - q.created
                )
                q.group.finish()

    def _on_node_gone(self, node_id: str, uri: str) -> None:
        """GONE fan-out: the dead node's pool snapshot leaves the cluster
        memory view (its phantom reservations would otherwise skew
        admission and the low-memory killer forever) and its in-flight
        operator-stats tasks are marked terminal so the timeline and the
        live straggler detector stop waiting on a ghost."""
        from ..obs.opstats import mark_node_tasks_terminal

        try:
            self.cluster_memory.remove_node(node_id)
        except Exception:
            pass
        try:
            # a dead host-sized unit takes its device slice with it:
            # the cluster topology stops counting its mesh share
            self.cluster_topology.forget(node_id)
        except Exception:
            pass
        try:
            with self._opstats_lock:
                retired = mark_node_tasks_terminal(
                    self._opstats_by_stage, node_id
                )
            self.straggler_detector.observe_node_gone(node_id, retired)
        except Exception:
            pass

    def ingest_compiles(self, node_id: str, snapshot) -> None:
        """Announcement piggyback: merge one worker's compile-
        observatory snapshot (per-cause counts, census sketch, new
        ledger events) into the coordinator's engine-wide view."""
        from ..obs import compile_observatory as _co

        try:
            _co.get_observatory().ingest(node_id, snapshot)
        except Exception:  # noqa: BLE001 — telemetry must not fail announce
            pass

    def ingest_opstats(self, node_id: str, summaries) -> None:
        """Heartbeat piggyback: each worker announce carries its recent
        per-task rollups.  New task ids are grouped by stage and replayed
        through the live straggler detector so dispersion flags exist
        while the query still runs (not just at the terminal merge)."""
        from ..obs.opstats import _stage_of

        changed = {}
        with self._opstats_lock:
            for s in summaries or ():
                tid = s.get("taskId")
                if not tid or tid in self._opstats_seen:
                    continue
                self._opstats_seen.add(tid)
                entry = dict(s)
                entry["nodeId"] = node_id
                stage = _stage_of(tid)
                self._opstats_by_stage.setdefault(stage, []).append(entry)
                changed[stage] = list(self._opstats_by_stage[stage])
        for stage, entries in changed.items():
            self.straggler_detector.observe_stage(stage, entries)

    def _finalize_query(self, q: QueryExecution) -> None:
        """Terminal observability: merge per-task operator rollups into
        the query timeline (QueryStats.operatorSummaries analog) and
        persist the completed query into the crash-safe history store."""
        from ..obs import opstats as _opstats
        from ..obs.history import get_store

        if self.wal is not None and q.state in ("FINISHED", "FAILED"):
            # terminal WAL record: replay after a later restart must not
            # try to resume (or orphan) a query that already completed
            self.wal.record(
                _recovery.QUERY_FINISHED
                if q.state == "FINISHED"
                else _recovery.QUERY_FAILED,
                q.query_id,
                state=q.state,
                error=str(q.error)[:400] if q.error else None,
            )
        tasks = getattr(q, "task_stats", None) or []
        if tasks and q.timeline is None:
            # fresh detector per merge so the timeline's straggler list
            # reflects this query alone (the live detector accumulates
            # across queries for metrics/announce flags)
            det = _opstats.StragglerDetector(
                factor=self.straggler_detector.factor,
                min_s=self.straggler_detector.min_s,
            )
            q.timeline = _opstats.timeline_from_tasks(tasks, detector=det)
            q.straggler_flags = list(q.straggler_flags or []) + det.flags
        from ..obs import doctor

        if not q.session_executed:
            store = get_store(
                self.session.properties.get("query_history_dir") or None,
                max_bytes=int(
                    self.session.properties.get("query_history_max_bytes")
                    or (1 << 20)
                ),
            )
            store.put({
                "query_id": q.query_id,
                "state": q.state,
                "sql": q.sql,
                "user": q.user,
                "created": q.created,
                "finished": q.finished,
                "rows": int(q.page.count) if q.page is not None else 0,
                "wall_s": (q.finished or time.time()) - q.created,
                "error": q.error,
                "error_code": doctor.classify_error(q.error),
                "tenant": getattr(q, "tenant", "") or "",
                "plan_signature":
                    getattr(q, "plan_signature", "") or "",
                "operators": (q.timeline or {}).get("operators") or None,
            })
        try:
            self._observe_serving(q)
        except Exception:
            pass  # observability must never fail the query
        # the doctor's finalize pass: failed AND finished queries get a
        # verdict (HEALTHY is itself a signal), served by
        # GET /v1/query/{id}/diagnosis and system.runtime.diagnoses
        if self.session.properties.get("query_doctor"):
            finished = q.finished or time.time()
            diag = doctor.diagnose_query(
                q.query_id,
                window=(q.created, finished),
                timeline=q.timeline,
                error=q.error,
                wall_s=finished - q.created,
            )
            doctor.record_diagnosis(diag)
            q.diagnosis = diag
        self.cluster_memory.forget_query_tenant(q.query_id)

    def _observe_serving(self, q: QueryExecution) -> None:
        """Feed one terminal query into the serving observatory: the
        signature census (latency/cost/drift/cache rollup keyed by the
        canonical plan digest) and the tenant's SLO burn windows.
        Guarded: shed paths and the dispatch finally block may both
        finalize the same query."""
        if getattr(q, "_serving_observed", False):
            return
        q._serving_observed = True
        from ..obs import serving_observatory as _so

        finished = q.finished or time.time()
        device_wall = host_wall = 0.0
        drift = None
        for frame in (q.timeline or {}).get("operators") or []:
            device_wall += float(frame.get("deviceWallS") or 0.0)
            host_wall += float(frame.get("hostWallS") or 0.0)
            est = float(frame.get("estimatedRows", 0.0) or 0.0)
            obs = float(frame.get("outputRows", 0.0) or 0.0)
            if est > 0 and obs > 0:
                ratio = max(est / obs, obs / est)
                drift = max(drift or 0.0, ratio)
        _so.get_observatory().observe_query(
            signature=getattr(q, "plan_signature", "") or "",
            tenant=getattr(q, "tenant", "") or "",
            query_id=q.query_id,
            latency_s=finished - q.created,
            ok=q.state == "FINISHED",
            device_wall_s=device_wall,
            host_wall_s=host_wall,
            drift_ratio=drift,
            cache_hit=getattr(q, "result_cache_hit", None),
            cache_stored=getattr(q, "result_cache_stored", False),
            families=getattr(q, "kernel_families", ()) or (),
            node_id=self.node_id,
            ts=finished,
        )

    def _plan_is_coordinator_only(self, plan) -> bool:
        """True when the plan scans a connector marked coordinator_only
        (the system catalog): those tables read live engine state from
        this process and are never mounted on workers."""
        from ..plan import nodes as P

        found = []

        def check(node, _depth):
            if isinstance(node, P.TableScan):
                try:
                    conn = self.session.catalogs.get(node.catalog)
                except Exception:
                    return
                if getattr(conn, "coordinator_only", False):
                    found.append(node.catalog)

        P.visit_plan(plan, check)
        return bool(found)

    def _execute(self, q: QueryExecution) -> Page:
        """Distributed mode routes plain queries through the fragment
        scheduler over announced workers (SqlQueryExecution.planDistribution
        -> PipelinedQueryScheduler); utility statements and worker-less
        clusters run in-process (coordinator-only execution)."""
        if self.distributed:
            stmt = parse(q.sql)
            if isinstance(stmt, ast.Analyze):
                # ANALYZE's synthesized aggregations ride the distributed
                # fragment scheduler like any query: per-worker partial
                # sketches (HLL/KMV) merge at the final stage exactly as
                # planStatisticsAggregation's partial/final split does
                workers = self.node_manager.alive()
                if workers:
                    from .scheduler import DistributedScheduler

                    props = self.session.properties
                    seq = [0]

                    def dispatch(plan):
                        seq[0] += 1
                        sched = DistributedScheduler(
                            self.session.catalogs, workers,
                            self._task_properties(),
                            memory_view=self.cluster_memory,
                        )
                        return sched.run(
                            plan, f"{q.query_id}_analyze{seq[0]}"
                        )

                    with q.lock:
                        q.state = "RUNNING"
                    return self.session.execute_analyze(
                        stmt, execute_plan=dispatch
                    )
            if isinstance(stmt, ast.Query):
                from .scheduler import DistributedScheduler, SchedulerError

                t_plan = time.perf_counter()
                plan = self.session._plan_stmt(stmt)
                q.plan_s = time.perf_counter() - t_plan
                self._stash_plan_telemetry(q, plan)
                if self._plan_is_coordinator_only(plan):
                    # system-catalog scans snapshot THIS process's live
                    # state (node manager, query history, metrics
                    # registry); workers don't mount the system catalog
                    # (SystemTable Distribution.SINGLE_COORDINATOR)
                    page = self.session.execute(q.sql, user=q.user)
                    q.kernel_profile = getattr(
                        self.session, "last_kernel_profile", None
                    )
                    q.session_executed = True
                    return page
                workers = self.node_manager.alive()
                if not workers:
                    raise SchedulerError(
                        "NO_NODES_AVAILABLE: no alive workers to schedule on"
                    )
                if self.wal is not None:
                    # the fragment-graph digest is the resume sanity
                    # check: replayed SQL must re-plan to this shape
                    # before any committed spool is trusted
                    self.wal.record(
                        _recovery.QUERY_PLANNED, q.query_id,
                        planDigest=_recovery.plan_digest(plan),
                    )
                # fragment result cache: a warm deterministic plan skips
                # scheduling entirely (the coordinator-side tier — workers
                # never see the query)
                rkey, hit = self.session.cached_result(plan)
                if rkey is not None:
                    q.result_cache_hit = hit is not None
                if hit is not None:
                    return hit
                with q.lock:
                    q.state = "RUNNING"
                props = self.session.properties
                task_props = self._task_properties()
                try:
                    # the query span parents every scheduler dispatch made
                    # on this thread (traceparent rides the task POSTs), so
                    # worker task spans join this trace
                    with TRACER.span("query", query_id=q.query_id):
                        if props.get("retry_policy") == "task":
                            page = self._run_fte(q, plan)
                        elif props.get("retry_policy") == "query":
                            page = self._run_with_query_retries(
                                q, plan, workers, task_props, props
                            )
                        else:
                            sched = DistributedScheduler(
                                self.session.catalogs, workers, task_props,
                                memory_view=self.cluster_memory,
                                node_manager=self.node_manager,
                            )
                            page = sched.run(plan, q.query_id)
                            # per-task stats rollup (TaskStats -> QueryStats)
                            q.task_stats = getattr(
                                sched, "last_task_stats", []
                            )
                            q.sched_timings = dict(sched.timings)
                finally:
                    TRACER.flush()
                if rkey is not None:
                    self.session.store_result(rkey, page)
                q.result_cache_stored = rkey is not None
                return page
        page = self.session.execute(q.sql, user=q.user)
        # in-process execution: the session-side executor's kernel profile
        # feeds /v1/query/{id}/profile for coordinator-only clusters
        q.kernel_profile = getattr(self.session, "last_kernel_profile", None)
        q.session_executed = True
        return page

    def _task_properties(self) -> dict:
        """Session properties forwarded to every remote task (the
        SystemSessionProperties subset workers act on)."""
        props = self.session.properties
        return {
            "memory_limit_bytes":
                props.get("query_max_memory_bytes"),
            "spill_enabled": props.get("spill_enabled"),
            "dynamic_filtering": props.get("dynamic_filtering"),
            "speculative_execution":
                props.get("speculative_execution"),
            "fte_max_attempts": props.get("fte_max_attempts"),
            "fte_task_timeout_s": props.get("fte_task_timeout_s"),
            "fte_speculation_factor":
                props.get("fte_speculation_factor"),
            "fte_speculation_min_s":
                props.get("fte_speculation_min_s"),
            "fault_injection": props.get("fault_injection"),
            "memory_blocked_timeout_s":
                props.get("memory_blocked_timeout_s"),
            "exchange_retry_attempts":
                props.get("exchange_retry_attempts"),
            "exchange_retry_budget_s":
                props.get("exchange_retry_budget_s"),
            # adaptive replanning: estimate-vs-observed divergence
            # threshold + the broadcast cutoff the flip re-checks
            "statistics_enabled": props.get("statistics_enabled"),
            "adaptive_replan_factor":
                props.get("adaptive_replan_factor"),
            "broadcast_join_threshold_rows":
                props.get("broadcast_join_threshold_rows"),
            # the fused scan->filter->aggregate kernel: a worker fuses
            # (or not) as the session asked
            "megakernels": props.get("megakernels"),
            # device-fault supervision (runtime/supervisor.py); there is
            # no CPU fallback to forward
            "device_fault_max_strikes":
                props.get("device_fault_max_strikes"),
            "device_probe_backoff_s":
                props.get("device_probe_backoff_s"),
            "device_watchdog_timeout_s":
                props.get("device_watchdog_timeout_s"),
            # per-operator timeline (obs/opstats): workers run
            # with node stats and roll frames into TaskInfo
            "operator_stats": props.get("operator_stats"),
            "straggler_dispersion_factor":
                props.get("straggler_dispersion_factor"),
            # multi-host: workers with more than one local shard run
            # eligible fragments as their host's slice
            "cross_host_mesh": props.get("cross_host_mesh"),
        }

    def _run_fte(
        self,
        q: QueryExecution,
        plan,
        qid: Optional[str] = None,
        precommitted=None,
        wal_qid: Optional[str] = None,
    ) -> Page:
        """One FTE (retry_policy=task) run with WAL intent hooks bound
        to ``wal_qid`` — always the ORIGINAL query id, so that a resumed
        run (which spools under an epoch-suffixed ``qid``) keeps
        journaling against the same replay key and a second crash
        resumes from the union of both epochs' committed records."""
        from .fte import FaultTolerantScheduler

        wal_key = wal_qid or q.query_id
        on_dispatch = on_commit = None
        if self.wal is not None:
            def on_dispatch(task_id, uri):
                self.wal.record(
                    _recovery.TASK_DISPATCHED, wal_key,
                    taskId=task_id, uri=uri,
                )

            def on_commit(sig, task_index, path):
                self.wal.record(
                    _recovery.TASK_COMMITTED, wal_key,
                    fragmentSig=sig, taskIndex=task_index,
                    spoolPath=path,
                )

        fte = FaultTolerantScheduler(
            self.session.catalogs, self.node_manager,
            properties=self._task_properties(),
            metadata=self.session.metadata,
            precommitted=precommitted,
            on_dispatch=on_dispatch, on_commit=on_commit,
        )
        page = fte.run(plan, qid or q.query_id)
        q.adaptive_actions = fte.adaptive_actions
        q.task_stats = [
            {"taskId": t["taskId"], "uri": t["uri"], **t["stats"]}
            for t in getattr(fte, "task_stats", [])
        ]
        q.sched_timings = dict(fte.timings)
        q.straggler_flags = list(
            getattr(getattr(fte, "straggler", None), "flags", ())
        )
        return page

    def _run_with_query_retries(
        self, q: QueryExecution, plan, workers, task_props, props
    ) -> Page:
        """retry-policy=QUERY (the pre-Tardigrade fault tolerance level):
        the pipelined scheduler streams between live tasks with no spool,
        so any mid-flight failure poisons the whole run — recovery is a
        bounded whole-query re-dispatch against a REFRESHED alive-worker
        set, with backoff long enough for the failure detector to retire
        the dead node first.  Each attempt runs under a suffixed query id
        so worker task state from the doomed attempt can never collide
        with (or be idempotently returned to) the retry."""
        from ..exec.exchange_client import RemoteTaskError
        from ..serde import PageIntegrityError
        from .scheduler import DistributedScheduler, SchedulerError

        max_retries = int(
            props.get("query_retry_attempts") or QUERY_RETRY_ATTEMPTS
        )
        last_error: Optional[Exception] = None
        for attempt in range(max_retries + 1):
            if attempt:
                q.retry_count = attempt
                REGISTRY.counter(
                    "trino_tpu_query_retry_total",
                    "Whole-query re-dispatches under retry_policy=query",
                ).inc()
                time.sleep(QUERY_RETRY_BASE_S * (2 ** (attempt - 1)))
                # re-resolve placement: the failed worker must be gone
                # from (or back in) the alive set before we re-dispatch
                deadline = time.time() + 10.0
                while time.time() < deadline:
                    workers = self.node_manager.alive()
                    if workers:
                        break
                    time.sleep(0.1)
                if not workers:
                    raise SchedulerError(
                        "NO_NODES_AVAILABLE: no alive workers for "
                        f"query retry {attempt}"
                    )
            qid = (
                q.query_id if attempt == 0 else f"{q.query_id}-r{attempt}"
            )
            try:
                sched = DistributedScheduler(
                    self.session.catalogs, workers, task_props,
                    node_manager=self.node_manager,
                )
                page = sched.run(plan, qid)
                q.task_stats = getattr(sched, "last_task_stats", [])
                q.sched_timings = dict(sched.timings)
                return page
            except (
                SchedulerError, RemoteTaskError, PageIntegrityError,
                OSError,  # URLError/ConnectionError: task POST hit a
                          # dead worker before any error translation ran
            ) as e:
                last_error = e
        raise SchedulerError(
            f"query failed after {max_retries} whole-query retries: "
            f"{last_error}"
        )

    def query_profile(self, q: QueryExecution) -> dict:
        """Per-query kernel profile (GET /v1/query/{id}/profile):
        per-kernel compile wall, recompiles, padding ratio, transfer
        bytes — rolled up from worker task stats in distributed mode, or
        taken from the in-process executor otherwise."""
        tasks = []
        kernels = []
        bandwidth = []
        summaries = []
        for t in getattr(q, "task_stats", []) or []:
            prof = t.get("kernelProfile")
            if not prof:
                continue
            tasks.append({
                "taskId": t.get("taskId"),
                "uri": t.get("uri"),
                "profile": prof,
            })
            kernels.extend(prof.get("kernels") or [])
            bandwidth.extend(prof.get("bandwidth") or [])
            if prof.get("summary"):
                summaries.append(prof["summary"])
        local = getattr(q, "kernel_profile", None)
        if not tasks and local:
            kernels = list(local.get("kernels") or [])
            bandwidth = list(local.get("bandwidth") or [])
            if local.get("summary"):
                summaries.append(local["summary"])
        summary = {}
        if summaries:
            actual = sum(s.get("actualRows", 0) for s in summaries)
            # the port pads nothing: a task's rows are its padded rows
            padded = sum(s.get("paddedRows", s.get("actualRows", 0))
                         for s in summaries)
            by_cause: Dict[str, int] = {}
            for s in summaries:
                for c, n in (s.get("compilesByCause") or {}).items():
                    by_cause[c] = by_cause.get(c, 0) + int(n)
            summary = {
                "kernels": sum(s.get("kernels", 0) for s in summaries),
                # a program's first run in a task is its compile (the
                # per-kernel records); builds and encodes are by cause
                "compiles": sum(int(k.get("compiles", 0)) for k in kernels),
                "recompiles": sum(s.get("recompiles", 0) for s in summaries),
                "compilesByCause": by_cause,
                "cacheHits": sum(s.get("cacheHits", 0) for s in summaries),
                "compileWallS": sum(
                    s.get("compileWallS", 0.0) for s in summaries
                ),
                "actualRows": actual,
                "paddedRows": padded,
                "paddingRatio": (padded / actual) if actual else 1.0,
                "h2dBytes": sum(s.get("h2dBytes", 0) for s in summaries),
                "d2hBytes": sum(s.get("d2hBytes", 0) for s in summaries),
            }
            # HBM bandwidth ledger rollup: cluster-wide effective GB/s
            # over the summed per-task byte/wall accounting
            led_bytes = sum(s.get("ledgerBytes", 0) for s in summaries)
            led_wall = sum(s.get("deviceWallS", 0.0) for s in summaries)
            if led_bytes or led_wall:
                summary["ledgerBytes"] = led_bytes
                summary["deviceWallS"] = led_wall
                summary["effectiveGbps"] = (
                    led_bytes / led_wall / 1e9 if led_wall > 0 else 0.0
                )
        bandwidth.sort(key=lambda e: e.get("totalBytes", 0), reverse=True)
        return {
            "queryId": q.query_id,
            "state": q.state,
            "kernels": kernels,
            "bandwidth": bandwidth,
            "summary": summary,
            "tasks": tasks,
        }

    def in_recovery_window(self) -> bool:
        """True while a restarted coordinator may still be replaying its
        WAL: polls for query ids we don't know yet answer 503 +
        Retry-After (the client waits) instead of 404 (the client would
        fail).  Closed as soon as the recovery pass finishes — after
        that an unknown id is genuinely unknown."""
        r = self.recovery
        if r is None or r.done.is_set():
            return False
        return time.time() < self.started + r.window_s

    def cancel(self, query_id: str):
        q = self.queries.get(query_id)
        if q:
            with q.lock:
                if q.state not in ("FINISHED", "FAILED"):
                    q.state = "FAILED"
                    q.error = "Query was canceled"
                    q.finished = time.time()

    # -- protocol documents ---------------------------------------------
    def results_doc(self, q: QueryExecution, token: int) -> dict:
        with q.lock:
            state = q.state
            if state in ("QUEUED", "PLANNING", "RUNNING"):
                return protocol.query_results(
                    q.query_id, state, next_uri=q.uri(token)
                )
            if state == "FAILED":
                return protocol.query_results(
                    q.query_id, "FAILED", error=q.error
                )
            # FINISHED: page out rows in chunks
            page = q.page
            page_rows = int(
                self.session.properties.get("client_page_rows")
                or PAGE_ROWS
            )
            start = token * page_rows
            end = min(start + page_rows, page.count)
            chunk = Page(
                [c.__class__(c.type, c.values[start:end],
                             None if c.validity is None else c.validity[start:end],
                             c.dictionary)
                 for c in page.columns],
                end - start,
                page.names,
            )
            next_uri = q.uri(token + 1) if end < page.count else None
            return protocol.query_results(
                q.query_id, "FINISHED", chunk, q.types, next_uri,
                stats={
                    "elapsedTimeMillis": int(
                        ((q.finished or time.time()) - q.created) * 1000
                    ),
                    "processedRows": page.count,
                },
            )


class _Handler(BaseHTTPRequestHandler):
    coordinator: Coordinator = None  # set by serve()

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, code: int, doc: dict,
              headers: Optional[dict] = None):
        body = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _authenticate(self) -> Optional[str]:
        """Returns the authenticated/declared user, or None after sending a
        401 (PasswordAuthenticator + X-Trino-User header handling)."""
        user = self.headers.get("X-Trino-User") or "user"
        auth = self.coordinator.authenticator
        if auth is None:
            return user
        import base64

        header = self.headers.get("Authorization", "")
        if header.startswith("Basic ") and hasattr(auth, "authenticate"):
            try:
                decoded = base64.b64decode(header[6:]).decode()
                u, _, pw = decoded.partition(":")
                auth.authenticate(u, pw)
                return u
            except Exception:
                pass
        if header.startswith("Bearer ") and hasattr(
            auth, "authenticate_token"
        ):
            try:
                return auth.authenticate_token(header[7:]).user
            except Exception:
                pass
        scheme = (
            "Bearer" if hasattr(auth, "authenticate_token") else "Basic"
        )
        self.send_response(401)
        self.send_header(
            "WWW-Authenticate", f'{scheme} realm="trino-tpu"'
        )
        self.send_header("Content-Length", "0")
        self.end_headers()
        return None

    def do_POST(self):
        if self.path == "/v1/statement":
            user = self._authenticate()
            if user is None:
                return
            n = int(self.headers.get("Content-Length", 0))
            sql = self.rfile.read(n).decode()
            source = self.headers.get("X-Trino-Source", "")
            q = self.coordinator.submit(sql, user, source)
            self._json(200, self.coordinator.results_doc(q, 0))
        elif self.path == "/v1/announcement":
            n = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(n))
            if self.coordinator.node_manager is not None:
                self.coordinator.node_manager.announce(
                    doc["nodeId"], doc["uri"], memory=doc.get("memory"),
                    device=doc.get("device"), state=doc.get("state"),
                    topology=doc.get("topology"),
                )
                if doc.get("topology"):
                    # host-sized units register their mesh slice in the
                    # coordinator's cluster topology (distributed/)
                    self.coordinator.cluster_topology.register(
                        doc["nodeId"], doc["uri"], doc.get("topology")
                    )
                if doc.get("memory"):
                    self.coordinator.cluster_memory.update_node(
                        doc["nodeId"], doc["memory"]
                    )
                if doc.get("opstats"):
                    # heartbeat-piggybacked per-task rollups feed the
                    # live straggler detector
                    self.coordinator.ingest_opstats(
                        doc["nodeId"], doc["opstats"]
                    )
                if doc.get("compiles"):
                    # compile-observatory piggyback: worker per-cause
                    # counts, census sketches, and ledger events merge
                    # into the coordinator's engine-wide observatory
                    self.coordinator.ingest_compiles(
                        doc["nodeId"], doc["compiles"]
                    )
            self._json(202, {})
        else:
            self._json(404, {"error": "not found"})

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        co = self.coordinator
        # Query texts/errors/results are sensitive: the monitor UI, the
        # query inspection endpoints, and result fetches all require
        # authentication whenever an authenticator is configured, like
        # POST /v1/statement (the slug stays as a second factor).
        if (len(parts) >= 2 and parts[:2] == ["v1", "query"]) or (
            len(parts) >= 3 and parts[:3] == ["v1", "statement", "executing"]
        ):
            if self._authenticate() is None:
                return
        if self.path in ("/", "/ui", "/ui/"):
            # the page itself is constant HTML (data endpoints are gated
            # above); challenge only under Basic auth, where the 401 pops
            # the browser's credential dialog and so makes the page's
            # same-origin fetches work — a Bearer-only 401 would just
            # brick the monitor (browsers can't supply a token)
            auth = co.authenticator
            if (
                auth is not None
                and hasattr(auth, "authenticate")
                and self._authenticate() is None
            ):
                return
            # query monitor (webapp/ React UI analog, single static page)
            from .webui import UI_HTML

            body = UI_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/metrics":
            body = REGISTRY.render_prometheus().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/v1/info":
            self._json(200, {
                "nodeId": co.node_id,
                "nodeVersion": {"version": "trino-tpu 0.1"},
                "environment": co.session.device.type,
                "coordinator": True,
                # the coordinator's in-process executor dispatches through
                # the session supervisor; report its device health too
                "device": co.session.device_supervisor.snapshot(),
                "uptime": f"{time.time() - co.started:.0f}s",
            })
            return
        if self.path == "/v1/status":
            nm = co.node_manager
            self._json(200, {
                "nodeId": co.node_id,
                "activeQueries": sum(
                    1 for q in co.queries.values()
                    if q.state in ("QUEUED", "PLANNING", "RUNNING")
                ),
                "totalQueries": len(co.queries),
                # the /ui header reads these (coordinator itself counts
                # as the one executing node when no workers announced)
                "activeWorkers": len(nm.alive()) if nm is not None else 1,
                "uptimeSeconds": time.time() - co.started,
                # restart-recovery outcome (0/0 when no WAL configured)
                "recoveredQueries": co.recovered_queries,
                "orphanedQueries": co.orphaned_queries,
            })
            return
        if self.path == "/v1/memory":
            # cluster memory view (server/MemoryResource analog): pool
            # snapshots per node, per-query totals, killer verdicts
            doc = co.cluster_memory.info()
            doc["localManager"] = co.session.memory_manager.snapshot()
            doc["admission"] = co.admission.stats()
            self._json(200, doc)
            return
        if self.path == "/v1/resourceGroupState":
            self._json(200, co.resource_groups.info())
            return
        if self.path == "/v1/compiles":
            # the engine-wide compile observatory: ledger tail, per-
            # cause totals (local + ingested worker piggybacks), and
            # the shape census (HTTP face of system.runtime.compiles /
            # system.runtime.shape_census)
            from ..obs import compile_observatory as _co

            obs = _co.get_observatory()
            self._json(200, {
                "summary": obs.rollup(),
                "compiles": obs.tail(256),
                "census": obs.merged_census().snapshot(),
            })
            return
        if self.path == "/v1/signatures":
            # the signature census (HTTP face of
            # system.runtime.plan_signatures), busiest shapes first,
            # each annotated with its warmest node
            from ..obs import serving_observatory as _so

            obs = _so.get_observatory()
            self._json(200, {
                "signatures": obs.signature_rows(),
                "top": obs.top_signatures(10, local_node_id=co.node_id),
            })
            return
        if self.path == "/v1/affinity":
            # per-node warmth per signature (HTTP face of
            # system.runtime.signature_affinity) — the locality-aware
            # dispatcher's input table
            from ..obs import serving_observatory as _so

            self._json(200, {
                "affinity": _so.get_observatory().affinity_rows(
                    local_node_id=co.node_id
                ),
            })
            return
        if self.path == "/v1/slo":
            # per-tenant objectives + live multi-window burn rates
            # (HTTP face of system.runtime.slos)
            from ..obs import serving_observatory as _so

            self._json(200, {
                "slos": _so.get_observatory().slo_rows(),
            })
            return
        if self.path == "/v1/cache":
            # per-tier cache stats (the HTTP face of system.runtime.caches)
            mgr = getattr(co.session, "caches", None)
            self._json(200, {
                "caches": mgr.snapshot() if mgr is not None else [],
            })
            return
        if (
            len(parts) == 4
            and parts[:2] == ["v1", "query"]
            and parts[3] == "profile"
        ):
            q = co.queries.get(parts[2])
            if q is None:
                self._json(404, {"error": "query not found"})
                return
            self._json(200, co.query_profile(q))
            return
        if (
            len(parts) == 4
            and parts[:2] == ["v1", "query"]
            and parts[3] == "events"
        ):
            # journal events correlated with this query (tagged + ambient
            # within its wall-clock window)
            q = co.queries.get(parts[2])
            if q is None:
                self._json(404, {"error": "query not found"})
                return
            from ..obs import doctor

            events = doctor.events_for_query(
                q.query_id,
                window=(q.created, q.finished or time.time()),
            )
            self._json(200, {"queryId": q.query_id, "events": events})
            return
        if (
            len(parts) == 4
            and parts[:2] == ["v1", "query"]
            and parts[3] == "diagnosis"
        ):
            q = co.queries.get(parts[2])
            if q is None:
                self._json(404, {"error": "query not found"})
                return
            self._json(200, {
                "queryId": q.query_id,
                "diagnosis": q.diagnosis,
            })
            return
        if len(parts) == 3 and parts[:2] == ["v1", "query"]:
            q = co.queries.get(parts[2])
            if q is None:
                self._json(404, {"error": "query not found"})
                return
            with q.lock:
                self._json(200, {
                    "queryId": q.query_id,
                    "state": q.state,
                    "query": q.sql,
                    "user": q.user,
                    "error": q.error,
                    "elapsedMillis": int(
                        ((q.finished or time.time()) - q.created) * 1000
                    ),
                    "outputRows": q.page.count if q.page else None,
                    # whole-query re-dispatches under retry_policy=query
                    "retryCount": q.retry_count,
                    # per-task rollup (OperatorStats->TaskStats->QueryStats
                    # hierarchy analog): totals + the per-task detail
                    "stats": {
                        "scanBytes": sum(
                            t.get("scanBytes", 0)
                            for t in getattr(q, "task_stats", [])
                        ),
                        "dynamicFilterRowsPruned": sum(
                            t.get("dynamicFilterRowsPruned", 0)
                            for t in getattr(q, "task_stats", [])
                        ),
                        "tasks": getattr(q, "task_stats", []),
                    },
                    # merged per-operator timeline (stage -> task -> op)
                    # with dispersion-detector straggler verdicts
                    "timeline": getattr(q, "timeline", None),
                    "stragglers": getattr(q, "straggler_flags", []),
                })
            return
        if self.path == "/v1/query":
            self._json(200, [
                {
                    "queryId": q.query_id,
                    "state": q.state,
                    "query": q.sql[:200],
                    "error": q.error,
                }
                for q in co.queries.values()
            ])
            return
        if (
            len(parts) == 6
            and parts[:3] == ["v1", "statement", "executing"]
        ):
            _, _, _, qid, slug, token = parts
            q = co.queries.get(qid)
            if q is None and co.in_recovery_window():
                # restart transparency: this id may still be sitting in
                # the WAL scan — tell the client to wait, not to die
                self._json(
                    503,
                    {"error": "coordinator recovering; retry shortly",
                     "retryable": True},
                    headers={"Retry-After": "1"},
                )
                return
            if q is None or q.slug != slug:
                self._json(404, {"error": "query not found"})
                return
            # long-poll: wait briefly for progress (StatementClient advance)
            deadline = time.time() + 1.0
            while time.time() < deadline and q.state in (
                "QUEUED", "PLANNING", "RUNNING",
            ):
                time.sleep(0.02)
            self._json(200, co.results_doc(q, int(token)))
            return
        self._json(404, {"error": "not found"})

    def do_DELETE(self):
        parts = self.path.strip("/").split("/")
        if len(parts) >= 4 and parts[:3] == ["v1", "statement", "executing"]:
            if self._authenticate() is None:
                return
            # the cancel URI is the nextUri path (includes the slug
            # capability token); the slug is MANDATORY, like GET
            q = self.coordinator.queries.get(parts[3])
            if q is None or len(parts) < 5 or parts[4] != q.slug:
                self._json(404, {"error": "query not found"})
                return
            self.coordinator.cancel(parts[3])
            self._json(204, {})
        else:
            self._json(404, {"error": "not found"})


class CoordinatorServer:
    """In-process server handle (TestingTrinoServer analog)."""

    def __init__(self, session: Session, port: int = 0,
                 distributed: bool = False,
                 resource_groups: Optional[dict] = None,
                 authenticator=None,
                 fault_injection: Optional[dict] = None,
                 device=None):
        # the coordinator runs where its session runs: CUDA unless the
        # caller asks for "cpu" (and then the session must be there too)
        want = D.resolve(device)
        if want.type != session.device.type:
            raise ValueError(
                f"CoordinatorServer on {want} needs a session on that "
                f"device; the session is on {session.device}"
            )
        self.coordinator = Coordinator(
            session, distributed=distributed,
            resource_groups=resource_groups, authenticator=authenticator,
            fault_injection=fault_injection,
        )
        handler = type("Handler", (_Handler,), {"coordinator": self.coordinator})
        # serving posture: the stdlib default listen backlog of 5 resets
        # connections the moment a few dozen sessions POST at once
        server_cls = type(
            "CoordinatorHTTPServer", (ThreadingHTTPServer,),
            {"request_queue_size": 128},
        )
        self.httpd = server_cls(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self) -> "CoordinatorServer":
        self.thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.coordinator._stop_enforcement.set()
        if self.coordinator.failure_detector is not None:
            self.coordinator.failure_detector.stop()

    @property
    def uri(self) -> str:
        return f"http://127.0.0.1:{self.port}"
