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

Counterpart of trino_tpu/server/coordinator.py for the pipelined path.
The coordinator's session names its device (CUDA unless the caller
asked for "cpu"); with `distributed` the queries run on the announced
workers, each on its own device.  Left out here, with fault-tolerant
execution and recovery: retry_policy (FTE and whole-query retries), the
recovery WAL, the autoscaler and the serving observatory (its census,
affinity and SLO endpoints).  The remote tasks get the session's
`megakernels` too, so a worker fuses (or not) as the session asked.
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
        self.retry_count = 0  # whole-query re-runs (none without FTE)
        self.task_stats: list = []  # per-task stats docs (TaskInfo rollup)
        self.timeline: Optional[dict] = None  # merged operator timeline
        self.diagnosis: Optional[dict] = None  # doctor's finalize verdict
        self.straggler_flags: list = []  # dispersion-detector verdicts
        self.session_executed = False  # ran via session.execute (history
        #                                already recorded there)
        self.tenant = ""  # top-level resource group
        self.plan_signature = ""  # canonical plan digest (history key)
        self.kernel_families: tuple = ()  # per-fragment family digests
        self.result_cache_hit: Optional[bool] = None  # None = not keyed
        self.result_cache_stored = False
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
        # live straggler detector fed by announcement-piggybacked task
        # rollups (obs/opstats); one summary per task id, ever
        from ..obs.opstats import StragglerDetector

        self.straggler_detector = StragglerDetector(
            factor=float(
                session.properties.get("straggler_dispersion_factor")
                or 2.0
            ),
            min_s=0.75,
        )
        self._opstats_seen: set = set()
        self._opstats_by_stage: Dict[tuple, list] = {}
        self._opstats_lock = threading.Lock()
        if self.node_manager is not None:
            # node-death fan-out: memory-pool eviction + opstats ghost
            # retirement the moment a node is declared GONE
            self.node_manager.add_gone_listener(self._on_node_gone)
        # restart recovery belongs to fault-tolerant execution: a
        # pipelined coordinator has nothing to recover (/v1/status keeps
        # the counters at 0)
        self.recovered_queries = 0
        self.orphaned_queries = 0
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
        # paths null q.group (its history record carries it)
        q.tenant = group.tenant
        self.cluster_memory.note_query_tenant(q.query_id, group.tenant)

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
                task_props = self._task_properties()
                try:
                    # the query span parents every scheduler dispatch made
                    # on this thread (traceparent rides the task POSTs), so
                    # worker task spans join this trace
                    with TRACER.span("query", query_id=q.query_id):
                        sched = DistributedScheduler(
                            self.session.catalogs, workers, task_props,
                            memory_view=self.cluster_memory,
                            node_manager=self.node_manager,
                        )
                        page = sched.run(plan, q.query_id)
                        # per-task stats rollup (TaskStats -> QueryStats)
                        q.task_stats = getattr(sched, "last_task_stats", [])
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
            "fault_injection": props.get("fault_injection"),
            "memory_blocked_timeout_s":
                props.get("memory_blocked_timeout_s"),
            "exchange_retry_attempts":
                props.get("exchange_retry_attempts"),
            "exchange_retry_budget_s":
                props.get("exchange_retry_budget_s"),
            "statistics_enabled": props.get("statistics_enabled"),
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
        }

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
                # restart-recovery outcome (0/0: no recovery WAL)
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
                    # whole-query re-dispatches (0: no retry_policy)
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
