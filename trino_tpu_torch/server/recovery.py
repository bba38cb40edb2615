"""Coordinator crash recovery: durable query-state WAL + restart resume.

Counterpart of trino_tpu/server/recovery.py (copied): the same record
types, fields and segment format, and ``plan_digest`` over the plan JSON
(which both packages write alike), so a WAL directory written by either
coordinator replays in the other to the same classification.

Reference non-parity (deliberately past it): the reference keeps the
whole query state machine (DispatchManager/QueryTracker) in coordinator
memory — a coordinator crash orphans every in-flight query even though
Project Tardigrade's committed FTE spools are sitting durably on disk.
Here every query-state transition is journaled through a write-ahead
intent log BEFORE it takes effect, using the same mmap'd torn-tail-
tolerant two-segment store contract as the flight recorder and incident
journal (pid-suffixed segments, crash-safe, readable after kill -9), so
a restarted coordinator can replay the log and pick the query back up:

  - ``query_submitted``  sql, user, slug, resource group, retry policy
  - ``query_planned``    fragment-graph digest (resume sanity check)
  - ``task_dispatched``  one task attempt POSTed to a worker
  - ``task_committed``   structural fragment signature + task index +
                         the committed spool path (the resume currency)
  - ``query_finished`` / ``query_failed``  terminal states

On boot with ``coordinator_recovery_dir`` set, :class:`RecoveryManager`
scans the WAL, re-registers every non-terminal query under its original
query id AND slug (the client's nextUri keeps working), waits for the
worker set to re-announce (discovery heartbeats target the fixed
coordinator URI, so survivors re-adopt themselves), then classifies:

  - retry_policy=task (FTE): re-plan the SQL, verify the fragment-graph
    digest, and re-enter the FaultTolerantScheduler seeded with the
    committed-spool map — only UNFINISHED tasks re-run; committed
    stages are reused byte-for-byte via the structural spool signatures
    (``QUERY_RESUMED`` journaled, cited by the doctor).
  - anything else (pipelined): the stream state died with the old
    process — fail with a structured retryable ``COORDINATOR_RESTART``
    error the client re-submits, and persist the orphan through the
    same history path as any failed query (``QUERY_ORPHANED``).

The seeded chaos site ``coordinator_death`` (utils/faults.py) hard-exits
the coordinator at a chosen WAL transition, AFTER the record lands in
the mmap'd segment — the crash is deterministic and the evidence
survives, exactly like ``worker_death``.
"""
from __future__ import annotations

import glob
import json
import mmap
import os
import threading
import time
from typing import Dict, List, Optional

# wire schema of one WAL record (lowerCamelCase, one naming regime with
# metrics/spans/journal events) — linted by scripts/check_metric_names.py
WAL_FIELDS = (
    "walId",
    "recordType",
    "queryId",
    "slug",
    "sql",
    "user",
    "source",
    "resourceGroup",
    "retryPolicy",
    "planDigest",
    "fragmentSig",
    "taskIndex",
    "spoolPath",
    "taskId",
    "uri",
    "state",
    "error",
    "detail",
    "ts",
)

# -- record types (the typed vocabulary replay() keys on) ----------------
QUERY_SUBMITTED = "query_submitted"
QUERY_PLANNED = "query_planned"
TASK_DISPATCHED = "task_dispatched"
TASK_COMMITTED = "task_committed"
QUERY_FINISHED = "query_finished"
QUERY_FAILED = "query_failed"

TERMINAL_TYPES = (QUERY_FINISHED, QUERY_FAILED)

DEFAULT_MAX_BYTES = 1 << 20
MAX_RECORD_BYTES = 8192
MIN_SEGMENT_BYTES = 1 << 16
_FILE_PREFIX = "wal-"

# the structured retryable error the client's retry loop re-submits on;
# rendered by server/protocol.py with errorType EXTERNAL + retriable
COORDINATOR_RESTART_CODE = "COORDINATOR_RESTART"

# WAL writer names must be unique per (pid, instance): two coordinators
# in one test process would otherwise reset each other's segments
_NAME_LOCK = threading.Lock()
_NAME_SEQ = 0


def _next_wal_name() -> str:
    global _NAME_SEQ
    with _NAME_LOCK:
        _NAME_SEQ += 1
        return f"{os.getpid()}-{_NAME_SEQ}"


class _Segment:
    """One preallocated mmap'd JSONL file of the on-disk WAL."""

    def __init__(self, path: str, size: int):
        self.path = path
        self.size = size
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, size)
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.offset = 0

    def reset(self):
        self.mm[: self.size] = b"\0" * self.size
        self.offset = 0

    def append(self, data: bytes) -> bool:
        if self.offset + len(data) > self.size:
            return False
        self.mm[self.offset : self.offset + len(data)] = data
        self.offset += len(data)
        return True

    def sync(self):
        try:
            self.mm.flush()
        except Exception:  # noqa: BLE001 — sync is advisory
            pass

    def close(self):
        try:
            self.mm.close()
        except Exception:  # noqa: BLE001
            pass


class CoordinatorWAL:
    """The coordinator's write-ahead intent log.

    Same durability contract as the incident journal: two preallocated
    mmap'd segments that alternate at half the byte budget, named by
    writer so a restarted coordinator never clobbers the crashed one's
    records (MAP_SHARED pages survive ``os._exit``).  The optional
    ``injector`` arms the seeded ``coordinator_death`` chaos site: the
    process hard-exits AFTER the chosen record lands in the segment —
    the transition is durably on record, the state change it announced
    never happened, which is exactly the torn state recovery must heal.
    """

    def __init__(
        self,
        directory: str,
        max_bytes: int = DEFAULT_MAX_BYTES,
        name: Optional[str] = None,
        injector=None,
    ):
        self.directory = str(directory)
        self.max_bytes = max(
            int(max_bytes or DEFAULT_MAX_BYTES), 2 * MIN_SEGMENT_BYTES
        )
        self.name = name or _next_wal_name()
        self._injector = injector
        self._lock = threading.Lock()
        self._next_id = 0
        self._segments: List[_Segment] = []
        self._active = 0
        os.makedirs(self.directory, exist_ok=True)
        seg_bytes = max(MIN_SEGMENT_BYTES, self.max_bytes // 2)
        for i in range(2):
            path = os.path.join(
                self.directory, f"{_FILE_PREFIX}{self.name}-{i}.jsonl"
            )
            seg = _Segment(path, seg_bytes)
            seg.reset()  # a reused path must not replay stale intents
            self._segments.append(seg)

    # ------------------------------------------------------------------
    def record(self, record_type: str, query_id: str = "", **fields) -> int:
        """Durably journal one state transition; returns its walId.

        The seeded ``coordinator_death`` site fires AFTER the append,
        keyed ``{recordType}:{queryId}`` so a chaos rule can pick the
        exact transition (e.g. ``{"match": "task_committed", "nth": 2}``
        dies at the second committed task of the run)."""
        rec = {"walId": 0, "recordType": str(record_type),
               "queryId": str(query_id or ""), "ts": time.time()}
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        data = self._encode(rec)
        with self._lock:
            self._next_id += 1
            rec["walId"] = self._next_id
            data = self._encode(rec)
            seg = self._segments[self._active]
            if not seg.append(data):
                self._active = 1 - self._active
                seg = self._segments[self._active]
                seg.reset()
                seg.append(data)
        from ..utils.metrics import REGISTRY

        REGISTRY.counter(
            "trino_tpu_coordinator_wal_records_total",
            "Coordinator WAL state-transition records, by record type",
        ).inc(type=str(record_type))
        if self._injector is not None and self._injector.fires(
            "coordinator_death", key=f"{record_type}:{query_id}"
        ):
            # the mmap'd record (and the injector's FAULT_INJECTED
            # journal event) survive the hard exit — kill -9 semantics
            os._exit(137)
        return rec["walId"]

    @staticmethod
    def _encode(rec: Dict) -> bytes:
        data = json.dumps(
            rec, separators=(",", ":"), default=str
        ).encode() + b"\n"
        if len(data) > MAX_RECORD_BYTES:
            slim = dict(rec)
            if "sql" in slim:
                slim["sql"] = str(slim["sql"])[:2000]
            slim["detail"] = {"truncated": True}
            data = json.dumps(
                slim, separators=(",", ":"), default=str
            ).encode() + b"\n"
        return data

    def sync(self):
        with self._lock:
            for seg in self._segments:
                seg.sync()

    def close(self):
        with self._lock:
            for seg in self._segments:
                seg.close()
            self._segments = []


# -- offline reader (restart scan + post-mortem tooling) -----------------


def read_wal_dir(directory: str) -> List[Dict]:
    """Parse every WAL segment in ``directory`` (all writer names) into
    records ordered by (ts, walId).  Torn trailing lines — the record
    being written when the coordinator died — and zeroed tail space are
    skipped, never an error."""
    records: List[Dict] = []
    for path in sorted(
        glob.glob(os.path.join(directory, _FILE_PREFIX + "*.jsonl"))
    ):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            continue
        for line in data.split(b"\n"):
            line = line.strip(b"\0").strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn write: the crash interrupted this line
            if isinstance(rec, dict) and "recordType" in rec:
                records.append(rec)
    records.sort(key=lambda r: (r.get("ts", 0.0), r.get("walId", 0)))
    return records


class WalQuery:
    """One query's state reconstructed from its WAL records."""

    def __init__(self, query_id: str):
        self.query_id = query_id
        self.sql = ""
        self.user = "user"
        self.source = ""
        self.slug = ""
        self.resource_group = ""
        self.retry_policy = ""
        self.plan_digest: Optional[str] = None
        self.terminal: Optional[str] = None  # FINISHED | FAILED | None
        self.error: Optional[str] = None
        self.submitted_ts = 0.0
        self.last_ts = 0.0
        # fragmentSig -> {taskIndex: committed spool path}: the currency
        # a resumed FaultTolerantScheduler redeems via the structural
        # spool signatures — identical fragments reuse these verbatim
        self.committed: Dict[str, Dict[int, str]] = {}
        self.dispatched = 0

    @property
    def resumable(self) -> bool:
        """FTE queries resume from committed spools; pipelined queries'
        stream state died with the old coordinator process."""
        return self.terminal is None and self.retry_policy == "task"

    def committed_lists(self) -> Dict[str, List[Optional[str]]]:
        """``{fragmentSig: [task_index -> path-or-None]}`` in the shape
        FaultTolerantScheduler's ``precommitted`` seeding expects."""
        out: Dict[str, List[Optional[str]]] = {}
        for sig, by_task in self.committed.items():
            if not by_task:
                continue
            width = max(by_task) + 1
            out[sig] = [by_task.get(i) for i in range(width)]
        return out


def replay_wal(records: List[Dict]) -> Dict[str, WalQuery]:
    """Fold WAL records into per-query reconstructed state (all queries,
    terminal and not — callers filter)."""
    queries: Dict[str, WalQuery] = {}
    for rec in records:
        qid = str(rec.get("queryId") or "")
        if not qid:
            continue
        wq = queries.get(qid)
        if wq is None:
            wq = queries[qid] = WalQuery(qid)
        rtype = rec.get("recordType")
        wq.last_ts = max(wq.last_ts, float(rec.get("ts") or 0.0))
        if rtype == QUERY_SUBMITTED:
            wq.sql = str(rec.get("sql") or wq.sql)
            wq.user = str(rec.get("user") or wq.user)
            wq.source = str(rec.get("source") or wq.source)
            wq.slug = str(rec.get("slug") or wq.slug)
            wq.resource_group = str(
                rec.get("resourceGroup") or wq.resource_group
            )
            wq.retry_policy = str(rec.get("retryPolicy") or wq.retry_policy)
            wq.submitted_ts = float(rec.get("ts") or 0.0)
        elif rtype == QUERY_PLANNED:
            wq.plan_digest = rec.get("planDigest") or wq.plan_digest
        elif rtype == TASK_DISPATCHED:
            wq.dispatched += 1
        elif rtype == TASK_COMMITTED:
            sig = str(rec.get("fragmentSig") or "")
            path = rec.get("spoolPath")
            idx = rec.get("taskIndex")
            if sig and path is not None and idx is not None:
                wq.committed.setdefault(sig, {})[int(idx)] = str(path)
        elif rtype == QUERY_FINISHED:
            wq.terminal = "FINISHED"
        elif rtype == QUERY_FAILED:
            wq.terminal = "FAILED"
            wq.error = rec.get("error") or wq.error
    return queries


def plan_digest(plan) -> str:
    """Deterministic digest of the optimized plan's structure — replayed
    SQL must re-plan to the same shape before committed spools are
    trusted (a catalog/stats change between boots would silently read
    the wrong stage's bytes)."""
    import hashlib

    from ..serde import plan_to_json

    doc = json.dumps(
        plan_to_json(plan), separators=(",", ":"),
        sort_keys=True, default=str,
    )
    return hashlib.blake2b(doc.encode(), digest_size=16).hexdigest()


class RecoveryManager:
    """Restart-time recovery: scan, re-register, re-adopt, resume.

    Constructed by the coordinator when ``coordinator_recovery_dir`` is
    set.  ``register()`` runs synchronously during coordinator boot —
    every non-terminal query is back in the tracker (same query id, same
    slug) before the HTTP server answers its first poll.  ``run()``
    executes on a background thread: wait (bounded by
    ``coordinator_recovery_window_s``) for discovery re-announcements to
    rebuild the live worker set, then resume or orphan each query."""

    def __init__(self, coordinator, directory: str, window_s: float):
        self.coordinator = coordinator
        self.directory = directory
        self.window_s = float(window_s)
        self.pending: List[WalQuery] = []
        self.resumed: List[str] = []
        self.orphaned: List[str] = []
        self.done = threading.Event()
        self._started = time.time()

    # -- boot-time (synchronous) ----------------------------------------
    def register(self) -> int:
        """Scan the WAL and re-register every non-terminal query under
        its original id + slug; returns how many are pending recovery."""
        try:
            records = read_wal_dir(self.directory)
        except Exception:
            records = []
        # (our own WAL's segments were reset at construction, so the
        # scan only ever sees the crashed coordinators' records)
        for wq in replay_wal(records).values():
            if wq.terminal is not None or not wq.sql:
                continue
            self.pending.append(wq)
        self.pending.sort(key=lambda w: w.submitted_ts)
        co = self.coordinator
        for wq in self.pending:
            from .coordinator import QueryExecution

            q = QueryExecution(wq.query_id, wq.sql, wq.user)
            if wq.slug:
                q.slug = wq.slug
            q.state = "QUEUED"
            q.recovered = True
            co.queries[wq.query_id] = q
        if not self.pending:
            self.done.set()
        return len(self.pending)

    # -- background (after the server is answering polls) ---------------
    def run(self):
        from ..obs import journal
        from ..utils.metrics import REGISTRY

        co = self.coordinator
        t0 = time.time()
        try:
            if not self.pending:
                return
            journal.emit(
                journal.COORDINATOR_RESTART,
                node_id=co.node_id,
                severity=journal.WARN,
                pendingQueries=len(self.pending),
                recoveryDir=self.directory,
            )
            deadline = self._started + self.window_s
            # re-adopt the live worker set from discovery re-announcements
            # before dispatching anything — or terminalizing anything: an
            # orphan's retryable error invites an instant re-submit, which
            # must land on a serviceable cluster, not NO_NODES_AVAILABLE
            co.node_manager.await_alive(
                1, timeout=max(deadline - time.time(), 0.0)
            )
            for wq in self.pending:
                q = co.queries.get(wq.query_id)
                if q is None:
                    continue
                if wq.resumable and co.node_manager.alive():
                    try:
                        self._resume(q, wq)
                        continue
                    except Exception as e:  # fall through to orphan
                        orphan_error = (
                            f"{COORDINATOR_RESTART_CODE}: resume failed "
                            f"({type(e).__name__}: {e}); please re-submit"
                        )
                        self._orphan(q, wq, error=orphan_error)
                        continue
                self._orphan(q, wq)
        finally:
            self.done.set()
            REGISTRY.histogram(
                "trino_tpu_coordinator_recovery_wall_seconds",
                "Wall time of one restart-recovery pass "
                "(scan + re-adopt + resume/orphan)",
            ).observe(time.time() - t0)

    # ------------------------------------------------------------------
    def _resume(self, q, wq: WalQuery):
        """Re-enter the FTE scheduler seeded with the committed-spool
        map: identical fragments (structural signature match) reuse
        their spools verbatim, so only UNFINISHED tasks re-run."""
        from ..obs import journal
        from ..sql import ast
        from ..sql.parser import parse
        from ..utils.metrics import REGISTRY

        co = self.coordinator
        with q.lock:
            q.state = "PLANNING"
        stmt = parse(q.sql)
        if not isinstance(stmt, ast.Query):
            raise RuntimeError("only plain queries are resumable")
        plan = co.session._plan_stmt(stmt)
        if wq.plan_digest and plan_digest(plan) != wq.plan_digest:
            # the replayed SQL planned to a different shape (stats or
            # catalog drift between boots): committed spools cannot be
            # trusted — orphan instead of silently reading wrong bytes
            raise RuntimeError("plan digest mismatch after restart")
        precommitted = wq.committed_lists()
        with q.lock:
            q.state = "RUNNING"
        # the resumed run spools under an epoch-suffixed query id so new
        # attempt numbers can never collide with the crashed epoch's
        # dirs; committed OLD paths are absolute, so reads still work
        page = co._run_fte(
            q, plan,
            qid=f"{wq.query_id}_rec",
            precommitted=precommitted,
            wal_qid=wq.query_id,
        )
        with q.lock:
            q.page = page
            q.types = [c.type for c in page.columns]
            q.state = "FINISHED"
            q.finished = time.time()
        REGISTRY.counter(
            "trino_tpu_query_finished_total",
            "Queries that reached FINISHED",
        ).inc()
        REGISTRY.counter(
            "trino_tpu_coordinator_recovered_queries_total",
            "Queries resumed from the WAL after a coordinator restart",
        ).inc()
        co.recovered_queries += 1
        reused = sum(
            1 for paths in precommitted.values() for p in paths if p
        )
        event_id = journal.emit(
            journal.QUERY_RESUMED, query_id=wq.query_id,
            node_id=co.node_id, severity=journal.WARN,
            reusedSpools=reused, retryPolicy=wq.retry_policy,
        )
        q.resume_event_id = event_id
        try:
            co._finalize_query(q)
        except Exception:
            pass
        # the crashed epoch's spool tree is only safe to drop now that
        # the resumed run no longer reads its committed attempts
        try:
            from ..exchange.filesystem import FileSystemExchangeManager

            FileSystemExchangeManager().cleanup_query(wq.query_id)
        except Exception:
            pass

    def _orphan(self, q, wq: WalQuery, error: Optional[str] = None):
        """Terminalize a non-resumable query with the structured
        retryable COORDINATOR_RESTART error, routed through the same
        persist-with-errorCode path as any failed query — the orphan is
        visible in system.runtime.completed_queries after restart."""
        from ..obs import journal
        from ..utils.metrics import REGISTRY

        co = self.coordinator
        with q.lock:
            q.state = "FAILED"
            q.error = error or (
                f"{COORDINATOR_RESTART_CODE}: coordinator restarted "
                "mid-query; stream state was lost — please re-submit"
            )
            q.finished = time.time()
        REGISTRY.counter(
            "trino_tpu_query_failed_total", "Queries that reached FAILED"
        ).inc()
        REGISTRY.counter(
            "trino_tpu_coordinator_orphaned_queries_total",
            "Non-resumable queries orphaned by a coordinator restart",
        ).inc()
        co.orphaned_queries += 1
        event_id = journal.emit(
            journal.QUERY_ORPHANED, query_id=wq.query_id,
            node_id=co.node_id, severity=journal.ERROR,
            retryPolicy=wq.retry_policy or "none",
            dispatchedTasks=wq.dispatched,
        )
        q.orphan_event_id = event_id
        try:
            co._finalize_query(q)
        except Exception:
            pass
        try:
            from ..exchange.filesystem import FileSystemExchangeManager

            FileSystemExchangeManager().cleanup_query(wq.query_id)
        except Exception:
            pass
