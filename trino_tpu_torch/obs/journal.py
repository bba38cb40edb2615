"""Engine-wide incident journal: typed, correlated, crash-safe events.

Counterpart of trino_tpu/obs/journal.py, copied: the same event types,
fields and JSONL encoding, so a journal directory either package wrote
is read by the other's ``read_journal_dir``.  The query doctor
(obs/doctor.py) joins these events into a verdict, and
``system.runtime.events`` reads the memory mirror.

Every subsystem that meets an anomaly appends a typed event here —
device faults and quarantine transitions, memory revokes
and kills, cache heals, snapshot conflicts and maintenance, fault
injections, failed queries — each carrying the query/task/node ids it
happened under.  Dean & Barroso (*The Tail at Scale*) argue the
interesting failures at scale are exactly these cross-component
interactions; this is the engine's single place where they become one
narrative.

Storage is the mmap'd torn-tail-tolerant two-segment JSONL shape of the
flight recorder (obs/flight_recorder.py): memory-only by default,
upgraded to crash-safe on-disk segments when ``event_journal_dir`` is
set.  Segment file names carry the writing pid, so a restarted process
never clobbers the segments a crashed process left behind.

Emitting is a module-level one-liner because most hook sites (fault
injector, memory pools, the lakehouse commit loop) have no session
reference:

    from ..obs import journal
    journal.emit(journal.MEMORY_KILL, query_id=qid, node_id=self.node_id,
                 reason=reason)
"""
from __future__ import annotations

import glob
import json
import mmap
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

# the one naming regime shared with metrics/spans/flight-recorder wire
# documents: lowerCamelCase
EVENT_FIELDS = (
    "eventId",
    "eventType",
    "queryId",
    "taskId",
    "nodeId",
    "severity",
    "detail",
    "ts",
)

# -- event types (the typed vocabulary the doctor's rule table keys on) --
DEVICE_FAULT = "device_fault"
DEVICE_QUARANTINE = "device_quarantine"
DEVICE_BLACKLIST = "device_blacklist"
DEVICE_RECOVERED = "device_recovered"
CPU_FALLBACK = "cpu_fallback"  # the JAX package's CPU re-run; not the port's
MEMORY_REVOKE = "memory_revoke"
MEMORY_KILL = "memory_kill"
ADMISSION_BLOCK = "admission_block"
CACHE_HEAL = "cache_heal"
SPOOL_HEAL = "spool_heal"
STRAGGLER_FLAG = "straggler_flag"
HEDGE = "hedge"
NODE_SUSPECT = "node_suspect"
NODE_GONE = "node_gone"
# multi-host: a node that announced itself as a host-sized capacity unit
# (a process owning a slice of the global device mesh) went GONE — its
# whole device slice left the cluster at once, distinct from per-node
# NODE_GONE which also fires for the same transition
HOST_GONE = "host_gone"
NODE_REJOIN = "node_rejoin"
NODE_DRAINING = "node_draining"
NODE_DRAINED = "node_drained"
MESH_SHRINK = "mesh_shrink"
FTE_REASSIGN = "fte_reassign"
FUSION_REJECT = "fusion_reject"
FORCED_STREAMING = "forced_streaming"
FAULT_INJECTED = "fault_injected"
QUERY_FAILED = "query_failed"
# compile observatory: sliding-window shape-miss retrace burst
RETRACE_STORM = "retrace_storm"
# multi-tenant serving: overload shedding and elasticity transitions
QUERY_SHED = "query_shed"
QUEUE_TIMEOUT = "queue_timeout"
SCALE_OUT = "scale_out"
SCALE_IN = "scale_in"
STARVATION_AVERTED = "starvation_averted"
# serving observatory: a tenant's fast-window SLO burn rate crossed its
# threshold (throttled: at most one event per fast window per tenant)
SLO_BURN = "slo_burn"
# coordinator crash recovery: restart scan + per-query WAL dispositions
COORDINATOR_RESTART = "coordinator_restart"
QUERY_RESUMED = "query_resumed"
QUERY_ORPHANED = "query_orphaned"
# lakehouse optimistic concurrency: a writer lost the metadata-pointer
# CAS to a concurrent commit and is re-reading + retrying
SNAPSHOT_CONFLICT = "snapshot_conflict"
# lakehouse maintenance: history pruned / unreferenced data reclaimed —
# both commit through the same metadata-pointer CAS as writers, so they
# are safe to run concurrently with appends
SNAPSHOT_EXPIRED = "snapshot_expired"
ORPHANS_REMOVED = "orphans_removed"

# severities
INFO = "info"
WARN = "warn"
ERROR = "error"

DEFAULT_MAX_BYTES = 1 << 20
# one event line never exceeds this; oversized details are truncated
MAX_RECORD_BYTES = 4096
MIN_SEGMENT_BYTES = 1 << 16
_FILE_PREFIX = "ej-"

# event ids are process-monotonic so verdicts can cite them and two
# journal reconfigurations never reuse an id
_ID_LOCK = threading.Lock()
_NEXT_ID = 0


def _new_event_id() -> int:
    global _NEXT_ID
    with _ID_LOCK:
        _NEXT_ID += 1
        return _NEXT_ID


class _Segment:
    """One preallocated mmap'd JSONL file of the on-disk journal."""

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
        self.records = 0

    def reset(self):
        self.mm[: self.size] = b"\0" * self.size
        self.offset = 0
        self.records = 0

    def append(self, data: bytes) -> bool:
        if self.offset + len(data) > self.size:
            return False
        self.mm[self.offset : self.offset + len(data)] = data
        self.offset += len(data)
        self.records += 1
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


class EventJournal:
    """Bounded incident-event ring: in-memory mirror + optional mmap'd
    on-disk segments.

    ``directory=None`` keeps the journal memory-only; a directory makes
    the most recent events survive process death.  Segment file names
    include ``name`` (default: the pid), so concurrent/successive
    processes sharing a directory never overwrite each other."""

    def __init__(
        self,
        directory: Optional[str] = None,
        max_bytes: int = DEFAULT_MAX_BYTES,
        name: Optional[str] = None,
        max_events: int = 4096,
    ):
        self.directory = str(directory or "").strip() or None
        self.max_bytes = max(int(max_bytes or DEFAULT_MAX_BYTES),
                             2 * MIN_SEGMENT_BYTES)
        self.name = name or str(os.getpid())
        self._lock = threading.Lock()
        self.mirror: deque = deque(maxlen=max_events)
        self._segments: List[_Segment] = []
        self._active = 0
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
            seg_bytes = max(MIN_SEGMENT_BYTES, self.max_bytes // 2)
            for i in range(2):
                path = os.path.join(
                    self.directory,
                    f"{_FILE_PREFIX}{self.name}-{i}.jsonl",
                )
                seg = _Segment(path, seg_bytes)
                seg.reset()  # a reused path must not replay stale events
                self._segments.append(seg)

    # -- emit ----------------------------------------------------------
    def emit(
        self,
        event_type: str,
        query_id: str = "",
        task_id: str = "",
        node_id: str = "",
        severity: str = INFO,
        **detail,
    ) -> int:
        """Append one typed event; returns its citable event id."""
        event = {
            "eventId": _new_event_id(),
            "eventType": str(event_type),
            "queryId": str(query_id or ""),
            "taskId": str(task_id or ""),
            "nodeId": str(node_id or ""),
            "severity": str(severity or INFO),
            "detail": detail or {},
            "ts": time.time(),
        }
        self.append(event)
        from ..utils.metrics import counter

        counter("trino_tpu_journal_events_total").inc(type=event["eventType"])
        return event["eventId"]

    def append(self, event: Dict):
        data = self._encode(event)
        with self._lock:
            self.mirror.append(event)
            if not self._segments:
                return
            seg = self._segments[self._active]
            if not seg.append(data):
                self._active = 1 - self._active
                seg = self._segments[self._active]
                seg.reset()
                seg.append(data)

    @staticmethod
    def _encode(event: Dict) -> bytes:
        data = json.dumps(event, separators=(",", ":"),
                          default=str).encode() + b"\n"
        if len(data) > MAX_RECORD_BYTES:
            event = dict(event, detail={"truncated": True})
            data = json.dumps(event, separators=(",", ":"),
                              default=str).encode() + b"\n"
        return data

    # -- read ----------------------------------------------------------
    def tail(self, n: Optional[int] = None) -> List[Dict]:
        """Most recent events from the in-memory mirror (oldest first)."""
        with self._lock:
            events = list(self.mirror)
        return events[-n:] if n else events

    # -- durability -----------------------------------------------------
    def sync(self):
        """Flush the mmap'd segments to disk (drain/shutdown path; the
        MAP_SHARED pages are already crash-safe against kill -9 — this
        additionally survives host power loss)."""
        with self._lock:
            for seg in self._segments:
                seg.sync()

    def close(self):
        with self._lock:
            for seg in self._segments:
                seg.close()
            self._segments = []


# -- the process-global journal (most emitters have no session ref) -----

_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Optional[EventJournal] = None


def get_journal() -> EventJournal:
    """The process-global journal (memory-only until configured)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = EventJournal(None)
        return _GLOBAL


def configure(directory, max_bytes=None) -> EventJournal:
    """Upgrade/re-point the global journal (``event_journal_dir``).

    Events already in the memory mirror are replayed into the fresh
    segments, so anomalies that fired before the owning session finished
    constructing are not lost to the post-mortem reader."""
    global _GLOBAL
    directory = str(directory or "").strip() or None
    try:
        max_bytes = int(max_bytes or 0) or DEFAULT_MAX_BYTES
    except (TypeError, ValueError):
        max_bytes = DEFAULT_MAX_BYTES
    with _GLOBAL_LOCK:
        cur = _GLOBAL
        if (
            cur is not None
            and cur.directory == directory
            and (directory is None or cur.max_bytes == max_bytes)
        ):
            return cur
        nxt = EventJournal(directory, max_bytes=max_bytes)
        if cur is not None:
            for event in cur.tail():
                nxt.append(event)
            cur.close()
        _GLOBAL = nxt
        return nxt


def emit(
    event_type: str,
    query_id: str = "",
    task_id: str = "",
    node_id: str = "",
    severity: str = INFO,
    **detail,
) -> int:
    """Module-level one-liner: append to the process-global journal."""
    return get_journal().emit(
        event_type,
        query_id=query_id,
        task_id=task_id,
        node_id=node_id,
        severity=severity,
        **detail,
    )


def sync():
    """Flush the global journal's segments (worker drain walk)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        j = _GLOBAL
    if j is not None:
        j.sync()


def _reset_journal():
    """Test isolation: drop the process-global journal."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
        _GLOBAL = None


# -- offline reader (kill -9 post-mortems) -------------------------------


def read_journal_dir(directory: str) -> List[Dict]:
    """Parse every journal segment in ``directory`` (all writer pids)
    into events ordered by (ts, eventId).  Torn trailing lines (the
    event being written when the process died) and zeroed tail space are
    skipped, never an error."""
    events: List[Dict] = []
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
                event = json.loads(line)
            except ValueError:
                continue  # torn write: the crash interrupted this line
            if isinstance(event, dict) and "eventType" in event:
                events.append(event)
    events.sort(key=lambda e: (e.get("ts", 0.0), e.get("eventId", 0)))
    return events
