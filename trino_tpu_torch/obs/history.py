"""Crash-safe persisted query history store.

Counterpart of trino_tpu/obs/history.py, copied (pure Python): the same
record fields (``HISTORY_FIELDS``), file names and JSONL encoding, so a
history directory either package wrote is read by the other's
``read_history_dir`` and re-opened by its store.

Every query's lifecycle (RUNNING -> FINISHED/FAILED, final stats and the
operator timeline) is appended as one JSONL record to two preallocated
mmap'd segment files: the torn-tail-tolerant reader shape of the flight
recorder (``obs/flight_recorder.py``), so a ``kill -9`` loses at most
the record being written.  Unlike the flight recorder, segments are NOT
reset on open: surviving records are re-read, so completed-query history
outlives a restart and stays SQL-queryable via
``system.runtime.completed_queries``.

The store is bounded by *bytes*, not record count: the two segments
alternate at half the byte budget each, and the in-memory mirror evicts
the oldest queries past the same budget.  Sessions without a
``query_history_dir`` share one process-global memory-only store, so
``system.runtime.queries`` sees queries from all sessions either way.
"""
from __future__ import annotations

import glob
import json
import mmap
import os
import threading
import time
from typing import Dict, List, Optional

# wire-document field names (lowerCamelCase, one naming regime with
# metrics, spans and flight-recorder records)
HISTORY_FIELDS = (
    "queryId",
    "state",
    "sql",
    "user",
    "created",
    "finished",
    "rows",
    "wallS",
    "error",
    "errorCode",
    "tenant",
    "planSignature",
    "operators",
    "ts",
)

DEFAULT_MAX_BYTES = 1 << 20  # two 512 KiB segments

# one history record never exceeds this; an oversized operator timeline
# is dropped from the record rather than wedging the segment
MAX_RECORD_BYTES = 16384

MIN_SEGMENT_BYTES = 1 << 16

_FILE_PREFIX = "qh-"


class _Segment:
    """One preallocated mmap'd JSONL file; re-opens append at the end of
    the surviving records instead of zeroing them (restart survival)."""

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
        self.last_ts = 0.0

    def load(self) -> List[Dict]:
        """Parse surviving records and position the append offset after
        the last intact line (a torn trailing line is overwritten)."""
        out: List[Dict] = []
        data = self.mm[: self.size]
        pos = 0
        for line in data.split(b"\n"):
            raw = line.strip(b"\0").strip()
            if raw:
                try:
                    rec = json.loads(raw)
                except ValueError:
                    break  # torn write: stop; append resumes here
                if isinstance(rec, dict) and "queryId" in rec:
                    out.append(rec)
                    self.records += 1
                    self.last_ts = max(
                        self.last_ts, float(rec.get("ts") or 0.0)
                    )
                    pos += len(line) + 1
                    continue
            break
        self.offset = pos
        return out

    def reset(self):
        self.mm[: self.size] = b"\0" * self.size
        self.offset = 0
        self.records = 0
        self.last_ts = 0.0

    def append(self, data: bytes) -> bool:
        if self.offset + len(data) > self.size:
            return False
        self.mm[self.offset : self.offset + len(data)] = data
        self.offset += len(data)
        self.records += 1
        return True

    def close(self):
        try:
            self.mm.close()
        except Exception:  # noqa: BLE001
            pass


class QueryHistoryStore:
    """Byte-bounded, crash-safe query history (latest record per query).

    ``directory=None`` keeps history memory-only; with a directory the
    last ``max_bytes`` of records survive process death and are merged
    back on the next open (including records other processes left in the
    same directory)."""

    def __init__(
        self,
        directory: Optional[str] = None,
        max_bytes: int = DEFAULT_MAX_BYTES,
        name: str = "qh",
    ):
        self.directory = directory or None
        self.max_bytes = max(int(max_bytes), 2 * MIN_SEGMENT_BYTES)
        self.name = name
        self._lock = threading.Lock()
        # queryId -> latest record, insertion-ordered for byte eviction
        self._entries: Dict[str, Dict] = {}
        self._bytes = 0
        self._segments: List[_Segment] = []
        self._active = 0
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
            seg_bytes = max(MIN_SEGMENT_BYTES, self.max_bytes // 2)
            own = set()
            for i in range(2):
                path = os.path.join(
                    self.directory, f"{_FILE_PREFIX}{self.name}-{i}.jsonl"
                )
                own.add(os.path.abspath(path))
                self._segments.append(_Segment(path, seg_bytes))
            # survivors from OTHER writers (old pids, sibling sessions)
            # merge into the mirror but are never appended to
            for rec in read_history_dir(self.directory, exclude=own):
                self._absorb(rec)
            for seg in self._segments:
                for rec in seg.load():
                    self._absorb(rec)
            self._active = max(
                range(2), key=lambda i: self._segments[i].last_ts
            )

    # -- record plumbing ------------------------------------------------
    def _absorb(self, rec: Dict):
        qid = str(rec.get("queryId") or "")
        if not qid:
            return
        prev = self._entries.pop(qid, None)
        if prev is not None:
            self._bytes -= prev.get("_approxBytes", 0)
        rec["_approxBytes"] = len(
            json.dumps(rec, separators=(",", ":"), default=str)
        )
        self._entries[qid] = rec
        self._bytes += rec["_approxBytes"]
        while self._bytes > self.max_bytes and len(self._entries) > 1:
            oldest_qid = next(iter(self._entries))
            old = self._entries.pop(oldest_qid)
            self._bytes -= old.get("_approxBytes", 0)

    def put(self, entry: Dict):
        """Record (or update) one query's history entry.  ``entry`` uses
        the legacy session keys (query_id/sql/state/...); the persisted
        record is the lowerCamelCase wire shape."""
        rec = {
            "queryId": str(entry.get("query_id") or entry.get("queryId")),
            "state": entry.get("state", ""),
            "sql": str(entry.get("sql", ""))[:2000],
            "user": entry.get("user") or "user",
            "created": float(entry.get("created") or 0.0),
            "finished": entry.get("finished"),
            "rows": int(entry.get("rows") or 0),
            "wallS": float(entry.get("wall_s") or entry.get("wallS") or 0.0),
            "error": entry.get("error"),
            "errorCode": (
                entry.get("error_code") or entry.get("errorCode") or ""
            ),
            # kept for the serving observatory's census (the server slice)
            "tenant": str(entry.get("tenant") or ""),
            "planSignature": str(
                entry.get("plan_signature")
                or entry.get("planSignature")
                or ""
            ),
            "operators": entry.get("operators"),
            "ts": time.time(),
        }
        with self._lock:
            self._absorb(dict(rec))
            if not self._segments:
                return
            data = _encode(rec)
            if data is None:
                return
            seg = self._segments[self._active]
            if not seg.append(data):
                self._active = 1 - self._active
                seg = self._segments[self._active]
                seg.reset()
                seg.append(data)

    def entries(self) -> List[Dict]:
        """Latest record per query, oldest created first."""
        with self._lock:
            recs = [
                {k: v for k, v in r.items() if k != "_approxBytes"}
                for r in self._entries.values()
            ]
        recs.sort(key=lambda r: (r.get("created") or 0.0, r.get("queryId")))
        return recs

    def completed(self) -> List[Dict]:
        return [
            r for r in self.entries()
            if r.get("state") in ("FINISHED", "FAILED")
        ]

    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def close(self):
        with self._lock:
            for seg in self._segments:
                seg.close()
            self._segments = []


def _encode(rec: Dict) -> Optional[bytes]:
    data = json.dumps(rec, separators=(",", ":"), default=str).encode()
    data += b"\n"
    if len(data) > MAX_RECORD_BYTES:
        rec = dict(rec, operators=None, sql=str(rec.get("sql", ""))[:200])
        data = json.dumps(rec, separators=(",", ":"), default=str).encode()
        data += b"\n"
        if len(data) > MAX_RECORD_BYTES:
            return None  # pathological; drop rather than corrupt
    return data


def read_history_dir(
    directory: str, exclude: Optional[set] = None
) -> List[Dict]:
    """Offline reader: every surviving record in ``directory`` ordered by
    ts.  Torn trailing lines and zeroed tail space are skipped, never an
    error — the ``kill -9`` contract shared with the flight recorder."""
    records: List[Dict] = []
    for path in sorted(
        glob.glob(os.path.join(directory, _FILE_PREFIX + "*.jsonl"))
    ):
        if exclude and os.path.abspath(path) in exclude:
            continue
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
                continue  # torn write
            if isinstance(rec, dict) and "queryId" in rec:
                records.append(rec)
    records.sort(key=lambda r: (r.get("ts") or 0.0, r.get("queryId", "")))
    return records


# -- shared store registry ----------------------------------------------
# one store per history directory (sessions sharing a dir share the
# store), plus one process-global memory-only store for sessions that
# set no query_history_dir — that is what makes system.runtime.queries
# show queries from ALL sessions instead of the caller's own list.
_STORES_LOCK = threading.Lock()
_STORES: Dict[str, QueryHistoryStore] = {}


def get_store(
    directory: Optional[str] = None,
    max_bytes: int = DEFAULT_MAX_BYTES,
) -> QueryHistoryStore:
    key = os.path.abspath(directory) if directory else ""
    with _STORES_LOCK:
        store = _STORES.get(key)
        if store is None:
            store = QueryHistoryStore(
                directory=directory or None, max_bytes=max_bytes
            )
            _STORES[key] = store
        return store


def _reset_stores():
    """Test hook: drop cached stores (e.g. between tmpdir reuses)."""
    with _STORES_LOCK:
        for s in _STORES.values():
            s.close()
        _STORES.clear()
