"""Black-box flight recorder for supervised device work.

Counterpart of trino_tpu/obs/flight_recorder.py, copied but for the
device-memory watermark, which reads PyTorch's caching allocator.

Every supervised kernel launch, operator visit and device->host sync
(runtime/supervisor.py) writes a *dispatch* record BEFORE it runs and a
*complete* (or *fault*) record after, so when a CUDA fault poisons the
process's context, or a kill ends it mid-kernel, the last N dispatches
— kernel name, input shapes/dtypes, the device bytes reserved, the
post-dispatch device-memory watermark, wall time, query/task id —
survive on disk and the unmatched tail names the culprit.  A fault of
an asynchronous launch surfaces at a later sync: the fault's
DeviceFaultError carries this ring's last records for that reason.

Crash-safety comes from ``mmap``: records are written into two
preallocated MAP_SHARED JSONL segment files, whose dirty pages belong to
the kernel page cache the moment the ``memoryview`` store completes — a
``kill -9`` loses nothing, with no per-record ``fsync`` on the dispatch
hot path.  The ring is bounded: the two segments alternate, each holding
half of ``flight_recorder_max_records``, and rotation zeroes the older
segment.

An in-memory mirror (bounded deque) is always on, even when no
``flight_recorder_dir`` is configured.
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

# the one naming regime shared with metrics and spans: record fields are
# lowerCamelCase (like the Breadcrumb wire document)
RECORD_FIELDS = (
    "recordType",
    "seq",
    "kernel",
    "mode",
    "shapes",
    "queryId",
    "taskId",
    "nodeId",
    "hbmReservedBytes",
    "hbmPeakBytes",
    "wallS",
    "faultKind",
    "error",
    "ts",
)

# a single record line never exceeds this; oversized shape maps are
# dropped rather than letting one dispatch eat the whole segment
MAX_RECORD_BYTES = 4096

# floor for a segment file: even max_records=2 gets page-aligned room
MIN_SEGMENT_BYTES = 1 << 16

_FILE_PREFIX = "fr-"

def device_memory_watermark() -> int:
    """Post-dispatch device-memory high-water mark in bytes: PyTorch's
    ``max_memory_allocated`` of the current card, 0 on the CPU.  Never
    initializes CUDA itself: recording must not bring up a context
    (a process that has not touched the card reads 0)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    try:
        # the allocator's nested statistics as they come (the flat
        # max_memory_allocated rebuilds the whole dict in Python first)
        stats = torch.cuda.memory_stats_as_nested_dict(torch.cuda.current_device())
        return int(stats["allocated_bytes"]["all"]["peak"])
    except Exception:  # noqa: BLE001 — a lost context reads no stats
        return 0


class _Segment:
    """One preallocated mmap'd JSONL file of the on-disk ring."""

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

    def close(self):
        try:
            self.mm.close()
        except Exception:  # noqa: BLE001
            pass


class FlightRecorder:
    """Bounded dispatch ring: in-memory mirror + optional mmap'd disk ring.

    ``directory=None`` keeps the ring memory-only (the default supervisor
    wiring); a directory makes the last ``max_records`` dispatches survive
    process death."""

    def __init__(
        self,
        directory: Optional[str],
        max_records: int = 512,
        name: str = "",
    ):
        self.directory = directory or None
        self.max_records = max(int(max_records), 2)
        self.name = name or str(os.getpid())
        self._lock = threading.Lock()
        self._seq = 0
        self.tail_ring: deque = deque(maxlen=self.max_records)
        self._segments: List[_Segment] = []
        self._active = 0
        self._seg_records = max(self.max_records // 2, 1)
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
            seg_bytes = max(
                MIN_SEGMENT_BYTES, self._seg_records * MAX_RECORD_BYTES // 4
            )
            for i in range(2):
                path = os.path.join(
                    self.directory, f"{_FILE_PREFIX}{self.name}-{i}.jsonl"
                )
                seg = _Segment(path, seg_bytes)
                seg.reset()  # a reused path must not replay stale records
                self._segments.append(seg)

    # -- record construction -------------------------------------------
    def _base(self, record_type: str, bc) -> Dict:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return {
            "recordType": record_type,
            "seq": seq,
            "kernel": getattr(bc, "kernel", ""),
            "mode": getattr(bc, "mode", ""),
            "shapes": dict(getattr(bc, "shapes", None) or {}),
            "queryId": getattr(bc, "query_id", ""),
            "taskId": getattr(bc, "task_id", ""),
            "nodeId": getattr(bc, "node_id", ""),
            "hbmReservedBytes": int(
                getattr(bc, "hbm_reserved_bytes", 0) or 0
            ),
            "ts": time.time(),
        }

    def record_dispatch(self, bc) -> int:
        """Pre-dispatch record; returns the seq the completion pairs with."""
        rec = self._base("dispatch", bc)
        self._emit(rec)
        return rec["seq"]

    def record_complete(self, seq: int, bc, wall_s: float,
                        hbm_peak_bytes: Optional[int] = None):
        rec = self._base("complete", bc)
        rec["seq"] = seq  # pair with the dispatch record
        rec["wallS"] = float(wall_s)
        rec["hbmPeakBytes"] = int(
            device_memory_watermark()
            if hbm_peak_bytes is None else hbm_peak_bytes
        )
        self._emit(rec)

    def record_fault(self, seq: int, bc, kind: str, error: str = ""):
        rec = self._base("fault", bc)
        rec["seq"] = seq
        rec["faultKind"] = kind
        rec["error"] = str(error)[:400]
        self._emit(rec)

    # -- ring mechanics -------------------------------------------------
    def _emit(self, rec: Dict):
        with self._lock:
            self.tail_ring.append(rec)
            if not self._segments:
                return
            data = json.dumps(rec, separators=(",", ":")).encode() + b"\n"
            if len(data) > MAX_RECORD_BYTES:
                rec = dict(rec, shapes={})
                data = (
                    json.dumps(rec, separators=(",", ":")).encode() + b"\n"
                )
                if len(data) > MAX_RECORD_BYTES:
                    return  # pathological; drop rather than corrupt
            seg = self._segments[self._active]
            if seg.records >= self._seg_records or not seg.append(data):
                self._active = 1 - self._active
                seg = self._segments[self._active]
                seg.reset()
                seg.append(data)

    def tail(self, n: Optional[int] = None) -> List[Dict]:
        """Most recent records from the in-memory mirror (oldest first)."""
        with self._lock:
            recs = list(self.tail_ring)
        return recs[-n:] if n else recs

    def sync(self):
        """Flush dirty segment pages to disk (drain/shutdown barrier).

        The MAP_SHARED pages already survive process death without this;
        sync() additionally survives host power loss."""
        with self._lock:
            for seg in self._segments:
                try:
                    seg.mm.flush()
                except Exception:  # noqa: BLE001 — closed/readonly fs
                    pass

    def close(self):
        with self._lock:
            for seg in self._segments:
                seg.close()
            self._segments = []


# -- offline readers (post-mortems and tests) ---------------------------


def read_dir(directory: str) -> List[Dict]:
    """Parse every ring segment in ``directory`` into records ordered by
    (ts, seq).  Partial trailing lines (the record being written when the
    process died) and zeroed tail space are skipped, never an error."""
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
    records.sort(key=lambda r: (r.get("ts", 0.0), r.get("seq", 0)))
    return records


def last_unmatched(records: List[Dict]) -> Optional[Dict]:
    """The culprit: the newest *dispatch* record with no paired complete/
    fault record — the kernel that was in flight when the process died.
    Falls back to the newest dispatch when every one settled."""
    settled = {
        (r.get("nodeId", ""), r.get("seq"))
        for r in records
        if r.get("recordType") in ("complete", "fault")
    }
    dispatches = [r for r in records if r.get("recordType") == "dispatch"]
    open_ = [
        r for r in dispatches
        if (r.get("nodeId", ""), r.get("seq")) not in settled
    ]
    pool = open_ or dispatches
    return pool[-1] if pool else None
