"""Filesystem exchange spool for fault-tolerant execution.

Counterpart of trino_tpu/exchange/filesystem.py (copied).  The spool
files hold the TPG2 frames of serde.serialize_page, so a spool directory
written by either package reads in the other.

Reference parity: spi/exchange/ExchangeManager.java implemented by
plugin/trino-exchange-filesystem (FileSystemExchangeManager) — stage outputs
are spooled to durable shared storage so failed tasks can be retried without
re-running their upstreams, and duplicate attempt output is excluded by
construction: spool paths are addressed by (query, stage, task, attempt) and
only the attempt the scheduler committed is ever handed to consumers (the
role of DeduplicatingDirectExchangeBuffer.java:87 / ExchangeSourceOutputSelector).

Layout: {base}/{query_id}/{fragment_id}/{task_index}.{attempt}/
          buffer_{id}.bin   — length-prefixed page frames
          _COMMIT           — marker written after all buffers are complete
"""
from __future__ import annotations

import os
import shutil
import struct
import tempfile
import time
from typing import Dict, List, Optional

from ..page import Page
from ..serde import PageIntegrityError, deserialize_page
from ..utils.metrics import REGISTRY


class SpoolCorruptionError(RuntimeError):
    """A committed spool buffer failed frame-length or CRC validation.

    Carries the offending file path so the FTE scheduler can retire
    exactly the corrupt attempt (decommit + producer re-run) instead of
    failing the query — the trino-exchange-filesystem analog of treating
    a bad spooled page as a task failure, not a query failure.  The
    quoted-path message format is part of the contract: it survives the
    worker's FAILED task error string back to the scheduler."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"spool corruption at '{path}': {detail}")
        self.path = path
        self.detail = detail


class SpoolHandle:
    """One task attempt's spool directory (ExchangeSinkInstanceHandle)."""

    def __init__(self, path: str):
        self.path = path

    def write_buffers(self, buffers: Dict[int, List[bytes]]):
        os.makedirs(self.path, exist_ok=True)
        written = 0
        for bid, frames in buffers.items():
            tmp = os.path.join(self.path, f".buffer_{bid}.tmp")
            with open(tmp, "wb") as f:
                f.write(struct.pack("<I", len(frames)))
                for fr in frames:
                    f.write(struct.pack("<I", len(fr)))
                    f.write(fr)
                    written += len(fr)
            os.replace(tmp, os.path.join(self.path, f"buffer_{bid}.bin"))
        REGISTRY.counter(
            "trino_tpu_spool_write_bytes", "Page-frame bytes spooled to durable storage"
        ).inc(written)
        # commit marker makes the attempt visible to the scheduler
        with open(os.path.join(self.path, "_COMMIT"), "wb"):
            pass

    @property
    def committed(self) -> bool:
        return os.path.exists(os.path.join(self.path, "_COMMIT"))

    def decommit(self):
        """Retire this attempt: drop the commit marker first (so a
        concurrent reader can't see a half-deleted attempt as committed),
        then the data.  Used by the FTE scheduler when a committed
        attempt turns out to be corrupt."""
        try:
            os.remove(os.path.join(self.path, "_COMMIT"))
        except FileNotFoundError:
            pass
        shutil.rmtree(self.path, ignore_errors=True)

    def buffer_file(self, buffer_id: int) -> str:
        return os.path.join(self.path, f"buffer_{buffer_id}.bin")


def read_spool_pages(path: str, stats: Optional[dict] = None) -> List[Page]:
    """Read one committed buffer file back into pages, validating frame
    lengths and per-frame CRCs; any structural damage raises
    SpoolCorruptionError (a *retriable* fault to the FTE scheduler).
    ``stats`` accumulates the frame bytes read ("bytes") and the seconds
    spent decoding them ("deserializeS"), as the exchange's HTTP fetch
    does."""
    crc_failures = REGISTRY.counter(
        "trino_tpu_spool_crc_failure_total",
        "Spool reads rejected by frame-length or CRC validation",
    )
    with open(path, "rb") as f:
        data = f.read()
    REGISTRY.counter(
        "trino_tpu_spool_read_bytes", "Page-frame bytes read back from spool"
    ).inc(len(data))
    if len(data) < 4:
        crc_failures.inc()
        raise SpoolCorruptionError(path, f"file truncated ({len(data)}B)")
    # frames are decoded from views of the file's bytes, not copies
    mv = memoryview(data)
    (n,) = struct.unpack_from("<I", mv, 0)
    off = 4
    pages = []
    for i in range(n):
        if off + 4 > len(data):
            crc_failures.inc()
            raise SpoolCorruptionError(
                path, f"truncated at frame {i}/{n} (offset {off})"
            )
        (ln,) = struct.unpack_from("<I", mv, off)
        off += 4
        if off + ln > len(data):
            crc_failures.inc()
            raise SpoolCorruptionError(
                path,
                f"frame {i}/{n} length {ln} overruns file "
                f"({len(data) - off} bytes left)",
            )
        try:
            t_de = time.perf_counter()
            pages.append(deserialize_page(mv[off : off + ln]))
            if stats is not None:
                stats["bytes"] += ln
                stats["deserializeS"] += time.perf_counter() - t_de
        except PageIntegrityError as e:
            crc_failures.inc()
            raise SpoolCorruptionError(path, str(e)) from e
        off += ln
    return pages


class FileSystemExchangeManager:
    """Creates per-(query, fragment, task, attempt) spool handles."""

    def __init__(self, base_dir: Optional[str] = None):
        self.base = base_dir or os.path.join(
            tempfile.gettempdir(), "trino_tpu_exchange"
        )

    def sink(
        self, query_id: str, fragment_id: int, task_index: int, attempt: int
    ) -> SpoolHandle:
        return SpoolHandle(
            os.path.join(
                self.base, query_id, str(fragment_id),
                f"{task_index}.{attempt}",
            )
        )

    def cleanup_query(self, query_id: str):
        shutil.rmtree(os.path.join(self.base, query_id), ignore_errors=True)
