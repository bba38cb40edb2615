"""Device-memory bandwidth ledger: bytes touched over timed device wall.

Counterpart of trino_tpu/obs/bandwidth.py.  Each run of the plan under
the ``bandwidth_ledger`` session property (EXPLAIN ANALYZE always
collects it) is bracketed by device synchronizations in the executor,
and the ledger folds

    input bytes   (the scan and exchange lanes fed to the run)
  + output bytes  (the output lanes + selection mask)
  + intermediate  (the wide-decimal accumulator estimate,
                   ``exec/streaming.wide_agg_temp_bytes``, plus the
                   generator temporaries of the scans generated on the
                   device during the timed run)

over the measured wall into effective GB/s and a share of the card's
roofline per run.  Entries surface in EXPLAIN ANALYZE and the kernel
profile (`bandwidth`).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

# NVIDIA H100 80GB HBM3 (SXM, 700 W power limit): 3.35 TB/s of device
# memory bandwidth, the rate PERF.md's kernel bounds use.  A card held
# below its power limit runs slower under load.
DEFAULT_ROOFLINE_GBPS = 3350.0


class BandwidthLedger:
    """Accumulates per-run byte/wall observations for one executor."""

    def __init__(self, roofline_gbps: Optional[float] = None):
        self.roofline_bytes_per_s = (
            float(roofline_gbps or DEFAULT_ROOFLINE_GBPS) * 1e9
        )
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict] = {}

    def record(
        self,
        digest: str,
        mode: str,
        input_bytes: int,
        output_bytes: int,
        intermediate_bytes: int,
        wall_s: float,
    ) -> Dict:
        total = int(input_bytes) + int(output_bytes) + int(intermediate_bytes)
        with self._lock:
            e = self._entries.get(digest)
            if e is None:
                e = self._entries[digest] = {
                    "kernel": digest, "mode": mode, "executions": 0,
                    "inputBytes": 0, "outputBytes": 0, "intermediateBytes": 0,
                    "totalBytes": 0, "deviceWallS": 0.0,
                }
            e["executions"] += 1
            e["inputBytes"] += int(input_bytes)
            e["outputBytes"] += int(output_bytes)
            e["intermediateBytes"] += int(intermediate_bytes)
            e["totalBytes"] += total
            e["deviceWallS"] += float(wall_s)
        return e

    def _annotate(self, e: Dict) -> Dict:
        wall = e["deviceWallS"]
        gbps = (e["totalBytes"] / wall / 1e9) if wall > 0 else 0.0
        return dict(e, gbps=gbps,
                    rooflinePct=100.0 * gbps * 1e9 / self.roofline_bytes_per_s)

    def entries(self) -> List[Dict]:
        """Per-run rows, heaviest byte movers first."""
        with self._lock:
            entries = [dict(e) for e in self._entries.values()]
        return sorted((self._annotate(e) for e in entries),
                      key=lambda e: e["totalBytes"], reverse=True)

    def summary(self) -> Dict:
        with self._lock:
            total = sum(e["totalBytes"] for e in self._entries.values())
            wall = sum(e["deviceWallS"] for e in self._entries.values())
        gbps = (total / wall / 1e9) if wall > 0 else 0.0
        return {
            "totalBytes": total,
            "deviceWallS": wall,
            "effectiveGbps": gbps,
            "rooflinePct": 100.0 * gbps * 1e9 / self.roofline_bytes_per_s,
            "rooflineGbps": self.roofline_bytes_per_s / 1e9,
        }
