"""Client (the node's one session): the median latency of every query
answered in the window, from the client's send to its last row.  A
per-layer metric of the node's cells: a window holds about twenty
queries of three templates, and the median moves with the share of
each that the window cut holds (PERF.md)."""

from portbench.core.stats import percentile


def read(record):
    return percentile([r["latency_ms"] for r in record["requests"] if r["ok"]], 50)
