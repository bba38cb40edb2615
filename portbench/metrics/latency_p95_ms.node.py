"""Client (the node's one session): the 95th percentile of every
answered query's latency in the window.  A per-layer metric of the
node's cells: a window holds about twenty queries, so only one lies
beyond it (PERF.md)."""

from portbench.core.stats import percentile


def read(record):
    return percentile([r["latency_ms"] for r in record["requests"] if r["ok"]], 95)
