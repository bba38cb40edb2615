"""Per-operator execution timeline: OperatorStats frames and rollups.

Counterpart of trino_tpu/obs/opstats.py, the single-node part.
Reference parity: operator/OperatorStats.java + execution/QueryStats.java:
every operator reports input/output rows and bytes, its wall time split
into device and host, and blocked time (memory / exchange).  The
executor's per-node stats (collect_node_stats: `operator_stats = true`
or EXPLAIN ANALYZE) become frames in EXPLAIN's print order, surfaced in
EXPLAIN ANALYZE's "Operator timeline" and `Session.last_timeline`.  The
stage merge across tasks and the straggler detector wait for the
distributed slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional

# wire-document field names (lowerCamelCase, like the TaskInfo stats
# dict)
OPERATOR_FIELDS = (
    "operatorId",
    "planNodeId",
    "operatorType",
    "inputRows",
    "inputBytes",
    "outputRows",
    "outputBytes",
    "wallS",
    "deviceWallS",
    "hostWallS",
    "blockedMemoryS",
    "blockedExchangeS",
    "estimatedRows",
    "calls",
)

def frames_from_plan(
    plan,
    node_stats: Dict[int, dict],
    costs: Optional[dict] = None,
    blocked_memory_s: float = 0.0,
    blocked_exchange_s: float = 0.0,
) -> List[dict]:
    """Convert an executor's ``node_stats`` (id(node) -> raw dict) into
    serializable OperatorStats frames in plan-walk (EXPLAIN print) order.

    Walls in ``node_stats`` are *inclusive* of children (the _TraceCtx
    brackets the whole visit); frames carry the *exclusive* own-wall so
    that summing frame walls reconciles against the query wall instead of
    multiply counting nested subtrees.
    """
    frames: List[dict] = []
    order: List = []

    def walk(n):
        order.append(n)
        for s in n.sources:
            walk(s)

    walk(plan)
    for i, node in enumerate(order):
        st = node_stats.get(id(node))
        if st is None:
            continue
        child_sts = [
            node_stats[id(s)] for s in node.sources
            if id(s) in node_stats
        ]
        own = max(
            st.get("wall_s", 0.0)
            - sum(c.get("wall_s", 0.0) for c in child_sts),
            0.0,
        )
        own_dev = max(
            st.get("device_wall_s", 0.0)
            - sum(c.get("device_wall_s", 0.0) for c in child_sts),
            0.0,
        )
        frame = {
            "operatorId": i,
            "planNodeId": str(i),
            "operatorType": type(node).__name__,
            "inputRows": sum(int(c.get("rows", 0)) for c in child_sts),
            "inputBytes": sum(int(c.get("bytes", 0)) for c in child_sts),
            "outputRows": int(st.get("rows", 0)),
            "outputBytes": int(st.get("bytes", 0)),
            "wallS": own,
            "deviceWallS": own_dev,
            "hostWallS": max(own - own_dev, 0.0),
            "blockedMemoryS": float(st.get("blocked_memory_s", 0.0)),
            "blockedExchangeS": float(st.get("blocked_exchange_s", 0.0)),
            "estimatedRows": None,
            "calls": int(st.get("calls", 0)),
        }
        if costs is not None and id(node) in costs:
            frame["estimatedRows"] = float(costs[id(node)].get("rows", 0.0))
        frames.append(frame)
    # executor-level blocked walls happen before/around the operator walk:
    # memory reservation blocks on behalf of the scan working set, the
    # exchange wait on behalf of the RemoteSource reads
    if frames:
        if blocked_memory_s:
            target = next(
                (f for f in frames if f["operatorType"] == "TableScan"),
                frames[0],
            )
            target["blockedMemoryS"] += float(blocked_memory_s)
        remotes = [
            f for f in frames if f["operatorType"] == "RemoteSource"
        ]
        if blocked_exchange_s:
            for f in remotes or frames[:1]:
                f["blockedExchangeS"] += (
                    float(blocked_exchange_s) / len(remotes or frames[:1])
                )
    return frames


def format_timeline(
    frames: List[dict], total_wall_s: Optional[float] = None
) -> str:
    """EXPLAIN ANALYZE text block: one line per operator frame plus the
    wall-reconciliation footer the acceptance tests parse."""
    lines = ["Operator timeline (rows / bytes / wall / blocked):"]
    for f in frames or ():
        est = f.get("estimatedRows")
        est_s = "?" if est is None else f"{est:.0f}"
        lines.append(
            "  %-16s in=%d out=%d bytes=%d wall=%.3fms device=%.3fms "
            "blocked_mem=%.3fms blocked_exch=%.3fms est_rows=%s" % (
                f.get("operatorType", "?"),
                int(f.get("inputRows") or 0),
                int(f.get("outputRows") or 0),
                int(f.get("outputBytes") or 0),
                float(f.get("wallS") or 0.0) * 1000,
                float(f.get("deviceWallS") or 0.0) * 1000,
                float(f.get("blockedMemoryS") or 0.0) * 1000,
                float(f.get("blockedExchangeS") or 0.0) * 1000,
                est_s,
            )
        )
    op_wall = sum(float(f.get("wallS") or 0.0) for f in frames or ())
    if total_wall_s:
        pct = 100.0 * op_wall / total_wall_s if total_wall_s > 0 else 0.0
        lines.append(
            "  operator wall total %.3fs = %.1f%% of query wall %.3fs"
            % (op_wall, pct, total_wall_s)
        )
    else:
        lines.append("  operator wall total %.3fs" % op_wall)
    return "\n".join(lines)
