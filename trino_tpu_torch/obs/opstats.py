"""Per-operator execution timeline: OperatorStats frames and rollups.

Counterpart of trino_tpu/obs/opstats.py.
Reference parity: operator/OperatorStats.java + execution/QueryStats.java:
every operator reports input/output rows and bytes, its wall time split
into device and host, and blocked time (memory / exchange).  The
executor's per-node stats (collect_node_stats: `operator_stats = true`
or EXPLAIN ANALYZE) become frames in EXPLAIN's print order, surfaced in
EXPLAIN ANALYZE's "Operator timeline" and `Session.last_timeline`.  Task
rollups merge into stage timelines (timeline_from_tasks: the mesh's one
task a shard), and the straggler detector scores the tasks' wall
dispersion.  The server's callers (the FTE hedge, node-death fan-out
through mark_node_tasks_terminal) come with the server.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

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

# frame keys summed when merging sibling tasks' frames; estimatedRows and
# identity keys are carried, not summed
_SUMMED = (
    "inputRows",
    "inputBytes",
    "outputRows",
    "outputBytes",
    "wallS",
    "deviceWallS",
    "hostWallS",
    "blockedMemoryS",
    "blockedExchangeS",
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


def merge_frames(frame_lists: List[List[dict]]) -> List[dict]:
    """Merge sibling tasks' frames by (planNodeId, operatorType): rows,
    bytes and walls sum across tasks; estimatedRows is the whole-stage
    estimate, so it carries (max) rather than sums."""
    merged: Dict[Tuple[str, str], dict] = {}
    for frames in frame_lists:
        for f in frames or ():
            key = (str(f.get("planNodeId")), str(f.get("operatorType")))
            m = merged.get(key)
            if m is None:
                merged[key] = dict(f)
                continue
            for k in _SUMMED:
                m[k] = (m.get(k) or 0) + (f.get(k) or 0)
            est = f.get("estimatedRows")
            if est is not None:
                prev = m.get("estimatedRows")
                m["estimatedRows"] = est if prev is None else max(prev, est)
    return sorted(merged.values(), key=lambda f: int(f.get("operatorId") or 0))


def task_rollup(
    frames: List[dict],
    wall_s: float = 0.0,
    blocked_memory_s: float = 0.0,
    blocked_exchange_s: float = 0.0,
) -> dict:
    """Pipeline -> task rollup: the per-task summary (TaskInfo stats)."""
    return {
        "operators": list(frames or ()),
        "wallS": float(wall_s),
        "outputRows": int(frames[-1].get("outputRows", 0)) if frames else 0,
        "inputRows": sum(int(f.get("inputRows") or 0) for f in frames or ()),
        "blockedMemoryS": float(blocked_memory_s),
        "blockedExchangeS": float(blocked_exchange_s),
    }


def _stage_of(task_id: str) -> str:
    # task ids are {query}.{fragment}.{task_index}[.{attempt}]; query ids
    # never contain dots
    parts = str(task_id).split(".")
    return parts[1] if len(parts) >= 3 else "0"


def timeline_from_tasks(tasks: List[dict], detector=None) -> dict:
    """Per-task stats documents (each carrying an ``operatorStats``
    rollup) -> one query timeline grouped by stage, with straggler flags
    when a detector is supplied."""
    stages: Dict[str, dict] = {}
    for t in tasks or ():
        # flattened TaskInfo stats, or nested under "stats"
        stats = t.get("stats") or t
        ops = stats.get("operatorStats") or {}
        task_id = t.get("taskId", "")
        stage_id = _stage_of(task_id)
        st = stages.setdefault(
            stage_id, {"stageId": stage_id, "tasks": [], "frameLists": []})
        wall = float(ops.get("wallS") or (stats.get("wallMillis") or 0) / 1000.0)
        st["tasks"].append({
            "taskId": task_id,
            "nodeId": t.get("nodeId") or t.get("uri") or "",
            "wallS": wall,
            "outputRows": int(ops.get("outputRows") or stats.get("outputRows") or 0),
            "blockedExchangeS": float(ops.get("blockedExchangeS") or 0.0),
            "blockedMemoryS": float(ops.get("blockedMemoryS") or 0.0),
        })
        st["frameLists"].append(ops.get("operators") or [])
    out_stages = []
    all_frames: List[List[dict]] = []
    for stage_id in sorted(stages, key=lambda s: int(s) if s.isdigit() else 0):
        st = stages[stage_id]
        frames = merge_frames(st["frameLists"])
        walls = [t["wallS"] for t in st["tasks"]]
        med = _median(walls) if walls else 0.0
        entry = {
            "stageId": stage_id,
            "tasks": st["tasks"],
            "operators": frames,
            "medianWallS": med,
            "maxWallS": max(walls) if walls else 0.0,
            "dispersion": (max(walls) / med) if med > 0 else 1.0,
            "stragglers": [],
        }
        if detector is not None:
            entry["stragglers"] = detector.observe_stage(stage_id, st["tasks"])
        out_stages.append(entry)
        # plan node indexes are per fragment: stage-qualify them for the
        # query-level merge
        all_frames.append([
            dict(f, planNodeId=f"{stage_id}.{f.get('planNodeId')}") for f in frames
        ])
    return {"stages": out_stages, "operators": merge_frames(all_frames)}


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


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if s else 0.0


def _mad(xs: List[float], med: float) -> float:
    return _median([abs(x - med) for x in xs])


class StragglerDetector:
    """Scores task wall dispersion per stage and flags outliers.

    A task is a straggler when its wall sits more than ``factor`` robust
    deviations above the median of its (completed) siblings; the
    deviation unit is max(MAD, 10% of the median), so a tight sibling
    distribution flags aggressively while a naturally noisy stage does
    not.  ``min_s`` floors the elapsed wall so sub-second jitter never
    triggers a flag.
    """

    def __init__(self, factor: float = 2.0, min_s: float = 0.5):
        self.factor = float(factor)
        self.min_s = float(min_s)
        self.flags: List[dict] = []
        self._lock = threading.Lock()

    def score(self, elapsed: float, sibling_walls: List[float]) -> float:
        """Robust z-score of ``elapsed`` against completed siblings; 0.0
        when there is nothing to compare against."""
        if not sibling_walls:
            return 0.0
        med = _median(sibling_walls)
        unit = max(_mad(sibling_walls, med), 0.1 * med, 1e-3)
        return (elapsed - med) / unit

    def should_hedge(self, elapsed: float, sibling_walls: List[float]) -> bool:
        """Dispersion-aware speculation trigger of the FTE scheduler."""
        if elapsed < self.min_s or not sibling_walls:
            return False
        return self.score(elapsed, sibling_walls) > self.factor

    def record_hedge(self, stage_id, task_id: str, uri: str,
                     elapsed: float, sibling_walls: List[float]) -> dict:
        from ..utils import metrics as M
        from . import journal

        action = {
            "action": "hedge",
            "stage": str(stage_id),
            "task": str(task_id),
            "uri": str(uri),
            "elapsedS": float(elapsed),
            "medianS": _median(sibling_walls),
            "score": self.score(elapsed, sibling_walls),
        }
        with self._lock:
            self.flags.append(action)
        M.counter(
            "trino_tpu_straggler_hedge_total",
            "Dispersion-triggered FTE backup attempts launched",
        ).inc(stage=str(stage_id))
        journal.emit(
            journal.HEDGE, query_id=str(task_id).split(".", 1)[0],
            task_id=str(task_id), severity=journal.WARN, stage=str(stage_id),
            uri=str(uri), elapsedS=float(elapsed), medianS=action["medianS"],
        )
        return action

    def observe_node_gone(self, node_id: str, retired: List[str]) -> dict:
        """A node-death event in the flag stream: its retired tasks are
        not scored as stragglers."""
        from ..utils import metrics as M

        flag = {
            "action": "node_gone",
            "node": str(node_id),
            "retiredTasks": [str(t) for t in retired or ()],
        }
        with self._lock:
            self.flags.append(flag)
        M.counter(
            "trino_tpu_straggler_node_gone_total",
            "Node-death events observed by the straggler detector",
        ).inc(node=str(node_id))
        return flag

    def observe_stage(self, stage_id, tasks: List[dict]) -> List[dict]:
        """Flag stragglers among a stage's completed tasks (the timeline
        merge).  Returns the flags added."""
        from ..utils import metrics as M

        walls = [float(t.get("wallS") or 0.0) for t in tasks or ()]
        if not walls:
            return []
        med = _median(walls)
        M.gauge(
            "trino_tpu_straggler_dispersion_state",
            "max/median task wall dispersion of the last observed stage",
        ).set((max(walls) / med) if med > 0 else 1.0, stage=str(stage_id))
        flagged: List[dict] = []
        for t in tasks:
            wall = float(t.get("wallS") or 0.0)
            siblings = [float(o.get("wallS") or 0.0) for o in tasks if o is not t]
            if wall < self.min_s or not siblings:
                continue
            sc = self.score(wall, siblings)
            if sc > self.factor:
                flagged.append({
                    "action": "flag",
                    "stage": str(stage_id),
                    "task": str(t.get("taskId", "")),
                    "node": str(t.get("nodeId", "")),
                    "wallS": wall,
                    "medianS": _median(siblings),
                    "score": sc,
                })
                M.counter(
                    "trino_tpu_straggler_flagged_total",
                    "Tasks flagged as stragglers by wall dispersion",
                ).inc(stage=str(stage_id))
                M.histogram(
                    "trino_tpu_straggler_wall_seconds",
                    "Wall time of tasks flagged as stragglers",
                ).observe(wall)
        if flagged:
            from . import journal

            with self._lock:
                self.flags.extend(flagged)
            for flag in flagged:
                journal.emit(
                    journal.STRAGGLER_FLAG, query_id=flag["task"].split(".", 1)[0],
                    task_id=flag["task"], node_id=flag["node"],
                    severity=journal.WARN, stage=flag["stage"],
                    wallS=flag["wallS"], medianS=flag["medianS"], score=flag["score"],
                )
        return flagged
