"""System catalog: engine introspection as SQL tables.

Counterpart of trino_tpu/connectors/system.py: the same tables, columns
and rows, so both packages answer ``system.*`` alike.  The serving
observatory's three tables (plan_signatures, signature_affinity, slos)
wait for the server slice, where their producer lives.  Without a node
manager, cluster memory view or resource-group manager (the server's),
``nodes``, ``memory`` and ``resource_groups`` give the in-process rows
the JAX package gives a local session.

Reference parity: the system tables the engine itself serves —
system.runtime.queries / system.runtime.nodes (connector/system/ in
trino-main: QuerySystemTable, NodeSystemTable), system.metadata.catalogs,
system.jdbc.tables/columns — plus the JMX-as-SQL idea of plugin/trino-jmx
(metrics queryable through the same scan path).  Tables snapshot live
engine state at scan time; the catalog is never result-cached.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .. import types as T
from ..page import Page, column_from_pylist
from ..spi import (
    ColumnSchema,
    Connector,
    ConnectorFactory,
    ConnectorMetadata,
    PageSource,
    PageSourceProvider,
    Split,
    SplitManager,
    TableSchema,
    TableStatistics,
)

SCHEMAS: Dict[str, List] = {
    "catalogs": [("catalog_name", T.VARCHAR), ("connector_name", T.VARCHAR)],
    "tables": [("table_catalog", T.VARCHAR), ("table_name", T.VARCHAR)],
    "columns": [
        ("table_catalog", T.VARCHAR),
        ("table_name", T.VARCHAR),
        ("column_name", T.VARCHAR),
        ("data_type", T.VARCHAR),
    ],
    "queries": [
        ("query_id", T.VARCHAR),
        ("state", T.VARCHAR),
        ("query", T.VARCHAR),
        ("user", T.VARCHAR),
        ("created", T.DOUBLE),
        ("finished", T.DOUBLE),
        ("rows", T.BIGINT),
        ("error", T.VARCHAR),
    ],
    "nodes": [
        ("node_id", T.VARCHAR),
        ("http_uri", T.VARCHAR),
        # distributed: lifecycle state machine (server/discovery.py)
        # ACTIVE/SUSPECT/DRAINING/DRAINED/GONE; local session: "active"
        ("state", T.VARCHAR),
        ("state_age_s", T.DOUBLE),
        # device-fault supervisor health (runtime/supervisor.py):
        # ACTIVE/DEGRADED/QUARANTINED + strikes toward the blacklist
        ("device_state", T.VARCHAR),
        ("device_strikes", T.BIGINT),
        # multi-host topology (distributed/topology.py): which host the
        # node lives on, its process index in the global mesh, and how
        # many local devices its slice owns; NULL for plain workers
        ("host", T.VARCHAR),
        ("process_index", T.BIGINT),
        ("local_devices", T.BIGINT),
    ],
    "views": [
        ("table_catalog", T.VARCHAR),
        ("table_name", T.VARCHAR),
        ("view_definition", T.VARCHAR),
    ],
    "session_properties": [
        ("name", T.VARCHAR),
        ("value", T.VARCHAR),
        ("default", T.VARCHAR),
    ],
    # one row per cache tier (result_cache / compile_cache / scan_cache);
    # backed by the session CacheManager (cache/__init__._ROW_COLUMNS)
    "caches": [
        ("name", T.VARCHAR),
        ("hits", T.BIGINT),
        ("misses", T.BIGINT),
        ("puts", T.BIGINT),
        ("evictions", T.BIGINT),
        ("entries", T.BIGINT),
        ("bytes", T.BIGINT),
        ("max_bytes", T.BIGINT),
        ("heals", T.BIGINT),
        ("invalidations", T.BIGINT),
    ],
    # one row per committed lakehouse snapshot across every mounted
    # catalog whose connector exposes snapshots_rows() (duck-typed like
    # the rest of this table's feeds); parent_id -1 marks the root
    "snapshots": [
        ("catalog", T.VARCHAR),
        ("table_name", T.VARCHAR),
        ("snapshot_id", T.BIGINT),
        ("parent_id", T.BIGINT),
        ("operation", T.VARCHAR),
        ("data_files", T.BIGINT),
        ("rows", T.BIGINT),
        ("is_current", T.BOOLEAN),
        ("committed_at_us", T.BIGINT),
    ],
    # one row per (node, pool): the cluster memory view — the session's
    # LocalMemoryManager plus every heartbeat-announced worker snapshot
    # held by the coordinator ClusterMemoryManager (MemoryPool MBeans /
    # the reference's memory UI surface)
    "memory": [
        ("node_id", T.VARCHAR),
        ("pool", T.VARCHAR),
        ("size_bytes", T.BIGINT),
        ("reserved_bytes", T.BIGINT),
        ("free_bytes", T.BIGINT),
        ("queries", T.BIGINT),
        ("blocked_queries", T.BIGINT),
    ],
    # one row per resource group in the coordinator's tree
    # (server/resource_groups.py): live queued/running/shed state plus
    # the scheduling configuration the arbiter runs on
    "resource_groups": [
        ("name", T.VARCHAR),
        ("scheduling_policy", T.VARCHAR),
        ("scheduling_weight", T.BIGINT),
        ("running", T.BIGINT),
        ("queued", T.BIGINT),
        ("hard_concurrency_limit", T.BIGINT),
        ("max_queued", T.BIGINT),
        ("queue_deadline_s", T.DOUBLE),
        ("memory_share", T.DOUBLE),
        ("memory_usage_bytes", T.BIGINT),
        ("soft_memory_limit_bytes", T.BIGINT),
        ("decayed_cost", T.DOUBLE),
        ("started_total", T.BIGINT),
        ("shed_total", T.BIGINT),
    ],
    # one row per ANALYZEd table (the session's analyze registry): when
    # stats were collected, over which columns, and at which data_version
    "table_stats": [
        ("catalog", T.VARCHAR),
        ("table_name", T.VARCHAR),
        ("columns", T.VARCHAR),
        ("row_count", T.DOUBLE),
        ("data_version", T.VARCHAR),
        ("analyzed_at", T.DOUBLE),
        ("duration_s", T.DOUBLE),
    ],
    # one row per kernel digest from the last ledger-enabled query's
    # device-memory bandwidth accounting (obs/bandwidth.py;
    # session.last_kernel_profile)
    "kernel_bandwidth": [
        ("kernel", T.VARCHAR),
        ("mode", T.VARCHAR),
        ("task_id", T.VARCHAR),
        ("executions", T.BIGINT),
        ("input_bytes", T.BIGINT),
        ("output_bytes", T.BIGINT),
        ("intermediate_bytes", T.BIGINT),
        ("total_bytes", T.BIGINT),
        ("device_wall_s", T.DOUBLE),
        ("gbps", T.DOUBLE),
        ("roofline_pct", T.DOUBLE),
    ],
    # the in-memory tail of the dispatch flight recorder
    # (obs/flight_recorder.py via the process device supervisor) —
    # seq-paired dispatch/complete/fault records, oldest first
    "flight_recorder": [
        ("seq", T.BIGINT),
        ("record_type", T.VARCHAR),
        ("kernel", T.VARCHAR),
        ("mode", T.VARCHAR),
        ("query_id", T.VARCHAR),
        ("task_id", T.VARCHAR),
        ("node_id", T.VARCHAR),
        ("shapes", T.VARCHAR),
        ("hbm_reserved_bytes", T.BIGINT),
        ("hbm_peak_bytes", T.BIGINT),
        ("wall_s", T.DOUBLE),
        ("fault_kind", T.VARCHAR),
        ("error", T.VARCHAR),
        ("ts", T.DOUBLE),
    ],
    # one row per operator frame of the last instrumented execution
    # (EXPLAIN ANALYZE / operator_stats=true; session.last_timeline) —
    # the operator/OperatorStats.java "as SQL" surface
    "operator_stats": [
        ("operator_id", T.BIGINT),
        ("plan_node_id", T.VARCHAR),
        ("operator_type", T.VARCHAR),
        ("input_rows", T.BIGINT),
        ("input_bytes", T.BIGINT),
        ("output_rows", T.BIGINT),
        ("output_bytes", T.BIGINT),
        ("wall_s", T.DOUBLE),
        ("device_wall_s", T.DOUBLE),
        ("host_wall_s", T.DOUBLE),
        ("blocked_memory_s", T.DOUBLE),
        ("blocked_exchange_s", T.DOUBLE),
        ("estimated_rows", T.DOUBLE),
        ("calls", T.BIGINT),
    ],
    # one row per completed query in the persisted history store
    # (obs/history.py): survives coordinator restart up to the torn tail
    "completed_queries": [
        ("query_id", T.VARCHAR),
        ("state", T.VARCHAR),
        ("query", T.VARCHAR),
        ("user", T.VARCHAR),
        ("created", T.DOUBLE),
        ("finished", T.DOUBLE),
        ("rows", T.BIGINT),
        ("wall_s", T.DOUBLE),
        ("error", T.VARCHAR),
        ("error_code", T.VARCHAR),
        ("tenant", T.VARCHAR),
        ("plan_signature", T.VARCHAR),
        ("operators", T.BIGINT),
    ],
    # the in-memory tail of the engine-wide incident journal
    # (obs/journal.py): every subsystem's typed, query/task/node-
    # correlated anomaly events, oldest first
    "events": [
        ("event_id", T.BIGINT),
        ("event_type", T.VARCHAR),
        ("query_id", T.VARCHAR),
        ("task_id", T.VARCHAR),
        ("node_id", T.VARCHAR),
        ("severity", T.VARCHAR),
        ("detail", T.VARCHAR),
        ("ts", T.DOUBLE),
    ],
    # the in-memory tail of the engine-wide compile observatory
    # (obs/compile_observatory.py): one row per trace/compile event,
    # including worker events ingested via the announcement piggyback
    "compiles": [
        ("compile_id", T.BIGINT),
        ("kernel", T.VARCHAR),
        ("family", T.VARCHAR),
        ("cause", T.VARCHAR),
        ("mode", T.VARCHAR),
        ("shapes", T.VARCHAR),
        ("actual_rows", T.BIGINT),
        ("padded_rows", T.BIGINT),
        ("compile_wall_s", T.DOUBLE),
        ("query_id", T.VARCHAR),
        ("task_id", T.VARCHAR),
        ("node_id", T.VARCHAR),
        ("ts", T.DOUBLE),
    ],
    # the shape census: one row per (kernel family, pow2 row bucket) —
    # the observed row counts of every kernel launch
    "shape_census": [
        ("family", T.VARCHAR),
        ("bucket", T.BIGINT),
        ("count", T.BIGINT),
        ("min_rows", T.BIGINT),
        ("max_rows", T.BIGINT),
        ("total_rows", T.BIGINT),
    ],
    # one row per query-doctor verdict (obs/doctor.py finalize pass):
    # the ranked causal root-cause report, newest last
    "diagnoses": [
        ("query_id", T.VARCHAR),
        ("verdict", T.VARCHAR),
        ("root_cause", T.VARCHAR),
        ("summary", T.VARCHAR),
        ("error_code", T.VARCHAR),
        ("event_ids", T.VARCHAR),
        ("findings", T.BIGINT),
        ("wall_s", T.DOUBLE),
        ("ts", T.DOUBLE),
    ],
    # the serving observatory's workload census (obs/serving_observatory):
    # one row per profiled canonical plan signature — arrival rate,
    # latency percentiles, observed device/host cost, estimate drift and
    # result-cache tallies, busiest shape first
    "plan_signatures": [
        ("signature", T.VARCHAR),
        ("tenant", T.VARCHAR),
        ("count", T.BIGINT),
        ("rate_per_s", T.DOUBLE),
        ("p50_s", T.DOUBLE),
        ("p95_s", T.DOUBLE),
        ("p99_s", T.DOUBLE),
        ("device_wall_s", T.DOUBLE),
        ("host_wall_s", T.DOUBLE),
        ("drift_ratio", T.DOUBLE),
        ("cache_hits", T.BIGINT),
        ("cache_misses", T.BIGINT),
        ("families", T.BIGINT),
        ("last_ts", T.DOUBLE),
    ],
    # per-node warmth per signature: which nodes hold warm compiled
    # programs for a signature's kernel families (per-family census off
    # worker announcements) or its fragment-result-cache entry — the
    # locality-aware dispatcher's input table
    "signature_affinity": [
        ("signature", T.VARCHAR),
        ("node_id", T.VARCHAR),
        ("warm_families", T.BIGINT),
        ("families_total", T.BIGINT),
        ("result_cache", T.BIGINT),
        ("score", T.DOUBLE),
    ],
    # per-tenant SLO compliance: declared objectives plus live fast/slow
    # window burn rates over the tenant's latency samples
    "slos": [
        ("tenant", T.VARCHAR),
        ("latency_target_s", T.DOUBLE),
        ("error_budget", T.DOUBLE),
        ("fast_window_s", T.DOUBLE),
        ("slow_window_s", T.DOUBLE),
        ("fast_burn_rate", T.DOUBLE),
        ("slow_burn_rate", T.DOUBLE),
        ("peak_fast_burn", T.DOUBLE),
        ("violations_total", T.BIGINT),
        ("observed_total", T.BIGINT),
        ("burn_events", T.BIGINT),
        ("p50_s", T.DOUBLE),
        ("p95_s", T.DOUBLE),
        ("p99_s", T.DOUBLE),
    ],
    # one row per metric series from the process-global MetricsRegistry —
    # the plugin/trino-jmx "metrics as SQL" surface; histograms expose
    # interpolated p50/p95/p99 alongside the observation count
    "metrics": [
        ("name", T.VARCHAR),
        ("kind", T.VARCHAR),
        ("labels", T.VARCHAR),
        ("value", T.DOUBLE),
        ("p50", T.DOUBLE),
        ("p95", T.DOUBLE),
        ("p99", T.DOUBLE),
    ],
}


class _SystemSource:
    """Pulls the live rows for one system table from the owning session."""

    def __init__(self, session):
        self.session = session

    def rows(self, table: str) -> Dict[str, list]:
        s = self.session
        if table == "catalogs":
            names = [n for n in s.catalogs.names()]
            return {
                "catalog_name": names,
                "connector_name": [
                    type(s.catalogs.get(n)).__name__ for n in names
                ],
            }
        if table == "tables":
            cats, tabs = [], []
            for c in s.catalogs.names():
                try:
                    for t in s.catalogs.get(c).metadata().list_tables():
                        cats.append(c)
                        tabs.append(t)
                except NotImplementedError:
                    pass
            for (c, v) in sorted(getattr(s.metadata, "views", {})):
                cats.append(c)
                tabs.append(v)
            return {"table_catalog": cats, "table_name": tabs}
        if table == "views":
            views = sorted(
                getattr(s.metadata, "views", {}).items()
            )
            return {
                "table_catalog": [c for (c, _n), _v in views],
                "table_name": [n for (_c, n), _v in views],
                "view_definition": [v.original_sql for _k, v in views],
            }
        if table == "columns":
            out = {"table_catalog": [], "table_name": [],
                   "column_name": [], "data_type": []}
            for c in s.catalogs.names():
                md = s.catalogs.get(c).metadata()
                try:
                    tables = md.list_tables()
                except NotImplementedError:
                    continue
                for t in tables:
                    for col in md.get_table_schema(t).columns:
                        out["table_catalog"].append(c)
                        out["table_name"].append(t)
                        out["column_name"].append(col.name)
                        out["data_type"].append(str(col.type))
            return out
        if table == "queries":
            hist = list(getattr(s, "query_history", ()))
            return {
                "query_id": [h["query_id"] for h in hist],
                "state": [h["state"] for h in hist],
                "query": [h["sql"][:200] for h in hist],
                "user": [h.get("user") or "user" for h in hist],
                "created": [h["created"] for h in hist],
                "finished": [h.get("finished") for h in hist],
                "rows": [h.get("rows", 0) for h in hist],
                "error": [h.get("error") for h in hist],
            }
        if table == "nodes":
            def device_cols(dev):
                if not dev:
                    return "ACTIVE", 0
                strikes = sum(
                    int(d.get("strikes", 0))
                    for d in (dev.get("devices") or [])
                )
                return dev.get("state", "ACTIVE"), strikes

            nodes = []
            nm = getattr(s, "node_manager", None)
            if nm is not None:
                import time as _time

                # discovery stamps state_since with time.time()
                now = _time.time()
                for snap in nm.nodes_snapshot():
                    dstate, strikes = device_cols(snap.get("device"))
                    nodes.append(
                        (snap["nodeId"], snap["uri"], snap["state"],
                         max(now - float(snap["stateSince"] or now), 0.0),
                         dstate, strikes, snap.get("host"),
                         snap.get("processIndex"),
                         snap.get("localDevices"))
                    )
            else:
                sup = getattr(s, "device_supervisor", None)
                dstate, strikes = device_cols(
                    sup.snapshot() if sup is not None else None
                )
                nodes.append(("local", "local://", "active", 0.0,
                              dstate, strikes, None, None, None))
            return {
                "node_id": [n[0] for n in nodes],
                "http_uri": [n[1] for n in nodes],
                "state": [n[2] for n in nodes],
                "state_age_s": [n[3] for n in nodes],
                "device_state": [n[4] for n in nodes],
                "device_strikes": [n[5] for n in nodes],
                "host": [n[6] for n in nodes],
                "process_index": [n[7] for n in nodes],
                "local_devices": [n[8] for n in nodes],
            }
        if table == "session_properties":
            rows = s.properties.show()
            return {
                "name": [r[0] for r in rows],
                "value": [r[1] for r in rows],
                "default": [r[2] for r in rows],
            }
        if table == "snapshots":
            out = {
                "catalog": [], "table_name": [], "snapshot_id": [],
                "parent_id": [], "operation": [], "data_files": [],
                "rows": [], "is_current": [], "committed_at_us": [],
            }
            for c in s.catalogs.names():
                conn = s.catalogs.get(c)
                if not hasattr(conn, "snapshots_rows"):
                    continue
                for (t, snap, parent, op, nfiles, nrows, cur,
                     ts) in conn.snapshots_rows():
                    out["catalog"].append(c)
                    out["table_name"].append(t)
                    out["snapshot_id"].append(snap)
                    out["parent_id"].append(parent)
                    out["operation"].append(op)
                    out["data_files"].append(nfiles)
                    out["rows"].append(nrows)
                    out["is_current"].append(bool(cur))
                    out["committed_at_us"].append(ts)
            return out
        if table == "caches":
            mgr = getattr(s, "caches", None)
            stats = mgr.stats_rows() if mgr is not None else []
            return {
                c: [r.get(c) for r in stats]
                for c, _t in SCHEMAS["caches"]
            }
        if table == "memory":
            snaps = []
            mm = getattr(s, "memory_manager", None)
            if mm is not None:
                snaps.append(mm.snapshot())
            cm = getattr(s, "cluster_memory", None)
            if cm is not None:
                local_id = snaps[0]["nodeId"] if snaps else None
                snaps.extend(
                    n for n in cm.nodes_view()
                    if n.get("nodeId") != local_id
                )
            out = {c: [] for c, _t in SCHEMAS["memory"]}
            for snap in snaps:
                blocked = len(snap.get("blocked") or {})
                for pool, p in (snap.get("pools") or {}).items():
                    out["node_id"].append(snap.get("nodeId", "local"))
                    out["pool"].append(pool)
                    out["size_bytes"].append(int(p.get("size", 0)))
                    out["reserved_bytes"].append(int(p.get("reserved", 0)))
                    out["free_bytes"].append(int(p.get("free", 0)))
                    out["queries"].append(len(p.get("byQuery") or {}))
                    out["blocked_queries"].append(blocked)
            return out
        if table == "resource_groups":
            mgr = getattr(s, "resource_group_manager", None)
            stats = mgr.info() if mgr is not None else []
            return {
                "name": [g["name"] for g in stats],
                "scheduling_policy": [g["schedulingPolicy"] for g in stats],
                "scheduling_weight": [g["schedulingWeight"] for g in stats],
                "running": [g["running"] for g in stats],
                "queued": [g["queued"] for g in stats],
                "hard_concurrency_limit": [
                    g["hardConcurrencyLimit"] for g in stats
                ],
                "max_queued": [g["maxQueued"] for g in stats],
                "queue_deadline_s": [g["queueDeadlineS"] for g in stats],
                "memory_share": [g["memoryShare"] for g in stats],
                "memory_usage_bytes": [
                    g["memoryUsageBytes"] for g in stats
                ],
                "soft_memory_limit_bytes": [
                    g["softMemoryLimitBytes"] for g in stats
                ],
                "decayed_cost": [g["decayedCost"] for g in stats],
                "started_total": [g["startedTotal"] for g in stats],
                "shed_total": [g["shedTotal"] for g in stats],
            }
        if table == "table_stats":
            entries = sorted(
                getattr(s, "analyzed_tables", {}).values(),
                key=lambda e: (e["catalog"], e["table"]),
            )
            return {
                "catalog": [e["catalog"] for e in entries],
                "table_name": [e["table"] for e in entries],
                "columns": [", ".join(e["columns"]) for e in entries],
                "row_count": [e["row_count"] for e in entries],
                "data_version": [str(e["data_version"]) for e in entries],
                "analyzed_at": [e["analyzed_at"] for e in entries],
                "duration_s": [e["duration_s"] for e in entries],
            }
        if table == "kernel_bandwidth":
            prof = getattr(s, "last_kernel_profile", None) or {}
            entries = prof.get("bandwidth") or []
            return {
                "kernel": [e["kernel"] for e in entries],
                "mode": [e["mode"] for e in entries],
                "task_id": [e.get("taskId", "") for e in entries],
                "executions": [e["executions"] for e in entries],
                "input_bytes": [e["inputBytes"] for e in entries],
                "output_bytes": [e["outputBytes"] for e in entries],
                "intermediate_bytes": [
                    e["intermediateBytes"] for e in entries
                ],
                "total_bytes": [e["totalBytes"] for e in entries],
                "device_wall_s": [e["deviceWallS"] for e in entries],
                "gbps": [e["gbps"] for e in entries],
                "roofline_pct": [e["rooflinePct"] for e in entries],
            }
        if table == "flight_recorder":
            import json as _json

            sup = getattr(s, "device_supervisor", None)
            rec = getattr(sup, "flight_recorder", None)
            tail = rec.tail() if rec is not None else []
            return {
                "seq": [r.get("seq", 0) for r in tail],
                "record_type": [r.get("recordType", "") for r in tail],
                "kernel": [r.get("kernel", "") for r in tail],
                "mode": [r.get("mode", "") for r in tail],
                "query_id": [r.get("queryId", "") for r in tail],
                "task_id": [r.get("taskId", "") for r in tail],
                "node_id": [r.get("nodeId", "") for r in tail],
                "shapes": [
                    _json.dumps(r.get("shapes") or {}, sort_keys=True)
                    for r in tail
                ],
                "hbm_reserved_bytes": [
                    int(r.get("hbmReservedBytes") or 0) for r in tail
                ],
                "hbm_peak_bytes": [
                    int(r.get("hbmPeakBytes") or 0) for r in tail
                ],
                "wall_s": [float(r.get("wallS") or 0.0) for r in tail],
                "fault_kind": [r.get("faultKind", "") for r in tail],
                "error": [r.get("error", "") for r in tail],
                "ts": [float(r.get("ts") or 0.0) for r in tail],
            }
        if table == "operator_stats":
            tl = getattr(s, "last_timeline", None) or {}
            frames = tl.get("operators") or []
            return {
                "operator_id": [
                    int(f.get("operatorId") or 0) for f in frames
                ],
                "plan_node_id": [
                    str(f.get("planNodeId") or "") for f in frames
                ],
                "operator_type": [
                    f.get("operatorType", "") for f in frames
                ],
                "input_rows": [
                    int(f.get("inputRows") or 0) for f in frames
                ],
                "input_bytes": [
                    int(f.get("inputBytes") or 0) for f in frames
                ],
                "output_rows": [
                    int(f.get("outputRows") or 0) for f in frames
                ],
                "output_bytes": [
                    int(f.get("outputBytes") or 0) for f in frames
                ],
                "wall_s": [
                    float(f.get("wallS") or 0.0) for f in frames
                ],
                "device_wall_s": [
                    float(f.get("deviceWallS") or 0.0) for f in frames
                ],
                "host_wall_s": [
                    float(f.get("hostWallS") or 0.0) for f in frames
                ],
                "blocked_memory_s": [
                    float(f.get("blockedMemoryS") or 0.0) for f in frames
                ],
                "blocked_exchange_s": [
                    float(f.get("blockedExchangeS") or 0.0)
                    for f in frames
                ],
                "estimated_rows": [
                    f.get("estimatedRows") for f in frames
                ],
                "calls": [int(f.get("calls") or 0) for f in frames],
            }
        if table == "completed_queries":
            hist = getattr(s, "history", None)
            recs = hist.completed() if hist is not None else []
            return {
                "query_id": [r.get("queryId") for r in recs],
                "state": [r.get("state") for r in recs],
                "query": [(r.get("sql") or "")[:200] for r in recs],
                "user": [r.get("user") or "user" for r in recs],
                "created": [r.get("created") for r in recs],
                "finished": [r.get("finished") for r in recs],
                "rows": [int(r.get("rows") or 0) for r in recs],
                "wall_s": [float(r.get("wallS") or 0.0) for r in recs],
                "error": [r.get("error") for r in recs],
                "error_code": [r.get("errorCode") or "" for r in recs],
                "tenant": [r.get("tenant") or "" for r in recs],
                "plan_signature": [
                    r.get("planSignature") or "" for r in recs
                ],
                "operators": [
                    len(r.get("operators") or ()) for r in recs
                ],
            }
        if table == "events":
            import json as _json

            from ..obs import journal as _journal

            tail = _journal.get_journal().tail()
            return {
                "event_id": [int(e.get("eventId") or 0) for e in tail],
                "event_type": [e.get("eventType", "") for e in tail],
                "query_id": [e.get("queryId", "") for e in tail],
                "task_id": [e.get("taskId", "") for e in tail],
                "node_id": [e.get("nodeId", "") for e in tail],
                "severity": [e.get("severity", "") for e in tail],
                "detail": [
                    _json.dumps(e.get("detail") or {}, sort_keys=True)
                    for e in tail
                ],
                "ts": [float(e.get("ts") or 0.0) for e in tail],
            }
        if table == "compiles":
            import json as _json

            from ..obs import compile_observatory as _co

            tail = _co.get_observatory().tail()
            return {
                "compile_id": [int(e.get("compileId") or 0) for e in tail],
                "kernel": [e.get("kernel", "") for e in tail],
                "family": [e.get("family", "") for e in tail],
                "cause": [e.get("cause", "") for e in tail],
                "mode": [e.get("mode", "") for e in tail],
                "shapes": [
                    _json.dumps(e.get("shapes") or {}, sort_keys=True)
                    for e in tail
                ],
                "actual_rows": [
                    int(e.get("actualRows") or 0) for e in tail
                ],
                "padded_rows": [
                    int(e.get("paddedRows") or 0) for e in tail
                ],
                "compile_wall_s": [
                    float(e.get("compileWallS") or 0.0) for e in tail
                ],
                "query_id": [e.get("queryId", "") for e in tail],
                "task_id": [e.get("taskId", "") for e in tail],
                "node_id": [e.get("nodeId", "") for e in tail],
                "ts": [float(e.get("ts") or 0.0) for e in tail],
            }
        if table == "shape_census":
            from ..obs import compile_observatory as _co

            recs = _co.get_observatory().merged_census().rows()
            return {
                "family": [r["family"] for r in recs],
                "bucket": [r["bucket"] for r in recs],
                "count": [r["count"] for r in recs],
                "min_rows": [r["minRows"] for r in recs],
                "max_rows": [r["maxRows"] for r in recs],
                "total_rows": [r["totalRows"] for r in recs],
            }
        if table == "plan_signatures":
            from ..obs import serving_observatory as _so

            recs = _so.get_observatory().signature_rows()
            return {
                "signature": [r["signature"] for r in recs],
                "tenant": [r["tenant"] for r in recs],
                "count": [int(r["count"]) for r in recs],
                "rate_per_s": [float(r["ratePerS"]) for r in recs],
                "p50_s": [float(r["p50S"]) for r in recs],
                "p95_s": [float(r["p95S"]) for r in recs],
                "p99_s": [float(r["p99S"]) for r in recs],
                "device_wall_s": [
                    float(r["deviceWallS"]) for r in recs
                ],
                "host_wall_s": [float(r["hostWallS"]) for r in recs],
                "drift_ratio": [float(r["driftRatio"]) for r in recs],
                "cache_hits": [int(r["cacheHits"]) for r in recs],
                "cache_misses": [int(r["cacheMisses"]) for r in recs],
                "families": [len(r["families"]) for r in recs],
                "last_ts": [float(r["lastTs"]) for r in recs],
            }
        if table == "signature_affinity":
            from ..obs import serving_observatory as _so

            recs = _so.get_observatory().affinity_rows(
                local_node_id=getattr(s, "serving_node_id", "") or "local"
            )
            return {
                "signature": [r["signature"] for r in recs],
                "node_id": [r["nodeId"] for r in recs],
                "warm_families": [
                    int(r["warmFamilies"]) for r in recs
                ],
                "families_total": [
                    int(r["familiesTotal"]) for r in recs
                ],
                "result_cache": [
                    int(bool(r["resultCache"])) for r in recs
                ],
                "score": [float(r["score"]) for r in recs],
            }
        if table == "slos":
            from ..obs import serving_observatory as _so

            recs = _so.get_observatory().slo_rows()
            return {
                "tenant": [r["tenant"] for r in recs],
                "latency_target_s": [
                    float(r["latencyTargetS"]) for r in recs
                ],
                "error_budget": [
                    float(r["errorBudget"]) for r in recs
                ],
                "fast_window_s": [
                    float(r["fastWindowS"]) for r in recs
                ],
                "slow_window_s": [
                    float(r["slowWindowS"]) for r in recs
                ],
                "fast_burn_rate": [
                    float(r["fastBurnRate"]) for r in recs
                ],
                "slow_burn_rate": [
                    float(r["slowBurnRate"]) for r in recs
                ],
                "peak_fast_burn": [
                    float(r["peakFastBurn"]) for r in recs
                ],
                "violations_total": [
                    int(r["violationsTotal"]) for r in recs
                ],
                "observed_total": [
                    int(r["observedTotal"]) for r in recs
                ],
                "burn_events": [int(r["burnEvents"]) for r in recs],
                "p50_s": [float(r["p50S"]) for r in recs],
                "p95_s": [float(r["p95S"]) for r in recs],
                "p99_s": [float(r["p99S"]) for r in recs],
            }
        if table == "diagnoses":
            from ..obs import doctor as _doctor

            recs = _doctor.recent_diagnoses()
            return {
                "query_id": [d.get("queryId", "") for d in recs],
                "verdict": [d.get("verdict", "") for d in recs],
                "root_cause": [d.get("rootCause", "") for d in recs],
                "summary": [d.get("summary", "") for d in recs],
                "error_code": [d.get("errorCode", "") for d in recs],
                "event_ids": [
                    ",".join(str(i) for i in d.get("eventIds") or ())
                    for d in recs
                ],
                "findings": [
                    len(d.get("findings") or ()) for d in recs
                ],
                "wall_s": [float(d.get("wallS") or 0.0) for d in recs],
                "ts": [float(d.get("ts") or 0.0) for d in recs],
            }
        if table == "metrics":
            from ..utils.metrics import REGISTRY

            return REGISTRY.rows()
        raise KeyError(f"unknown system table: {table}")


class SystemMetadata(ConnectorMetadata):
    def __init__(self, source: _SystemSource):
        self.source = source

    def list_tables(self) -> List[str]:
        return list(SCHEMAS)

    def get_table_schema(self, table: str) -> TableSchema:
        return TableSchema(
            table,
            tuple(ColumnSchema(c, t) for c, t in SCHEMAS[table]),
        )

    def get_table_statistics(self, table: str) -> TableStatistics:
        return TableStatistics(100.0, {})


class SystemSplitManager(SplitManager):
    def get_splits(self, table: str, desired: int, constraint=None):
        return [Split(table, 0, 1)]


class SystemPageSource(PageSource):
    def __init__(self, source: _SystemSource, split: Split, columns):
        self.source = source
        self.split = split
        self.columns = list(columns)

    def pages(self):
        data = self.source.rows(self.split.table)
        schema = dict(SCHEMAS[self.split.table])
        cols = [
            column_from_pylist(schema[c], data[c]) for c in self.columns
        ]
        n = len(next(iter(data.values()))) if data else 0
        yield Page(cols, n, self.columns)

    def dictionaries(self) -> Dict[str, np.ndarray]:
        # per-column dictionaries ride on the Columns built in pages();
        # re-snapshotting here could diverge from that page
        return {}


class SystemPageSourceProvider(PageSourceProvider):
    def __init__(self, source: _SystemSource):
        self.source = source

    def create_page_source(self, split: Split, columns: Sequence[str]):
        return SystemPageSource(self.source, split, columns)


class SystemConnector(Connector):
    cacheable = False  # live engine state changes between queries
    coordinator_only = True  # snapshots THIS process; never runs on workers

    def __init__(self, name: str, session):
        self.name = name
        self.source = _SystemSource(session)

    def metadata(self):
        return SystemMetadata(self.source)

    def split_manager(self):
        return SystemSplitManager()

    def page_source_provider(self):
        return SystemPageSourceProvider(self.source)


class SystemConnectorFactory(ConnectorFactory):
    name = "system"

    def create(self, catalog_name: str, config: dict) -> SystemConnector:
        return SystemConnector(catalog_name, config["session"])
