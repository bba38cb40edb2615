"""The query doctor: ranked cross-subsystem root-cause verdicts.

Counterpart of trino_tpu/obs/doctor.py, copied (pure Python): the same
ordered rule table, error codes and wire fields (``DIAGNOSIS_FIELDS``),
so a journal directory either package wrote gets the same verdict from
either doctor.  The device-fault rule keeps its "-> CPU degraded re-run"
branch for CPU_FALLBACK events, which only the JAX package writes: the
port fails a faulted query instead of re-running it on the CPU, so its
own device-fault verdicts never carry that step.

At query finalize (and on demand for crashed queries via the persisted
journal segments) the doctor correlates the incident journal
(:mod:`.journal`) with the flight recorder, the bandwidth ledger, the
per-operator timeline and the query history into one deterministic
causal verdict:

    ROOT_CAUSE: device_fault — device_loss on session/fused_agg_sums
    -> quarantine [events 3,4]

Rule evaluation is an ordered table with explicit precedence — fault >
kill > node-churn > memory pressure > corruption heals >
straggler/hedge > fusion misses > estimate-drift (the last per Leis et
al., *How Good Are Query Optimizers, Really?*: estimated-vs-observed
rows from the operator timeline) — so the same evidence always produces
the same ranking.  Every verdict cites the concrete event ids it derived
from, and a query with no anomalies gets an explicit ``HEALTHY``
verdict so absence of diagnosis is itself a signal.

Surfaces: a "Diagnosis" section in EXPLAIN ANALYZE, the
``system.runtime.diagnoses`` table, and post-mortem use after kill -9
(reconstruction from on-disk segments alone):

    python -m trino_tpu_torch.obs.doctor --journal DIR [--history DIR]
        [--query QUERY_ID] [--json]
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import journal as J

# wire schema for one diagnosis document (system.runtime.diagnoses)
DIAGNOSIS_FIELDS = (
    "queryId",
    "verdict",
    "rootCause",
    "summary",
    "findings",
    "eventIds",
    "wallS",
    "error",
    "errorCode",
    "ts",
)

HEALTHY = "HEALTHY"
ROOT_CAUSE = "ROOT_CAUSE"

# estimated-vs-observed row ratio above which an operator counts as
# estimate-drifted (Leis et al. report q-errors of 10^2..10^4 for real
# optimizers; 4x keeps ordinary stats noise out of the verdict)
ESTIMATE_DRIFT_RATIO = 4.0


# -- structured error codes (satellite: history post-mortem surface) -----


def classify_error(error) -> str:
    """Map an error (exception or rendered text) to a structured code.

    The coordinator renders errors as ``TypeName: message``, so type
    names are part of the searchable text."""
    if error is None:
        return ""
    text = str(error)
    if not text:
        return ""
    checks = (
        ("NO_NODES_AVAILABLE", "NO_NODES_AVAILABLE"),
        ("QUERY_QUEUE_FULL", "QUERY_QUEUE_FULL"),
        ("QueryKilledError", "QUERY_KILLED"),
        ("Query killed", "QUERY_KILLED"),
        ("device_wedge", "DEVICE_WEDGE"),
        ("device_loss", "DEVICE_LOSS"),
        ("DeviceFaultError", "DEVICE_FAULT"),
        ("REMOTE_HOST_GONE", "REMOTE_HOST_GONE"),
        ("COORDINATOR_RESTART", "COORDINATOR_RESTART"),
        ("ADMISSION_TIMEOUT", "ADMISSION_TIMEOUT"),
        ("shed after", "ADMISSION_TIMEOUT"),
        ("admission queue", "ADMISSION_TIMEOUT"),
        ("ExceededMemoryLimit", "EXCEEDED_MEMORY_LIMIT"),
        ("memory limit", "EXCEEDED_MEMORY_LIMIT"),
        ("PageIntegrityError", "PAGE_CORRUPTION"),
        ("SchedulerError", "SCHEDULER_ERROR"),
    )
    for needle, code in checks:
        if needle in text:
            return code
    return "INTERNAL_ERROR"


# -- evidence helpers ----------------------------------------------------


def _events_of(ctx: Dict, *types, sites: Optional[tuple] = None) -> List[Dict]:
    out = []
    for e in ctx.get("events") or []:
        if e.get("eventType") not in types:
            continue
        if sites is not None and e.get("eventType") == J.FAULT_INJECTED:
            if (e.get("detail") or {}).get("site") not in sites:
                continue
        out.append(e)
    return out


def _ids(events: List[Dict]) -> List[int]:
    return [int(e.get("eventId", 0)) for e in events]


def _finding(code: str, severity: str, summary: str,
             events: List[Dict]) -> Dict:
    return {
        "code": code,
        "severity": severity,
        "summary": summary,
        "eventIds": _ids(events),
    }


# -- the ordered rule table ----------------------------------------------


def _rule_device_fault(ctx) -> Optional[Dict]:
    faults = _events_of(ctx, J.DEVICE_FAULT)
    injected = _events_of(ctx, J.FAULT_INJECTED,
                          sites=("device_loss", "device_wedge"))
    if not faults and not injected:
        return None
    transitions = _events_of(ctx, J.DEVICE_QUARANTINE, J.DEVICE_BLACKLIST)
    fallbacks = _events_of(ctx, J.CPU_FALLBACK)
    first = faults[0] if faults else injected[0]
    detail = first.get("detail") or {}
    kind = detail.get("kind") or detail.get("site") or "device_fault"
    where = first.get("nodeId") or "local"
    kernel = detail.get("kernel") or ""
    summary = f"{kind} on {where}" + (f"/{kernel}" if kernel else "")
    if any(e.get("eventType") == J.DEVICE_BLACKLIST for e in transitions):
        summary += " -> blacklist"
    elif transitions:
        summary += " -> quarantine"
    if fallbacks:
        summary += " -> CPU degraded re-run"
    return _finding("device_fault", J.ERROR, summary,
                    faults + injected + transitions + fallbacks)


def _rule_memory_kill(ctx) -> Optional[Dict]:
    kills = _events_of(ctx, J.MEMORY_KILL)
    if not kills and ctx.get("errorCode") != "QUERY_KILLED":
        return None
    reason = ""
    if kills:
        reason = (kills[0].get("detail") or {}).get("reason", "")
    summary = "query killed by the memory killer"
    if reason:
        summary += f" ({reason[:120]})"
    revokes = _events_of(ctx, J.MEMORY_REVOKE)
    if revokes:
        summary += " after revoke cascade"
    return _finding("memory_kill", J.ERROR, summary, kills + revokes)


def _rule_host_gone(ctx) -> Optional[Dict]:
    """A host-sized capacity unit (a process owning a whole slice of the
    global device mesh) went GONE.  Ranked ABOVE plain node churn: the
    same death also fires NODE_GONE, but losing a host takes out every
    device in its slice plus its local spools at once — the host loss is
    the cause, the node transition its per-node shadow."""
    gone = _events_of(ctx, J.HOST_GONE)
    if not gone:
        return None
    reassigned = _events_of(ctx, J.FTE_REASSIGN)
    hosts = sorted({
        (e.get("detail") or {}).get("host") or e.get("nodeId") or "?"
        for e in gone
    })
    devices = sum(
        int((e.get("detail") or {}).get("localDevices") or 0) for e in gone
    )
    summary = (
        f"host loss: {','.join(hosts)} "
        f"({devices} local device(s)) left the cluster"
    )
    if reassigned:
        summary += f" -> {len(reassigned)} task attempt(s) reassigned"
    if ctx.get("errorCode") == "NO_NODES_AVAILABLE":
        summary += " -> no schedulable nodes left"
    return _finding("host_gone", J.ERROR if ctx.get("error") else J.WARN,
                    summary, gone + reassigned)


def _rule_node_churn(ctx) -> Optional[Dict]:
    # FTE_REASSIGN alone is a recovery *mechanism*, not churn evidence —
    # spool heals reassign too.  The rule needs an actual node signal.
    gone = _events_of(ctx, J.NODE_GONE, J.NODE_SUSPECT)
    deaths = _events_of(ctx, J.FAULT_INJECTED, sites=("worker_death",))
    if not gone and not deaths \
            and ctx.get("errorCode") not in ("NO_NODES_AVAILABLE",
                                             "REMOTE_HOST_GONE"):
        return None
    reassigned = _events_of(ctx, J.FTE_REASSIGN)
    churn = gone + reassigned
    nodes = sorted({e.get("nodeId") for e in gone + deaths
                    if e.get("nodeId")})
    summary = "worker death" if deaths else "node churn"
    if nodes:
        summary += f" on {','.join(nodes)}"
    elif gone:
        summary += " (node GONE mid-query)"
    if reassigned:
        summary += f" -> {len(reassigned)} task attempt(s) reassigned"
    if ctx.get("errorCode") == "NO_NODES_AVAILABLE":
        summary += " -> no schedulable nodes left"
    return _finding("node_churn", J.ERROR if ctx.get("error") else J.WARN,
                    summary, deaths + churn)


def _rule_snapshot_conflict(ctx) -> Optional[Dict]:
    """A lakehouse commit lost the metadata-pointer CAS to a concurrent
    writer and retried (optimistic concurrency doing its job), possibly
    under injected object-store faults.  WARN when the query still
    succeeded — the retry loop absorbed the race — ERROR only when the
    retry budget was exhausted and the query failed."""
    conflicts = _events_of(ctx, J.SNAPSHOT_CONFLICT)
    faults = _events_of(
        ctx, J.FAULT_INJECTED,
        sites=("objstore_error", "objstore_throttle", "objstore_latency"),
    )
    if not conflicts:
        return None
    tables = sorted({
        (e.get("detail") or {}).get("table") or "?" for e in conflicts
    })
    summary = (
        f"snapshot commit lost the metadata CAS {len(conflicts)} time(s) "
        f"on {','.join(tables)} -> re-read winner and retried"
    )
    if faults:
        summary += f" (under {len(faults)} injected object-store fault(s))"
    sev = J.ERROR if ctx.get("error") else J.WARN
    return _finding("snapshot_conflict", sev, summary, conflicts + faults)


def _rule_coordinator_restart(ctx) -> Optional[Dict]:
    """The coordinator itself died and came back: the query was either
    resumed from WAL-recorded committed spools (QUERY_RESUMED) or
    orphaned with the structured retryable error (QUERY_ORPHANED).
    Ranked below node churn — a dead WORKER loses spools and running
    tasks, while a dead coordinator loses only in-memory bookkeeping
    that the WAL reconstructs — and above mesh shrink."""
    restarts = _events_of(ctx, J.COORDINATOR_RESTART)
    resumed = _events_of(ctx, J.QUERY_RESUMED)
    orphaned = _events_of(ctx, J.QUERY_ORPHANED)
    deaths = _events_of(ctx, J.FAULT_INJECTED, sites=("coordinator_death",))
    if not (restarts or resumed or orphaned or deaths) \
            and ctx.get("errorCode") != "COORDINATOR_RESTART":
        return None
    parts = ["coordinator restarted mid-query"]
    if resumed:
        spools = sum(
            int((e.get("detail") or {}).get("reusedSpools") or 0)
            for e in resumed
        )
        parts.append(
            "resumed from the WAL"
            + (f" reusing {spools} committed spool(s)" if spools else "")
        )
    if orphaned or ctx.get("errorCode") == "COORDINATOR_RESTART":
        parts.append(
            "pipelined stream state lost -> orphaned with retryable "
            "COORDINATOR_RESTART (client re-submits)"
        )
    summary = " -> ".join(parts)
    sev = J.ERROR if ctx.get("error") else J.WARN
    return _finding("coordinator_restart", sev, summary,
                    deaths + restarts + resumed + orphaned)


def _rule_mesh_shrink(ctx) -> Optional[Dict]:
    """A quarantined device dropped out of the SPMD mesh and the query
    finished on the healthy subset — slower (fewer shards), but a
    query-level non-event.  Below node churn (a dead WORKER loses
    spools and tasks; a shrunk mesh loses only parallelism), above
    memory pressure (the shrink halves per-shard headroom, so it often
    *causes* the memory symptoms)."""
    shrinks = _events_of(ctx, J.MESH_SHRINK)
    if not shrinks:
        return None
    devs = sorted({
        str((e.get("detail") or {}).get("deviceId"))
        for e in shrinks
        if (e.get("detail") or {}).get("deviceId") is not None
    })
    last = shrinks[-1].get("detail") or {}
    summary = "mesh shrank to the healthy subset"
    if devs:
        summary = (
            "device(s) %s dropped out of the mesh" % ",".join(devs)
        )
    if last.get("fromSize") and last.get("toSize"):
        summary += " (%s -> %s shards)" % (
            last["fromSize"], last["toSize"]
        )
    return _finding("mesh_shrink", J.WARN, summary, shrinks)


def _rule_overload(ctx) -> Optional[Dict]:
    """The cluster shed load or scaled under offered-load pressure.
    Below node churn (a dead worker is a fault, not demand) and above
    memory pressure (an overloaded cluster's admission queue backs up,
    so overload routinely *causes* the memory-pressure symptoms)."""
    sheds = _events_of(ctx, J.QUERY_SHED)
    timeouts = _events_of(ctx, J.QUEUE_TIMEOUT)
    rescues = _events_of(ctx, J.STARVATION_AVERTED)
    scales = _events_of(ctx, J.SCALE_OUT, J.SCALE_IN)
    if not (sheds or timeouts or rescues) \
            and ctx.get("errorCode") not in ("QUERY_QUEUE_FULL",
                                             "ADMISSION_TIMEOUT"):
        return None
    parts = []
    if sheds:
        group = (sheds[0].get("detail") or {}).get("group", "")
        parts.append(
            f"{len(sheds)} query(s) shed past the queue deadline"
            + (f" in group {group}" if group else "")
        )
    if timeouts:
        parts.append(
            f"{len(timeouts)} admission wait(s) timed out"
        )
    if rescues:
        parts.append(
            f"{len(rescues)} aged query(s) rescued by fair-share "
            "arbitration"
        )
    if not parts:
        parts.append(
            "rejected at submit (queue full)"
            if ctx.get("errorCode") == "QUERY_QUEUE_FULL"
            else "timed out waiting for admission"
        )
    outs = sum(1 for e in scales if e.get("eventType") == J.SCALE_OUT)
    ins = len(scales) - outs
    if outs:
        parts.append(f"autoscaler added {outs} worker(s)")
    if ins:
        parts.append(f"autoscaler drained {ins} worker(s)")
    summary = "overload: " + ", ".join(parts)
    sev = J.ERROR if ctx.get("error") else J.WARN
    return _finding("overload", sev, summary,
                    sheds + timeouts + rescues + scales)


def _rule_slo_burn(ctx) -> Optional[Dict]:
    """A tenant burned its SLO error budget past the fast-window
    threshold while this query ran.  Ranked directly below overload:
    shed/queue pressure is usually *why* the budget burns, so when both
    fire the overload verdict stays the root cause and the burn rides
    along as a secondary finding."""
    burns = _events_of(ctx, J.SLO_BURN)
    if not burns:
        return None
    worst = max(
        burns,
        key=lambda e: float((e.get("detail") or {}).get("burnRate") or 0.0),
    )
    d = worst.get("detail") or {}
    summary = (
        "slo burn: tenant %s burning its error budget at %.1fx over the "
        "%.0fs fast window (target %.2fs, budget %.0f%%)" % (
            d.get("tenant") or "?",
            float(d.get("burnRate") or 0.0),
            float(d.get("windowS") or 0.0),
            float(d.get("latencyTargetS") or 0.0),
            float(d.get("errorBudget") or 0.0) * 100.0,
        )
    )
    return _finding("slo_burn", J.WARN, summary, burns)


def _rule_memory_pressure(ctx) -> Optional[Dict]:
    oom = _events_of(ctx, J.FAULT_INJECTED, sites=("oom",))
    revokes = _events_of(ctx, J.MEMORY_REVOKE)
    blocks = _events_of(ctx, J.ADMISSION_BLOCK)
    streamed = _events_of(ctx, J.FORCED_STREAMING)
    if not (oom or revokes or blocks or streamed) \
            and ctx.get("errorCode") not in ("EXCEEDED_MEMORY_LIMIT",
                                             "ADMISSION_TIMEOUT"):
        return None
    parts = []
    if oom:
        parts.append("oom at reservation")
    if revokes:
        parts.append(f"{len(revokes)} revoke(s)")
    if blocks:
        parts.append("blocked in admission queue")
    if streamed:
        parts.append("fell back to tiled streaming")
    if not parts:
        parts.append("memory limit exceeded")
    summary = "memory pressure: " + ", ".join(parts)
    sev = J.ERROR if ctx.get("error") else J.WARN
    return _finding("memory_pressure", sev, summary,
                    oom + revokes + blocks + streamed)


def _rule_retrace_storm(ctx) -> Optional[Dict]:
    """A burst of shape-miss recompiles (compile observatory sliding
    window) put many-millisecond compiles on this query's path —
    the Tail-at-Scale rare-event p99 signature.  Ranked below memory
    pressure: an engine under memory churn re-traces as a *symptom*
    (evictions, capacity retreats), so pressure wins when both fire."""
    storms = _events_of(ctx, J.RETRACE_STORM)
    if not storms:
        return None
    misses = max(
        int((e.get("detail") or {}).get("misses") or 0) for e in storms
    )
    window = (storms[-1].get("detail") or {}).get("windowS")
    summary = (
        f"retrace storm: {misses} shape-miss compile(s) inside a "
        f"{window}s window — padding buckets do not fit this traffic "
        "shape (see system.runtime.shape_census / scripts/bucket_ladder.py)"
    )
    return _finding("retrace_storm", J.WARN, summary, storms)


def _rule_straggler(ctx) -> Optional[Dict]:
    flags = _events_of(ctx, J.STRAGGLER_FLAG)
    hedges = _events_of(ctx, J.HEDGE)
    if not flags and not hedges:
        return None
    parts = []
    if flags:
        worst = max(flags, key=lambda e: float(
            (e.get("detail") or {}).get("wallS", 0.0) or 0.0))
        d = worst.get("detail") or {}
        parts.append(
            "task %s straggled (%.2fs vs %.2fs median)"
            % (worst.get("taskId") or d.get("task", "?"),
               float(d.get("wallS", 0.0) or 0.0),
               float(d.get("medianS", 0.0) or 0.0))
        )
    if hedges:
        parts.append(f"{len(hedges)} hedge(s) dispatched")
    return _finding("straggler", J.WARN, "; ".join(parts), flags + hedges)


def _rule_spool_corruption(ctx) -> Optional[Dict]:
    heals = _events_of(ctx, J.SPOOL_HEAL)
    injected = _events_of(ctx, J.FAULT_INJECTED,
                          sites=("spool_write_corrupt", "spool_read"))
    if not heals and not injected:
        return None
    summary = "spool corruption"
    if heals:
        d = heals[0].get("detail") or {}
        frag = d.get("fragment")
        summary += (
            f" on fragment {frag}" if frag is not None else ""
        ) + " -> producer re-run, attempt healed"
    return _finding("spool_corruption", J.WARN, summary, injected + heals)


def _rule_cache_heal(ctx) -> Optional[Dict]:
    heals = _events_of(ctx, J.CACHE_HEAL)
    injected = _events_of(ctx, J.FAULT_INJECTED, sites=("cache_read",))
    if not heals and not injected:
        return None
    return _finding(
        "cache_corruption", J.WARN,
        f"{len(heals) or len(injected)} corrupt spilled cache "
        "frame(s) detected and healed (recomputed)",
        injected + heals,
    )


def _rule_fusion_reject(ctx) -> Optional[Dict]:
    rejects = _events_of(ctx, J.FUSION_REJECT)
    prof = ctx.get("profile") or {}
    if not rejects and not prof.get("fusionRejects"):
        return None
    reason = ""
    if rejects:
        reason = (rejects[0].get("detail") or {}).get("reason", "")
    elif prof.get("lastFusionReject"):
        reason = str(prof["lastFusionReject"])
    summary = "megakernel fusion rejected -> unfused path"
    if reason:
        summary += f" ({reason[:120]})"
    return _finding("fusion_reject", J.INFO, summary, rejects)


def _rule_estimate_drift(ctx) -> Optional[Dict]:
    injected = _events_of(ctx, J.FAULT_INJECTED, sites=("stats_estimate",))
    drifted = []
    for frame in (ctx.get("timeline") or {}).get("operators") or []:
        est = float(frame.get("estimatedRows", 0.0) or 0.0)
        obs = float(frame.get("outputRows", 0.0) or 0.0)
        if est <= 0 or obs <= 0:
            continue
        ratio = max(est / obs, obs / est)
        if ratio >= ESTIMATE_DRIFT_RATIO:
            drifted.append((ratio, frame))
    if not injected and not drifted:
        return None
    if drifted:
        ratio, frame = max(drifted, key=lambda p: p[0])
        summary = (
            "estimate drift: %s estimated %.0f rows, observed %.0f "
            "(%.1fx off)" % (
                frame.get("operator", "?"),
                float(frame.get("estimatedRows", 0.0) or 0.0),
                float(frame.get("outputRows", 0.0) or 0.0),
                ratio,
            )
        )
    else:
        d = injected[0].get("detail") or {}
        summary = (
            "estimate drift: seeded stats_estimate skewed %s"
            % (d.get("key") or "a fragment estimate")
        )
    return _finding("estimate_drift", J.INFO, summary, injected)


# precedence is the tentpole's mandated order: first hit is the root
# cause; later hits still appear as secondary findings
_RULES = (
    _rule_device_fault,
    _rule_memory_kill,
    # host loss directly above node churn: a GONE host also fires
    # NODE_GONE for its node, but the host verdict carries the real
    # blast radius (a whole device slice and its spools)
    _rule_host_gone,
    _rule_node_churn,
    # coordinator restart below node churn (a dead worker loses spools
    # and tasks; a dead coordinator loses only bookkeeping the WAL
    # reconstructs), above mesh shrink
    _rule_coordinator_restart,
    # snapshot conflicts below coordinator restart (a lost CAS is
    # absorbed by the commit retry loop; it only explains latency or, on
    # budget exhaustion, the failure) and above mesh shrink
    _rule_snapshot_conflict,
    _rule_mesh_shrink,
    # overload below node churn (a dead worker is a fault, not demand),
    # above memory pressure (a backed-up admission queue is usually the
    # overload's symptom, not an independent cause)
    _rule_overload,
    # slo burn directly below overload: shed/queue pressure is usually
    # why a tenant's budget burns, so when both fire the overload
    # verdict stays the root cause and the burn is secondary
    _rule_slo_burn,
    _rule_memory_pressure,
    # retrace storms directly below memory pressure: recompile bursts
    # under memory churn are usually the pressure's symptom (capacity
    # retreats re-trace), so the pressure verdict must outrank them
    _rule_retrace_storm,
    # corruption heals before straggler/hedge: a healed producer re-run
    # is slow, so corruption routinely *causes* a straggler flag — the
    # flag is the symptom, the corrupt frame is the cause
    _rule_spool_corruption,
    _rule_cache_heal,
    _rule_straggler,
    _rule_fusion_reject,
    _rule_estimate_drift,
)


# -- diagnosis -----------------------------------------------------------


def diagnose(
    query_id: str,
    events: List[Dict],
    timeline: Optional[Dict] = None,
    profile: Optional[Dict] = None,
    flight_records: Optional[List[Dict]] = None,
    error: Optional[str] = None,
    error_code: Optional[str] = None,
    wall_s: float = 0.0,
) -> Dict:
    """Run the ordered rule table over the evidence for one query.

    ``events`` should already be scoped to the query (see
    :func:`events_for_query` for the scoping policy)."""
    ctx = {
        "queryId": query_id,
        "events": events or [],
        "timeline": timeline,
        "profile": profile,
        "flight_records": flight_records,
        "error": str(error) if error else "",
        "errorCode": error_code if error_code is not None
        else classify_error(error),
    }
    findings = []
    for rule in _RULES:
        try:
            f = rule(ctx)
        except Exception:  # noqa: BLE001 — a broken rule must not mask
            continue       # the others (diagnosis is best-effort)
        if f is not None:
            findings.append(f)
    if findings:
        top = findings[0]
        verdict, root, summary = ROOT_CAUSE, top["code"], top["summary"]
        event_ids = top["eventIds"]
    else:
        verdict, root = HEALTHY, ""
        summary = "no anomalous events correlated with this query"
        event_ids = []
    diagnosis = {
        "queryId": query_id,
        "verdict": verdict,
        "rootCause": root,
        "summary": summary,
        "findings": findings,
        "eventIds": event_ids,
        "wallS": float(wall_s or 0.0),
        "error": ctx["error"],
        "errorCode": ctx["errorCode"],
        "ts": time.time(),
    }
    from ..utils.metrics import REGISTRY

    REGISTRY.counter(
        "trino_tpu_doctor_diagnoses_total",
        "Query-doctor verdicts, by verdict class",
    ).inc(verdict=verdict, cause=root or "none")
    return diagnosis


def events_for_query(
    query_id: str,
    events: Optional[List[Dict]] = None,
    window: Optional[tuple] = None,
    slack_s: float = 1.0,
) -> List[Dict]:
    """Scope journal events to one query: events tagged with its id,
    plus ambient events (no queryId — fault-injector firings, node
    churn) inside the query's wall-clock window.  Ambient attribution
    is a heuristic; concurrent queries can share ambient events."""
    if events is None:
        events = J.get_journal().tail()
    scoped, ambient = [], []
    for e in events:
        if e.get("queryId") == query_id:
            scoped.append(e)
        elif not e.get("queryId"):
            ambient.append(e)
    if window is None and scoped:
        ts = [e.get("ts", 0.0) for e in scoped]
        window = (min(ts), max(ts))
    if window is not None:
        t0, t1 = window
        scoped += [
            e for e in ambient
            if t0 - slack_s <= e.get("ts", 0.0) <= t1 + slack_s
        ]
    scoped.sort(key=lambda e: (e.get("ts", 0.0), e.get("eventId", 0)))
    return scoped


def diagnose_query(
    query_id: str,
    window: Optional[tuple] = None,
    timeline: Optional[Dict] = None,
    profile: Optional[Dict] = None,
    error: Optional[str] = None,
    error_code: Optional[str] = None,
    wall_s: float = 0.0,
) -> Dict:
    """Diagnose against the live process-global journal (query finalize)."""
    events = events_for_query(query_id, window=window)
    return diagnose(
        query_id, events, timeline=timeline, profile=profile,
        error=error, error_code=error_code, wall_s=wall_s,
    )


def diagnose_recent() -> Optional[Dict]:
    """Diagnose the most recent query seen in the global journal (where
    no query object survives)."""
    events = J.get_journal().tail()
    tagged = [e for e in events if e.get("queryId")]
    if not tagged:
        return None
    qid = tagged[-1]["queryId"]
    return diagnose(qid, events_for_query(qid, events=events))


# -- offline reconstruction (kill -9 post-mortem) ------------------------


def find_crashed_query(
    events: List[Dict], history: Optional[List[Dict]] = None
) -> Optional[str]:
    """The newest journal queryId whose history record is absent or not
    FINISHED — with no history at all, simply the newest queryId (the
    crash took the history writer down with it)."""
    finished = {
        h.get("queryId") for h in (history or [])
        if h.get("state") == "FINISHED"
    }
    for e in reversed(events):
        qid = e.get("queryId")
        if qid and qid not in finished:
            return qid
    return None


def diagnose_from_dir(
    journal_dir: str,
    query_id: Optional[str] = None,
    history_dir: Optional[str] = None,
) -> Optional[Dict]:
    """Reconstruct a verdict from persisted segments alone (the process
    that wrote them is gone)."""
    events = J.read_journal_dir(journal_dir)
    if not events:
        return None
    history = None
    error = error_code = None
    if history_dir:
        from .history import read_history_dir

        history = read_history_dir(history_dir)
    if query_id is None:
        query_id = find_crashed_query(events, history)
    if query_id is None:
        return None
    for h in history or []:
        if h.get("queryId") == query_id:
            error = h.get("error") or None
            error_code = h.get("errorCode") or None
    return diagnose(
        query_id, events_for_query(query_id, events=events),
        error=error, error_code=error_code,
    )


# -- rendering -----------------------------------------------------------


def format_diagnosis(diagnosis: Optional[Dict]) -> str:
    """The "Diagnosis" section of EXPLAIN ANALYZE and of the command line."""
    if not diagnosis:
        return "Diagnosis:\n  (doctor disabled or no evidence)"
    lines = ["Diagnosis:"]
    if diagnosis.get("verdict") == HEALTHY:
        lines.append(f"  HEALTHY — {diagnosis.get('summary', '')}")
        return "\n".join(lines)
    for i, f in enumerate(diagnosis.get("findings") or []):
        label = "ROOT_CAUSE" if i == 0 else "      also"
        cited = ",".join(str(x) for x in f.get("eventIds") or [])
        cite = f" [events {cited}]" if cited else ""
        lines.append(
            f"  {label}: {f.get('code')} — {f.get('summary')}{cite}"
        )
    if diagnosis.get("errorCode"):
        lines.append(
            f"  error: {diagnosis['errorCode']}"
            + (f" — {diagnosis['error'][:160]}"
               if diagnosis.get("error") else "")
        )
    return "\n".join(lines)


# -- process-global diagnosis registry (system.runtime.diagnoses) --------

_DIAG_LOCK = threading.Lock()
_DIAGNOSES: deque = deque(maxlen=256)


def record_diagnosis(diagnosis: Dict):
    with _DIAG_LOCK:
        _DIAGNOSES.append(diagnosis)


def recent_diagnoses() -> List[Dict]:
    with _DIAG_LOCK:
        return list(_DIAGNOSES)


def _reset_diagnoses():
    with _DIAG_LOCK:
        _DIAGNOSES.clear()


def main(argv=None) -> int:
    """Post-mortem verdict from persisted segments: the crashed query (or
    ``--query``) of a journal directory, with its history when given.
    Exit 1 when the directory holds no query to diagnose."""
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="python -m trino_tpu_torch.obs.doctor")
    ap.add_argument("--journal", required=True, help="event_journal_dir")
    ap.add_argument("--history", default=None, help="query_history_dir")
    ap.add_argument("--query", default=None, help="query id (default: the crashed one)")
    ap.add_argument("--json", action="store_true", help="print the diagnosis document")
    args = ap.parse_args(argv)
    diag = diagnose_from_dir(args.journal, query_id=args.query,
                             history_dir=args.history)
    if diag is None:
        print("no query to diagnose in " + args.journal)
        return 1
    print(json.dumps(diag, sort_keys=True, default=str) if args.json
          else f"query {diag['queryId']}\n" + format_diagnosis(diag))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
