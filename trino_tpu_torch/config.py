"""Typed configuration + session properties.

Reference parity: airlift @Config binding (369 setters; TaskManagerConfig,
QueryManagerConfig, FeaturesConfig...) and SystemSessionProperties.java
(151 typed session properties) — reduced to the properties this port's
optimizer, analyzer, executor and session actually read: the memory
limit, spill and streaming ones, on-device generation, the result
cache, operator stats, the bandwidth ledger, ANALYZE's histogram, the
fault path's (fault injection, the device supervisor, the incident
journal and the flight recorder), the observatories' (the query
history, the doctor, the compile cache, the compile observatory and the
serving observatory's census and SLOs) and the server's (fault-tolerant
execution and whole-query retries, coordinator recovery, the
autoscaler).  Any other name, including the JAX package's properties
whose machinery the port does not have yet (the cross-host mesh) or
never will (the padding ladder: an eager executor pads nothing), raises
KeyError at SET time rather than being silently ignored; values are
validated and typed at SET time.

The JAX package's ``device_cpu_fallback`` is not here on purpose: a
device fault raises DeviceFaultError, and SET refuses the property.
``distributed = true`` runs a query over ``num_devices`` logical shards
(parallel/mesh_executor.py; 0 = one shard a visible card, one on the
CPU), and the planner's costing reads both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict


@dataclasses.dataclass(frozen=True)
class PropertyMetadata:
    name: str
    description: str
    parse: Callable[[str], Any]
    default: Any


def _bool(s: str) -> bool:
    if str(s).lower() in ("true", "1", "yes"):
        return True
    if str(s).lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean: {s}")


def _megakernels(s: str) -> str:
    v = str(s).strip().lower()
    if v not in ("auto", "on", "off"):
        raise ValueError(f"megakernels must be auto|on|off, got: {s}")
    return v


def _retry_policy(s: str) -> str:
    v = str(s).strip().lower()
    if v not in ("none", "task", "query"):
        raise ValueError(f"retry_policy must be none|task|query, got: {s}")
    return v


def _join_distribution(s: str) -> str:
    v = str(s).strip().lower()
    if v not in ("automatic", "broadcast", "partitioned"):
        raise ValueError(
            "join_distribution_type must be "
            f"automatic|broadcast|partitioned, got: {s}"
        )
    return v


# single source of truth for the automatic join-distribution threshold
# (total build-side rows across all tasks/devices)
BROADCAST_JOIN_THRESHOLD_ROWS = 1 << 20

SESSION_PROPERTIES: Dict[str, PropertyMetadata] = {
    p.name: p
    for p in [
        PropertyMetadata(
            "distributed",
            "execute over the full device mesh instead of one device",
            _bool, False,
        ),
        PropertyMetadata(
            "num_devices",
            "mesh size for distributed execution (0 = all devices)",
            int, 0,
        ),
        PropertyMetadata(
            "cross_host_mesh",
            "multi-host clusters: run eligible fragments as per-host "
            "slices over each worker's local shards, with repartition and "
            "partial-aggregate merges crossing the network exchange",
            _bool, False,
        ),
        PropertyMetadata(
            "join_distribution_type",
            "automatic | broadcast | partitioned "
            "(DetermineJoinDistributionType analog)",
            _join_distribution, "automatic",
        ),
        PropertyMetadata(
            "broadcast_join_threshold_rows",
            "automatic mode: build sides with more estimated rows are "
            "hash-partitioned instead of replicated (join-max-broadcast-"
            "table-size analog, in rows)",
            int, BROADCAST_JOIN_THRESHOLD_ROWS,
        ),
        PropertyMetadata(
            "reorder_joins",
            "stats-based join-graph reordering (ReorderJoins / "
            "EliminateCrossJoins analogs); off keeps the FROM order",
            _bool, True,
        ),
        PropertyMetadata(
            "distinct_agg_rewrite",
            "decompose global count(DISTINCT x) into count over a "
            "hash-partitionable Distinct (scales out / tiles)",
            _bool, True,
        ),
        PropertyMetadata(
            "direct_address_joins",
            "probe stats-proven-unique dense integer build keys through "
            "a direct-address table (one gather) instead of sort-merge",
            _bool, True,
        ),
        PropertyMetadata(
            "compaction",
            "tighten survivors of selective filters/joins into a smaller "
            "static capacity (downstream ops run at the reduced width)",
            _bool, True,
        ),
        PropertyMetadata(
            "fd_group_key_pruning",
            "drop group-by keys functionally dependent (via unique-build "
            "joins) on another key; they return as arbitrary() values",
            _bool, True,
        ),
        PropertyMetadata(
            "memo_optimizer",
            "iterative Memo exploration with cost-compared alternatives "
            "(join order/commutation/distribution); off keeps the greedy "
            "single-pass choices",
            _bool, True,
        ),
        PropertyMetadata(
            "statistics_enabled",
            "cost the plan from collected/connector table statistics "
            "(histograms, NDV); off degrades every table to a bare "
            "row count (statistics-enabled analog)",
            _bool, True,
        ),
        PropertyMetadata(
            "in_list_pushdown",
            "derive discrete-value TupleDomains from IN lists for "
            "connector split/row-group pruning",
            _bool, True,
        ),
        PropertyMetadata(
            "column_pruning",
            "prune unreferenced columns into table scans "
            "(PruneUnreferencedOutputs)",
            _bool, True,
        ),
        PropertyMetadata(
            "scan_cache_enabled",
            "cache device-resident scans across queries (warm-HBM reuse)",
            _bool, True,
        ),
        PropertyMetadata(
            "query_max_memory_bytes",
            "per-query device memory reservation limit",
            int, 8 << 30,
        ),
        PropertyMetadata(
            "query_max_total_memory_bytes",
            "per-query reservation limit summed across every node and "
            "pool (query.max-total-memory analog; 0 = unlimited)",
            int, 0,
        ),
        PropertyMetadata(
            "low_memory_killer_policy",
            "victim selection when a node is blocked on memory: none | "
            "total-reservation | total-reservation-on-blocked-nodes",
            str, "total-reservation-on-blocked-nodes",
        ),
        PropertyMetadata(
            "memory_admission_timeout_s",
            "seconds a query may wait in the memory admission queue "
            "before failing with an exceeded-memory error",
            float, 60.0,
        ),
        PropertyMetadata(
            "resource_group_queue_deadline_s",
            "default per-group queue deadline: queries queued longer "
            "are shed with a retryable ADMISSION_TIMEOUT instead of "
            "waiting forever (0 = queue forever); groups may override "
            "via queueDeadlineS",
            float, 0.0,
        ),
        PropertyMetadata(
            "memory_blocked_timeout_s",
            "seconds a blocked memory reservation waits for frees, "
            "revocation, or a killer verdict before raising",
            float, 0.0,
        ),
        PropertyMetadata(
            "spill_enabled",
            "allow out-of-core execution when input exceeds the memory limit",
            _bool, True,
        ),
        PropertyMetadata(
            "dynamic_filtering",
            "prune probe-side scans with build-side join domains",
            _bool, True,
        ),
        PropertyMetadata(
            "node_gone_grace_s",
            "continuous heartbeat silence before a SUSPECT/DRAINING node "
            "is declared GONE and its tasks reassigned "
            "(failure-detector GC-pause tolerance, seconds)",
            float, 10.0,
        ),
        PropertyMetadata(
            "exchange_retry_attempts",
            "transient exchange-fetch tries per failure streak before "
            "the upstream worker is declared dead",
            int, 3,
        ),
        PropertyMetadata(
            "exchange_retry_budget_s",
            "wall-clock budget for one exchange-fetch failure streak "
            "(exchange.max-error-duration analog, seconds)",
            float, 5.0,
        ),
        PropertyMetadata(
            "double_buffer_depth",
            "streaming tiles staged (host-decoded + H2D-uploaded) ahead "
            "of the executing tile; each staged tile holds its scan "
            "working set in device memory",
            int, 1,
        ),
        PropertyMetadata(
            "client_page_rows",
            "rows per protocol result page (client paging chunk)",
            int, 10000,
        ),
        PropertyMetadata(
            "megakernels",
            "fused scan->filter->aggregate megakernel (one pass per "
            "scan column): auto (on for CUDA tensors, off on the CPU) | "
            "on (the plain version on the CPU, for parity tests) | off",
            _megakernels, "auto",
        ),
        PropertyMetadata(
            "device_generation",
            "materialize counter-based generator scans (tpch) directly "
            "in HBM instead of host numpy + upload",
            _bool, True,
        ),
        PropertyMetadata(
            "result_cache",
            "serve repeated deterministic queries from the fragment "
            "result cache (invalidated by connector data versions)",
            _bool, True,
        ),
        PropertyMetadata(
            "result_cache_max_bytes",
            "in-memory byte budget for the fragment result cache "
            "(cold entries spill to disk as checksummed frames)",
            int, 256 << 20,
        ),
        PropertyMetadata(
            "straggler_dispersion_factor",
            "flag/hedge a task when its wall sits this many robust "
            "deviations (MAD units) above the sibling median",
            float, 2.0,
        ),
        PropertyMetadata(
            "operator_stats",
            "collect per-operator OperatorStats frames (rows/bytes/wall/"
            "blocked) on every execution; forces eager per-node timing",
            _bool, False,
        ),
        PropertyMetadata(
            "bandwidth_ledger",
            "bracket every supervised dispatch with block_until_ready "
            "and account bytes-touched / device wall into per-kernel "
            "effective GB/s (EXPLAIN ANALYZE always collects it)",
            _bool, False,
        ),
        PropertyMetadata(
            "fault_injection",
            "seeded fault-injection spec (JSON: {seed, site: rule...}) "
            "for chaos testing; empty = off",
            str, "",
        ),
        PropertyMetadata(
            "device_fault_max_strikes",
            "device faults inside the strike window before the device is "
            "blacklisted for the process lifetime",
            int, 3,
        ),
        PropertyMetadata(
            "device_probe_backoff_s",
            "base backoff between canary re-probes of a quarantined "
            "device (doubles per failure, capped)",
            float, 1.0,
        ),
        PropertyMetadata(
            "device_watchdog_timeout_s",
            "watchdog timeout on a supervised device->host sync; a sync "
            "exceeding it is treated as a device wedge (0=off)",
            float, 60.0,
        ),
        PropertyMetadata(
            "flight_recorder_dir",
            "directory for the crash-safe on-disk dispatch ring (mmap'd "
            "JSONL segments); empty keeps the flight recorder in-memory "
            "only",
            str, "",
        ),
        PropertyMetadata(
            "flight_recorder_max_records",
            "bound on the flight-recorder dispatch ring (oldest records "
            "rotate out)",
            int, 512,
        ),
        PropertyMetadata(
            "event_journal_dir",
            "directory for the crash-safe engine-wide incident journal "
            "(mmap'd JSONL segments); empty keeps the journal in-memory "
            "only",
            str, "",
        ),
        PropertyMetadata(
            "event_journal_max_bytes",
            "byte budget of the on-disk incident journal (the two "
            "segments rotate, oldest events drop first)",
            int, 1 << 20,
        ),
        PropertyMetadata(
            "query_history_dir",
            "directory for the crash-safe persisted query history store "
            "(mmap'd JSONL segments); empty = process-memory only",
            str, "",
        ),
        PropertyMetadata(
            "query_history_max_bytes",
            "byte budget of the persisted query history store (oldest "
            "completed queries evicted first)",
            int, 1 << 20,
        ),
        PropertyMetadata(
            "query_doctor",
            "run the query doctor at query finalize and attach its ranked "
            "root-cause diagnosis to EXPLAIN ANALYZE and "
            "system.runtime.diagnoses",
            _bool, True,
        ),
        PropertyMetadata(
            "compile_cache",
            "share encoded megakernel programs across queries and sessions "
            "(off: each executor encodes its own)",
            _bool, True,
        ),
        PropertyMetadata(
            "compile_cache_dir",
            "persistent compile-cache directory shared across processes "
            "(the nvcc-built kernel libraries + an index of the encoded "
            "programs); empty = the package's build directory, programs "
            "in memory only",
            str, "",
        ),
        PropertyMetadata(
            "compile_prewarm",
            "with compile_cache_dir set, build the kernel libraries and "
            "encode the indexed programs when a session starts, so the "
            "first queries compile nothing",
            _bool, True,
        ),
        PropertyMetadata(
            "compile_observatory_dir",
            "directory for the crash-safe engine-wide compile ledger "
            "(mmap'd JSONL segments plus per-writer census snapshots); "
            "empty keeps the observatory in-memory only",
            str, "",
        ),
        PropertyMetadata(
            "compile_census_max_families",
            "bound on distinct kernel families the shape census tracks "
            "(overflow folds into __other__, never dropped)",
            int, 64,
        ),
        PropertyMetadata(
            "analyze_histogram_buckets",
            "equi-height histogram buckets ANALYZE collects per "
            "numeric/date column (device-sort quantile boundaries)",
            int, 8,
        ),
        # fault-tolerant execution and whole-query retries, coordinator
        # recovery, the autoscaler and the serving observatory
        # (server/fte.py, recovery.py, autoscaler.py,
        # obs/serving_observatory.py)
        PropertyMetadata(
            "retry_policy",
            "failure recovery: none (pipelined) | task (FTE over spool) "
            "| query (whole-query re-dispatch on retriable failure)",
            _retry_policy, "none",
        ),
        PropertyMetadata(
            "query_retry_attempts",
            "retry_policy=query: whole-query re-dispatches before the "
            "failure is surfaced (query-retry-attempts analog)",
            int, 2,
        ),
        PropertyMetadata(
            "fte_max_attempts",
            "FTE: attempts per task before the query fails",
            int, 4,
        ),
        PropertyMetadata(
            "fte_task_timeout_s",
            "FTE: per-attempt wall-clock timeout (seconds)",
            float, 300.0,
        ),
        PropertyMetadata(
            "fte_speculation_factor",
            "FTE: speculate when a task exceeds this multiple of the "
            "median completed sibling duration",
            float, 2.0,
        ),
        PropertyMetadata(
            "fte_speculation_min_s",
            "FTE: minimum straggler age before speculation (seconds)",
            float, 0.75,
        ),
        PropertyMetadata(
            "speculative_execution",
            "FTE: launch backup attempts for straggler tasks "
            "(EventDrivenFaultTolerantQueryScheduler SPECULATIVE class)",
            _bool, True,
        ),
        PropertyMetadata(
            "adaptive_replan_factor",
            "FTE: replan the undispatched remainder when a fragment's "
            "observed output rows diverge from the estimate by this "
            "multiple in either direction (0 disables)",
            float, 4.0,
        ),
        PropertyMetadata(
            "coordinator_recovery_dir",
            "directory for the coordinator's write-ahead intent log "
            "(mmap'd torn-tail-tolerant JSONL segments journaling every "
            "query-state transition); on boot the coordinator replays "
            "it, resuming FTE queries from committed spools and failing "
            "pipelined ones with a retryable COORDINATOR_RESTART error; "
            "empty disables crash recovery",
            str, "",
        ),
        PropertyMetadata(
            "coordinator_recovery_window_s",
            "how long a restarted coordinator answers polls for "
            "still-recovering queries with 503+Retry-After (instead of "
            "404) and waits for discovery re-announcements to rebuild "
            "the live worker set before dispatching resumed work",
            float, 10.0,
        ),
        PropertyMetadata(
            "autoscale_min_workers",
            "autoscaler floor: scale-in never drains below this many "
            "ACTIVE workers",
            int, 1,
        ),
        PropertyMetadata(
            "autoscale_max_workers",
            "autoscaler ceiling: scale-out stops adding workers here",
            int, 4,
        ),
        PropertyMetadata(
            "autoscale_backlog_high",
            "queued queries (groups + memory admission) that count as "
            "sustained overload and trigger scale-out",
            int, 4,
        ),
        PropertyMetadata(
            "autoscale_cooldown_s",
            "seconds between autoscaler actions (anti-flap)",
            float, 2.0,
        ),
        PropertyMetadata(
            "autoscale_idle_grace_s",
            "seconds of empty backlog before scale-in drains a worker",
            float, 1.5,
        ),
        PropertyMetadata(
            "serving_observatory_dir",
            "directory for the crash-safe per-signature workload census "
            "(mmap'd torn-tail-tolerant JSONL segments, merged across "
            "restarts and backfilled from the persisted query history); "
            "empty keeps the serving observatory in-memory only",
            str, "",
        ),
        PropertyMetadata(
            "serving_observatory_max_bytes",
            "byte budget for the serving observatory's two on-disk "
            "census segments",
            int, 1 << 20,
        ),
        PropertyMetadata(
            "signature_census_max",
            "bound on distinct plan signatures the workload census "
            "profiles (overflow folds into __other__, never dropped)",
            int, 128,
        ),
        PropertyMetadata(
            "slo_latency_target_s",
            "default per-tenant latency objective: a finished query "
            "slower than this (or any failed query) burns its tenant's "
            "SLO error budget",
            float, 1.0,
        ),
        PropertyMetadata(
            "slo_error_budget",
            "default fraction of a tenant's queries allowed to violate "
            "the latency objective before the burn rate exceeds 1.0",
            float, 0.1,
        ),
        PropertyMetadata(
            "slo_fast_window_s",
            "fast SLO burn-rate window (page-now signal; a burn past "
            "slo_burn_threshold here journals a throttled slo_burn "
            "event)",
            float, 30.0,
        ),
        PropertyMetadata(
            "slo_slow_window_s",
            "slow SLO burn-rate window (sustained-breach signal for "
            "system.runtime.slos and the webui panel)",
            float, 300.0,
        ),
        PropertyMetadata(
            "slo_burn_threshold",
            "fast-window burn rate above which the serving observatory "
            "journals slo_burn and the query doctor starts citing it",
            float, 2.0,
        ),
    ]
}


class SessionProperties:
    """Per-session typed property bag (Session.java + SET SESSION)."""

    def __init__(self, overrides: Dict[str, Any] | None = None):
        self._values: Dict[str, Any] = {}
        for k, v in (overrides or {}).items():
            self.set(k, v)

    def set(self, name: str, value):
        meta = SESSION_PROPERTIES.get(name)
        if meta is None:
            raise KeyError(f"unknown session property: {name}")
        self._values[name] = (
            meta.parse(value) if isinstance(value, str) else value
        )

    def get(self, name: str):
        meta = SESSION_PROPERTIES.get(name)
        if meta is None:
            raise KeyError(f"unknown session property: {name}")
        return self._values.get(name, meta.default)

    def show(self) -> list:
        return [
            (name, str(self.get(name)), str(meta.default), meta.description)
            for name, meta in sorted(SESSION_PROPERTIES.items())
        ]
