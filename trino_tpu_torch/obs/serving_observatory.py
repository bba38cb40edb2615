"""Serving observatory: per-signature workload census, cache-affinity
map, and per-tenant SLO burn-rate monitor.

Counterpart of trino_tpu/obs/serving_observatory.py (copied): the same
wire fields and store format, so a ``serving_observatory_dir`` written by
either package merges in the other.  Device and host walls come from
the port's operator frames, and the affinity map reads the port's
compile observatory.

Three coordinator-resident components that turn "the engine measures
everything" into "the engine knows what to do next":

- :class:`SignatureCensus` — keyed by the canonical plan signature
  (``cache/signature.py``), a bounded rolling profile per recurring
  query shape: arrival count + EWMA inter-arrival rate, latency
  p50/p95/p99 (the fixed-bucket histogram from ``utils/metrics.py``),
  observed device/host cost, estimate-vs-observed row drift (Leis et
  al., *How Good Are Query Optimizers, Really?*, VLDB 2015 — track the
  drift per shape instead of trusting static estimates), and
  result-cache hit/miss tallies.  Fed from the coordinator's
  ``_finalize_query``; persisted through the same mmap'd
  torn-tail-tolerant two-segment pid-suffixed store contract as the
  journal and query history (``serving_observatory_dir``), merged
  across restarts and backfilled from the persisted query history.
- :class:`AffinityMap` view — per-node warmth per signature: which
  nodes hold compiled programs for the signature's kernel families
  (piggybacking the compile observatory's per-family census that
  already rides worker announcements) and which node holds its
  fragment-result-cache entry.  ``system.runtime.signature_affinity``
  and ``GET /v1/affinity`` are literally the input table a
  locality-aware dispatcher reads.
- :class:`SloMonitor` — per-tenant declared latency/error objectives
  with multi-window burn-rate computation (fast ~30 s + slow ~5 m,
  scaled for tests) in the spirit of Dean & Barroso's *The Tail at
  Scale*: watch the budget burn continuously instead of discovering
  the violation in a post-mortem.  A fast-window burn past threshold
  journals a throttled ``SLO_BURN`` event the query doctor ranks
  directly below overload.
"""
from __future__ import annotations

import glob
import json
import mmap
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..utils.metrics import Histogram, REGISTRY

# wire-document field names (lowerCamelCase, one naming regime with the
# journal/flight-recorder/WAL documents) — linted by
# scripts/check_metric_names.py against these tuples

# one persisted observation (JSONL record in the two-segment store)
OBSERVATION_FIELDS = (
    "queryId",
    "signature",
    "tenant",
    "latencyS",
    "deviceWallS",
    "hostWallS",
    "driftRatio",
    "cacheHit",
    "cacheStored",
    "families",
    "ts",
)

# one census row (system.runtime.plan_signatures / GET /v1/signatures)
SIGNATURE_FIELDS = (
    "signature",
    "tenant",
    "count",
    "ratePerS",
    "p50S",
    "p95S",
    "p99S",
    "deviceWallS",
    "hostWallS",
    "driftRatio",
    "cacheHits",
    "cacheMisses",
    "families",
    "lastTs",
)

# one affinity row (system.runtime.signature_affinity / GET /v1/affinity)
AFFINITY_FIELDS = (
    "signature",
    "nodeId",
    "warmFamilies",
    "familiesTotal",
    "resultCache",
    "score",
)

# one tenant objective row (system.runtime.slos / GET /v1/slo)
SLO_FIELDS = (
    "tenant",
    "latencyTargetS",
    "errorBudget",
    "fastWindowS",
    "slowWindowS",
    "fastBurnRate",
    "slowBurnRate",
    "peakFastBurn",
    "violationsTotal",
    "observedTotal",
    "burnEvents",
    "p50S",
    "p95S",
    "p99S",
)

DEFAULT_MAX_BYTES = 1 << 20
MAX_RECORD_BYTES = 4096
MIN_SEGMENT_BYTES = 1 << 16
_FILE_PREFIX = "so-"

# census bounding: past this many signatures new shapes fold into one
# overflow bucket (the compile observatory's ShapeCensus contract)
DEFAULT_MAX_SIGNATURES = 128
OTHER_KEY = "__other__"

# SLO defaults (overridable per tenant via resource-group spec keys
# sloLatencyTargetS/sloErrorBudget and session properties)
DEFAULT_LATENCY_TARGET_S = 1.0
DEFAULT_ERROR_BUDGET = 0.1
DEFAULT_FAST_WINDOW_S = 30.0
DEFAULT_SLOW_WINDOW_S = 300.0
DEFAULT_BURN_THRESHOLD = 2.0

_LATENCY_HIST_NAME = "trino_tpu_signature_latency_seconds"


class _Segment:
    """One preallocated mmap'd JSONL file; re-opens append at the end of
    the surviving records instead of zeroing them (restart survival —
    the query-history contract, not the flight recorder's)."""

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
        self.last_ts = 0.0

    def load(self) -> List[Dict]:
        """Parse surviving records and position the append offset after
        the last intact line (a torn trailing line is overwritten)."""
        out: List[Dict] = []
        data = self.mm[: self.size]
        pos = 0
        for line in data.split(b"\n"):
            raw = line.strip(b"\0").strip()
            if raw:
                try:
                    rec = json.loads(raw)
                except ValueError:
                    break  # torn write: stop; append resumes here
                if isinstance(rec, dict) and "signature" in rec:
                    out.append(rec)
                    self.records += 1
                    self.last_ts = max(
                        self.last_ts, float(rec.get("ts") or 0.0)
                    )
                    pos += len(line) + 1
                    continue
            break
        self.offset = pos
        return out

    def reset(self):
        self.mm[: self.size] = b"\0" * self.size
        self.offset = 0
        self.records = 0
        self.last_ts = 0.0

    def append(self, data: bytes) -> bool:
        if self.offset + len(data) > self.size:
            return False
        self.mm[self.offset : self.offset + len(data)] = data
        self.offset += len(data)
        self.records += 1
        return True

    def sync(self):
        try:
            self.mm.flush()
        except Exception:  # noqa: BLE001 — sync is advisory
            pass

    def close(self):
        try:
            self.mm.close()
        except Exception:  # noqa: BLE001
            pass


class SignatureCensus:
    """Bounded rolling profile per canonical plan signature.

    Pure rollup math — persistence, SLO accounting and journal emission
    live in :class:`ServingObservatory`.  Observations carry the query
    id so replays (disk merge at boot, history backfill) never double
    count a query the live path already saw."""

    def __init__(
        self,
        max_signatures: int = DEFAULT_MAX_SIGNATURES,
        ewma_alpha: float = 0.25,
        buckets: Optional[Sequence[float]] = None,
    ):
        self.max_signatures = max(int(max_signatures), 1)
        self.ewma_alpha = float(ewma_alpha)
        self.buckets = tuple(buckets) if buckets else None
        self.profiles: Dict[str, Dict] = {}
        self._seen: Set[str] = set()
        self._seen_order: deque = deque()
        self._seen_cap = 8192
        self._lock = threading.Lock()

    # -- feed -----------------------------------------------------------
    def seen(self, query_id: str) -> bool:
        with self._lock:
            return bool(query_id) and query_id in self._seen

    def observe(
        self,
        signature: str,
        tenant: str = "",
        query_id: str = "",
        latency_s: float = 0.0,
        device_wall_s: float = 0.0,
        host_wall_s: float = 0.0,
        drift_ratio: Optional[float] = None,
        cache_hit: Optional[bool] = None,
        cache_stored: bool = False,
        families: Iterable[str] = (),
        node_id: str = "",
        ts: Optional[float] = None,
    ) -> bool:
        """Fold one finished query into its signature's profile.

        Returns False (and folds nothing) when the query id was already
        observed — the dedup that makes disk replay + history backfill
        idempotent against the live feed."""
        signature = str(signature or "")
        if not signature:
            return False
        ts = float(ts if ts is not None else time.time())
        with self._lock:
            if query_id:
                if query_id in self._seen:
                    return False
                self._seen.add(query_id)
                self._seen_order.append(query_id)
                while len(self._seen_order) > self._seen_cap:
                    self._seen.discard(self._seen_order.popleft())
            prof = self.profiles.get(signature)
            if prof is None:
                if (
                    len(self.profiles) >= self.max_signatures
                    and signature != OTHER_KEY
                ):
                    signature = OTHER_KEY
                    prof = self.profiles.get(OTHER_KEY)
            if prof is None:
                prof = {
                    "count": 0,
                    "lastTs": 0.0,
                    "ewmaIntervalS": 0.0,
                    "hist": Histogram(
                        _LATENCY_HIST_NAME,
                        "per-signature end-to-end latency",
                        buckets=self.buckets,
                    ),
                    "deviceWallS": 0.0,
                    "hostWallS": 0.0,
                    "driftRatio": 0.0,
                    "cacheHits": 0,
                    "cacheMisses": 0,
                    "families": set(),
                    "tenants": {},
                    "resultCacheNodes": set(),
                }
                self.profiles[signature] = prof
            prof["count"] += 1
            if prof["lastTs"] > 0.0 and ts > prof["lastTs"]:
                interval = max(ts - prof["lastTs"], 1e-6)
                if prof["ewmaIntervalS"] <= 0.0:
                    prof["ewmaIntervalS"] = interval
                else:
                    a = self.ewma_alpha
                    prof["ewmaIntervalS"] = (
                        a * interval + (1.0 - a) * prof["ewmaIntervalS"]
                    )
            prof["lastTs"] = max(prof["lastTs"], ts)
            prof["hist"].observe(max(float(latency_s or 0.0), 0.0))
            prof["deviceWallS"] += float(device_wall_s or 0.0)
            prof["hostWallS"] += float(host_wall_s or 0.0)
            if drift_ratio is not None:
                prof["driftRatio"] = max(
                    prof["driftRatio"], float(drift_ratio)
                )
            if cache_hit is True:
                prof["cacheHits"] += 1
            elif cache_hit is False:
                prof["cacheMisses"] += 1
            for fam in families or ():
                prof["families"].add(str(fam))
            if tenant:
                t = prof["tenants"]
                t[tenant] = t.get(tenant, 0) + 1
            if node_id and (cache_hit or cache_stored):
                prof["resultCacheNodes"].add(str(node_id))
        REGISTRY.counter(
            "trino_tpu_signature_queries_total",
            "Finished queries folded into the signature census",
        ).inc()
        REGISTRY.gauge(
            "trino_tpu_signature_census_state",
            "Distinct plan signatures currently profiled",
        ).set(len(self.profiles))
        return True

    # -- read -----------------------------------------------------------
    def rows(self) -> List[Dict]:
        """Census rows in the SIGNATURE_FIELDS wire shape, busiest
        signature first."""
        out: List[Dict] = []
        with self._lock:
            items = list(self.profiles.items())
        for sig, prof in items:
            hist = prof["hist"]
            interval = prof["ewmaIntervalS"]
            tenants = prof["tenants"]
            dominant = (
                max(tenants.items(), key=lambda kv: kv[1])[0]
                if tenants
                else ""
            )
            out.append(
                {
                    "signature": sig,
                    "tenant": dominant,
                    "count": prof["count"],
                    "ratePerS": (1.0 / interval) if interval > 0 else 0.0,
                    "p50S": hist.quantile(0.50),
                    "p95S": hist.quantile(0.95),
                    "p99S": hist.quantile(0.99),
                    "deviceWallS": prof["deviceWallS"],
                    "hostWallS": prof["hostWallS"],
                    "driftRatio": prof["driftRatio"],
                    "cacheHits": prof["cacheHits"],
                    "cacheMisses": prof["cacheMisses"],
                    "families": sorted(prof["families"]),
                    "lastTs": prof["lastTs"],
                }
            )
        out.sort(key=lambda r: (-r["count"], r["signature"]))
        return out

    def families_of(self, signature: str) -> Set[str]:
        with self._lock:
            prof = self.profiles.get(signature)
            return set(prof["families"]) if prof else set()

    def result_cache_nodes(self, signature: str) -> Set[str]:
        with self._lock:
            prof = self.profiles.get(signature)
            return set(prof["resultCacheNodes"]) if prof else set()


class SloMonitor:
    """Per-tenant latency/error objectives with multi-window burn rates.

    ``burn rate = (violating fraction of the window) / error budget`` —
    1.0 means the tenant burns its budget exactly as fast as allowed; a
    fast-window burn past ``burn_threshold`` journals one throttled
    ``SLO_BURN`` event per window so a sustained breach is a handful of
    citable events, not a flood."""

    def __init__(
        self,
        latency_target_s: float = DEFAULT_LATENCY_TARGET_S,
        error_budget: float = DEFAULT_ERROR_BUDGET,
        fast_window_s: float = DEFAULT_FAST_WINDOW_S,
        slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
        burn_threshold: float = DEFAULT_BURN_THRESHOLD,
        max_samples: int = 4096,
    ):
        self.latency_target_s = float(latency_target_s)
        self.error_budget = max(float(error_budget), 1e-6)
        self.fast_window_s = max(float(fast_window_s), 1e-3)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.burn_threshold = float(burn_threshold)
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._objectives: Dict[str, Dict] = {}
        self._samples: Dict[str, deque] = {}
        self._hist: Dict[str, Histogram] = {}
        self._violations: Dict[str, int] = {}
        self._observed: Dict[str, int] = {}
        self._burn_events: Dict[str, int] = {}
        self._peak_fast: Dict[str, float] = {}
        self._last_emit: Dict[str, float] = {}

    def set_defaults(
        self,
        latency_target_s=None,
        error_budget=None,
        fast_window_s=None,
        slow_window_s=None,
        burn_threshold=None,
    ):
        if latency_target_s is not None:
            self.latency_target_s = float(latency_target_s)
        if error_budget is not None:
            self.error_budget = max(float(error_budget), 1e-6)
        if fast_window_s is not None:
            self.fast_window_s = max(float(fast_window_s), 1e-3)
        if slow_window_s is not None:
            self.slow_window_s = max(float(slow_window_s), 1e-3)
        self.slow_window_s = max(self.slow_window_s, self.fast_window_s)
        if burn_threshold is not None:
            self.burn_threshold = float(burn_threshold)

    def set_objective(
        self, tenant: str, latency_target_s=None, error_budget=None
    ):
        """Declare one tenant's objective (resource-group spec keys
        ``sloLatencyTargetS``/``sloErrorBudget`` land here)."""
        tenant = str(tenant or "global")
        with self._lock:
            obj = self._objectives.setdefault(tenant, {})
            if latency_target_s is not None:
                obj["latencyTargetS"] = float(latency_target_s)
            if error_budget is not None:
                obj["errorBudget"] = max(float(error_budget), 1e-6)

    def objective(self, tenant: str) -> Tuple[float, float]:
        with self._lock:
            obj = self._objectives.get(str(tenant or "global")) or {}
        return (
            float(obj.get("latencyTargetS", self.latency_target_s)),
            float(obj.get("errorBudget", self.error_budget)),
        )

    # -- feed -----------------------------------------------------------
    def observe(
        self,
        tenant: str,
        latency_s: float,
        ok: bool = True,
        query_id: str = "",
        ts: Optional[float] = None,
        quiet: bool = False,
    ) -> Optional[int]:
        """Fold one finished query into its tenant's window; returns the
        journaled SLO_BURN event id when this observation tripped the
        fast-window threshold (None otherwise)."""
        tenant = str(tenant or "global")
        ts = float(ts if ts is not None else time.time())
        latency_s = max(float(latency_s or 0.0), 0.0)
        target, budget = self.objective(tenant)
        violated = (not ok) or latency_s > target
        with self._lock:
            samples = self._samples.get(tenant)
            if samples is None:
                samples = deque(maxlen=self.max_samples)
                self._samples[tenant] = samples
                self._hist[tenant] = Histogram(
                    "trino_tpu_slo_latency_seconds",
                    "per-tenant end-to-end latency under the SLO",
                )
            samples.append((ts, violated))
            self._hist[tenant].observe(latency_s)
            self._observed[tenant] = self._observed.get(tenant, 0) + 1
            if violated:
                self._violations[tenant] = (
                    self._violations.get(tenant, 0) + 1
                )
        if violated:
            REGISTRY.counter(
                "trino_tpu_slo_violations_total",
                "Queries that violated their tenant's SLO "
                "(late or failed)",
            ).inc(tenant=tenant)
        fast = self.burn_rate(tenant, self.fast_window_s, now=ts)
        slow = self.burn_rate(tenant, self.slow_window_s, now=ts)
        gauge = REGISTRY.gauge(
            "trino_tpu_slo_burn_rate_state",
            "Current SLO error-budget burn rate, by tenant and window",
        )
        gauge.set(fast, tenant=tenant, window="fast")
        gauge.set(slow, tenant=tenant, window="slow")
        with self._lock:
            self._peak_fast[tenant] = max(
                self._peak_fast.get(tenant, 0.0), fast
            )
        if quiet or fast <= self.burn_threshold:
            return None
        with self._lock:
            last = self._last_emit.get(tenant, 0.0)
            if ts - last < self.fast_window_s:
                return None  # throttle: one event per fast window
            self._last_emit[tenant] = ts
            self._burn_events[tenant] = (
                self._burn_events.get(tenant, 0) + 1
            )
            violations = self._violations.get(tenant, 0)
        from . import journal

        return journal.emit(
            journal.SLO_BURN,
            query_id=query_id,
            severity=journal.WARN,
            tenant=tenant,
            window="fast",
            windowS=self.fast_window_s,
            burnRate=round(fast, 4),
            slowBurnRate=round(slow, 4),
            latencyTargetS=target,
            errorBudget=budget,
            violations=violations,
        )

    # -- read -----------------------------------------------------------
    def burn_rate(
        self, tenant: str, window_s: float, now: Optional[float] = None
    ) -> float:
        tenant = str(tenant or "global")
        now = float(now if now is not None else time.time())
        _, budget = self.objective(tenant)
        with self._lock:
            samples = self._samples.get(tenant) or ()
            window = [v for (t, v) in samples if now - t <= window_s]
        if not window:
            return 0.0
        frac = sum(1 for v in window if v) / float(len(window))
        return frac / budget

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(set(self._samples) | set(self._objectives))

    def rows(self, now: Optional[float] = None) -> List[Dict]:
        """Per-tenant compliance rows in the SLO_FIELDS wire shape."""
        now = float(now if now is not None else time.time())
        out: List[Dict] = []
        for tenant in self.tenants():
            target, budget = self.objective(tenant)
            with self._lock:
                hist = self._hist.get(tenant)
                violations = self._violations.get(tenant, 0)
                observed = self._observed.get(tenant, 0)
                burns = self._burn_events.get(tenant, 0)
                peak = self._peak_fast.get(tenant, 0.0)
            out.append(
                {
                    "tenant": tenant,
                    "latencyTargetS": target,
                    "errorBudget": budget,
                    "fastWindowS": self.fast_window_s,
                    "slowWindowS": self.slow_window_s,
                    "fastBurnRate": self.burn_rate(
                        tenant, self.fast_window_s, now=now
                    ),
                    "slowBurnRate": self.burn_rate(
                        tenant, self.slow_window_s, now=now
                    ),
                    "peakFastBurn": peak,
                    "violationsTotal": violations,
                    "observedTotal": observed,
                    "burnEvents": burns,
                    "p50S": hist.quantile(0.50) if hist else 0.0,
                    "p95S": hist.quantile(0.95) if hist else 0.0,
                    "p99S": hist.quantile(0.99) if hist else 0.0,
                }
            )
        return out


class ServingObservatory:
    """The census + SLO monitor behind one crash-safe store.

    ``directory=None`` keeps observations memory-only; a directory
    upgrades the census feed to two pid-suffixed mmap'd segments that
    are merged back on the next open (including segments other writer
    pids left behind — the query-history restart contract)."""

    def __init__(
        self,
        directory: Optional[str] = None,
        max_bytes: int = DEFAULT_MAX_BYTES,
        name: Optional[str] = None,
        max_signatures: int = DEFAULT_MAX_SIGNATURES,
        buckets: Optional[Sequence[float]] = None,
        slo: Optional[Dict] = None,
    ):
        self.directory = str(directory or "").strip() or None
        self.max_bytes = max(
            int(max_bytes or DEFAULT_MAX_BYTES), 2 * MIN_SEGMENT_BYTES
        )
        self.name = name or str(os.getpid())
        self.census = SignatureCensus(
            max_signatures=max_signatures, buckets=buckets
        )
        self.slo = SloMonitor(**(slo or {}))
        self._lock = threading.Lock()
        # bounded raw-record mirror: configure() replays it into the
        # fresh segments so observations that land before the owning
        # coordinator finishes constructing are not lost
        self.mirror: deque = deque(maxlen=1024)
        self._segments: List[_Segment] = []
        self._active = 0
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
            seg_bytes = max(MIN_SEGMENT_BYTES, self.max_bytes // 2)
            own = set()
            for i in range(2):
                path = os.path.join(
                    self.directory,
                    f"{_FILE_PREFIX}{self.name}-{i}.jsonl",
                )
                own.add(os.path.abspath(path))
                self._segments.append(_Segment(path, seg_bytes))
            # survivors from OTHER writers (crashed pids, siblings)
            # replay into the census but are never appended to
            for rec in read_observatory_dir(self.directory, exclude=own):
                self._replay(rec)
            for seg in self._segments:
                for rec in seg.load():
                    self._replay(rec)
            self._active = max(
                range(2), key=lambda i: self._segments[i].last_ts
            )

    def _replay(self, rec: Dict):
        self.census.observe(
            rec.get("signature") or "",
            tenant=str(rec.get("tenant") or ""),
            query_id=str(rec.get("queryId") or ""),
            latency_s=float(rec.get("latencyS") or 0.0),
            device_wall_s=float(rec.get("deviceWallS") or 0.0),
            host_wall_s=float(rec.get("hostWallS") or 0.0),
            drift_ratio=rec.get("driftRatio"),
            cache_hit=rec.get("cacheHit"),
            cache_stored=bool(rec.get("cacheStored")),
            families=rec.get("families") or (),
            ts=rec.get("ts"),
        )

    # -- feed -----------------------------------------------------------
    def observe_query(
        self,
        signature: str = "",
        tenant: str = "",
        query_id: str = "",
        latency_s: float = 0.0,
        ok: bool = True,
        device_wall_s: float = 0.0,
        host_wall_s: float = 0.0,
        drift_ratio: Optional[float] = None,
        cache_hit: Optional[bool] = None,
        cache_stored: bool = False,
        families: Iterable[str] = (),
        node_id: str = "",
        ts: Optional[float] = None,
        quiet: bool = False,
    ) -> Optional[int]:
        """The one finalize hook: census + persistence + SLO in a single
        call.  Queries without a plan signature (coordinator-only
        statements, planning failures) still count against their
        tenant's SLO.  Returns the SLO_BURN event id if one fired."""
        ts = float(ts if ts is not None else time.time())
        rec = {
            "queryId": str(query_id or ""),
            "signature": str(signature or ""),
            "tenant": str(tenant or ""),
            "latencyS": float(latency_s or 0.0),
            "deviceWallS": float(device_wall_s or 0.0),
            "hostWallS": float(host_wall_s or 0.0),
            "driftRatio": drift_ratio,
            "cacheHit": cache_hit,
            "cacheStored": bool(cache_stored),
            "families": sorted(str(f) for f in (families or ())),
            "ok": bool(ok),
            "ts": ts,
        }
        if signature:
            fresh = self.census.observe(
                signature,
                tenant=rec["tenant"],
                query_id=rec["queryId"],
                latency_s=rec["latencyS"],
                device_wall_s=rec["deviceWallS"],
                host_wall_s=rec["hostWallS"],
                drift_ratio=drift_ratio,
                cache_hit=cache_hit,
                cache_stored=rec["cacheStored"],
                families=rec["families"],
                node_id=node_id,
                ts=ts,
            )
            if fresh:
                self._persist(rec)
        return self.slo.observe(
            tenant,
            latency_s,
            ok=ok,
            query_id=query_id,
            ts=ts,
            quiet=quiet,
        )

    def _persist(self, rec: Dict):
        with self._lock:
            self.mirror.append(rec)
            if not self._segments:
                return
            data = _encode(rec)
            if data is None:
                return
            seg = self._segments[self._active]
            if not seg.append(data):
                self._active = 1 - self._active
                seg = self._segments[self._active]
                seg.reset()
                seg.append(data)

    def backfill_from_history(self, records: Iterable[Dict]) -> int:
        """Rebuild census rows from persisted query-history records
        (``obs/history.py`` wire shape, carrying tenant/planSignature).  Already-observed query ids are skipped, so
        running after a disk merge only fills the gaps — and backfilled
        rows are not re-persisted (the history store is their durable
        home)."""
        count = 0
        for rec in records or ():
            if rec.get("state") not in ("FINISHED", "FAILED"):
                continue
            sig = str(rec.get("planSignature") or "")
            qid = str(rec.get("queryId") or "")
            if not sig or not qid:
                continue
            ts = rec.get("finished") or rec.get("ts")
            if self.census.observe(
                sig,
                tenant=str(rec.get("tenant") or ""),
                query_id=qid,
                latency_s=float(rec.get("wallS") or 0.0),
                ts=float(ts) if ts else None,
            ):
                count += 1
        return count

    # -- read -----------------------------------------------------------
    def signature_rows(self) -> List[Dict]:
        return self.census.rows()

    def affinity_rows(self, local_node_id: str = "") -> List[Dict]:
        """AFFINITY_FIELDS rows: per (signature, node) warmth, computed
        at read time by joining the census's kernel-family digests with
        the compile observatory's per-node family census (local process
        + every worker announcement) and the coordinator-local
        fragment-result-cache flag."""
        from . import compile_observatory as _co

        try:
            fam_map = _co.get_observatory().node_family_map(
                local_node_id=local_node_id
            )
        except Exception:  # noqa: BLE001 — affinity is best-effort
            fam_map = {}
        out: List[Dict] = []
        for row in self.census.rows():
            sig = row["signature"]
            if sig == OTHER_KEY:
                continue
            fams = set(row["families"])
            cache_nodes = self.census.result_cache_nodes(sig)
            nodes = set(fam_map) | cache_nodes
            total = len(fams)
            for node in sorted(nodes):
                warm = len(fams & fam_map.get(node, set()))
                has_cache = node in cache_nodes
                if warm == 0 and not has_cache:
                    continue
                score = (warm / total if total else 0.0) + (
                    1.0 if has_cache else 0.0
                )
                out.append(
                    {
                        "signature": sig,
                        "nodeId": node,
                        "warmFamilies": warm,
                        "familiesTotal": total,
                        "resultCache": bool(has_cache),
                        "score": round(score, 4),
                    }
                )
        out.sort(key=lambda r: (r["signature"], -r["score"], r["nodeId"]))
        return out

    def top_signatures(
        self, n: int = 10, local_node_id: str = ""
    ) -> List[Dict]:
        """The webui/bench block: busiest N census rows, each annotated
        with its warmest node from the affinity map."""
        warmest: Dict[str, Tuple[float, str]] = {}
        for a in self.affinity_rows(local_node_id=local_node_id):
            cur = warmest.get(a["signature"])
            if cur is None or a["score"] > cur[0]:
                warmest[a["signature"]] = (a["score"], a["nodeId"])
        out = []
        for row in self.census.rows()[: max(int(n), 0)]:
            row = dict(row)
            row["warmestNode"] = warmest.get(
                row["signature"], (0.0, "")
            )[1]
            row["families"] = len(row["families"])
            out.append(row)
        return out

    def slo_rows(self, now: Optional[float] = None) -> List[Dict]:
        return self.slo.rows(now=now)

    # -- durability ------------------------------------------------------
    def sync(self):
        with self._lock:
            for seg in self._segments:
                seg.sync()

    def close(self):
        with self._lock:
            for seg in self._segments:
                seg.close()
            self._segments = []


def _encode(rec: Dict) -> Optional[bytes]:
    data = json.dumps(rec, separators=(",", ":"), default=str).encode()
    data += b"\n"
    if len(data) > MAX_RECORD_BYTES:
        rec = dict(rec, families=[])
        data = json.dumps(rec, separators=(",", ":"), default=str).encode()
        data += b"\n"
        if len(data) > MAX_RECORD_BYTES:
            return None  # pathological; drop rather than corrupt
    return data


def read_observatory_dir(
    directory: str, exclude: Optional[set] = None
) -> List[Dict]:
    """Offline reader: every surviving observation in ``directory``
    ordered by ts.  Torn trailing lines and zeroed tail space are
    skipped, never an error — the kill -9 contract shared with the
    journal and query history."""
    records: List[Dict] = []
    for path in sorted(
        glob.glob(os.path.join(directory, _FILE_PREFIX + "*.jsonl"))
    ):
        if exclude and os.path.abspath(path) in exclude:
            continue
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
                continue  # torn write
            if isinstance(rec, dict) and "signature" in rec:
                records.append(rec)
    records.sort(key=lambda r: (r.get("ts") or 0.0, r.get("queryId", "")))
    return records


# -- the process-global observatory (finalize + system tables + HTTP) ---

_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Optional[ServingObservatory] = None


def get_observatory() -> ServingObservatory:
    """The process-global observatory (memory-only until configured)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = ServingObservatory(None)
        return _GLOBAL


def configure(
    directory=None,
    max_bytes=None,
    max_signatures=None,
    slo=None,
) -> ServingObservatory:
    """Upgrade/re-point the global observatory (coordinator boot:
    ``serving_observatory_dir`` + SLO session properties).  Observations
    already in the memory mirror are replayed into the fresh store, SLO
    defaults apply in place when the store itself is unchanged."""
    global _GLOBAL
    directory = str(directory or "").strip() or None
    try:
        max_bytes = int(max_bytes or 0) or DEFAULT_MAX_BYTES
    except (TypeError, ValueError):
        max_bytes = DEFAULT_MAX_BYTES
    with _GLOBAL_LOCK:
        cur = _GLOBAL
        if (
            cur is not None
            and cur.directory == directory
            and (directory is None or cur.max_bytes == max_bytes)
        ):
            if slo:
                cur.slo.set_defaults(**slo)
            if max_signatures:
                cur.census.max_signatures = max(int(max_signatures), 1)
            return cur
        nxt = ServingObservatory(
            directory,
            max_bytes=max_bytes,
            max_signatures=max_signatures or DEFAULT_MAX_SIGNATURES,
            slo=slo,
        )
        if cur is not None:
            for rec in list(cur.mirror):
                nxt.observe_query(
                    signature=rec.get("signature") or "",
                    tenant=rec.get("tenant") or "",
                    query_id=rec.get("queryId") or "",
                    latency_s=rec.get("latencyS") or 0.0,
                    ok=bool(rec.get("ok", True)),
                    device_wall_s=rec.get("deviceWallS") or 0.0,
                    host_wall_s=rec.get("hostWallS") or 0.0,
                    drift_ratio=rec.get("driftRatio"),
                    cache_hit=rec.get("cacheHit"),
                    cache_stored=bool(rec.get("cacheStored")),
                    families=rec.get("families") or (),
                    ts=rec.get("ts"),
                    quiet=True,
                )
            cur.close()
        _GLOBAL = nxt
        return nxt


def sync():
    """Flush the global observatory's segments (drain/shutdown walk)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        obs = _GLOBAL
    if obs is not None:
        obs.sync()


def _reset_observatory():
    """Test isolation: drop the process-global observatory."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
        _GLOBAL = None
