"""Fault-tolerant (task-retry) query scheduler over the spooled exchange.

Counterpart of trino_tpu/server/fte.py (copied).  Each attempt runs on a
worker's device; its output frames go to its spool directory and the
consumers read them back and upload them once a source.  A task that
fails with DeviceFaultError (the port has no CPU re-run) is an ordinary
failed attempt: the next attempt steers off that worker, and placement
skips QUARANTINED nodes.  ``timings`` holds the root spool read's wall,
frame bytes and decode seconds, as the pipelined scheduler's do.

Reference parity: execution/scheduler/faulttolerant/
EventDrivenFaultTolerantQueryScheduler.java:199 — stage-by-stage execution
where every stage's output is spooled to durable storage (Exchange SPI /
trino-exchange-filesystem), failed task attempts are re-scheduled on other
alive workers, and consumers only ever read the spool paths of attempts the
scheduler committed (structural dedup of duplicate attempt output — the
DeduplicatingDirectExchangeBuffer / ExchangeSourceOutputSelector role).

Differences from the pipelined scheduler (scheduler.py): stages run with a
barrier between producer and consumer (no streaming overlap), so a worker
death or injected task failure only costs the retried task, never the query
(retry-policy=TASK).  Worker loss between stages is tolerated by re-picking
placement from the currently-alive node set per attempt.

Spool integrity: committed attempts are trusted only as far as their CRCs.
When a consumer task (or the root read) hits SpoolCorruptionError, the
scheduler treats the *producer's* committed attempt as a late task failure:
decommit the corrupt attempt, re-run that one producer task under a fresh
attempt number, splice the new spool path into the committed map, and let
the consumer retry — a flipped bit on the exchange costs one task re-run,
never the query (the Project-Tardigrade contract extended to data at rest).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Dict, List, Optional, Tuple

from ..catalog import CatalogManager
from ..exchange.filesystem import (
    FileSystemExchangeManager,
    SpoolCorruptionError,
    SpoolHandle,
    read_spool_pages,
)
from ..exec.partitioner import concat_pages
from ..page import Page
from ..plan import nodes as P
from ..plan.fragment import (
    ARBITRARY,
    HASH,
    SINGLE,
    SOURCE,
    PlanFragment,
    fragment_plan,
)
from ..serde import encode_value, plan_to_json
from .scheduler import (
    SchedulerError,
    _post_json,
    assign_splits,
    source_buffer_index,
)

MAX_ATTEMPTS = 4
POLL_INTERVAL = 0.02
TASK_TIMEOUT = 300.0
POLL_FAILURE_TOLERANCE = 3  # consecutive status-poll errors = worker lost
# speculative execution (EventDrivenFaultTolerantQueryScheduler SPECULATIVE
# class): a task running longer than SPECULATION_FACTOR x the median
# completed sibling (and at least SPECULATION_MIN_S) gets a backup attempt
# on another worker; first committed attempt wins
SPECULATION_FACTOR = 2.0
SPECULATION_MIN_S = 0.75
# failed attempts retry with exponentially grown memory
# (ExponentialGrowthPartitionMemoryEstimator)
MEMORY_GROWTH_FACTOR = 2

# the quoted-path marker SpoolCorruptionError embeds in task error
# strings; parsing it back out is how a consumer's FAILED state names
# the corrupt PRODUCER attempt to heal
_SPOOL_ERR_RE = re.compile(r"spool corruption at '([^']+)'")


def _corrupt_spool_path(err) -> Optional[str]:
    m = _SPOOL_ERR_RE.search(str(err))
    return m.group(1) if m else None


def _count_scans(n: P.PlanNode) -> int:
    total = 1 if isinstance(n, P.TableScan) else 0
    for s in n.sources:
        total += _count_scans(s)
    return total


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2]


class FaultTolerantScheduler:
    """retry-policy=TASK execution of one query."""

    def __init__(
        self,
        catalogs: CatalogManager,
        node_manager,
        exchange: Optional[FileSystemExchangeManager] = None,
        properties: Optional[dict] = None,
        metadata=None,
        precommitted: Optional[Dict[str, List[Optional[str]]]] = None,
        on_dispatch=None,
        on_commit=None,
    ):
        self.catalogs = catalogs
        self.node_manager = node_manager
        self.exchange = exchange or FileSystemExchangeManager()
        self.properties = properties or {}
        # coordinator-restart resume (server/recovery.py): committed
        # spool paths replayed from the WAL, keyed by structural fragment
        # signature — stages whose signature matches reuse them verbatim
        # and only UNFINISHED work re-runs.  Entries are re-verified on
        # disk (every path present + _COMMIT intact) before seeding.
        self.precommitted = dict(precommitted or {})
        # WAL intent hooks: on_dispatch(task_id, uri) after an attempt is
        # POSTed, on_commit(fragment_sig, task_index, spool_path) once an
        # attempt's spool wins — the coordinator journals both so a crash
        # between stages resumes instead of re-running
        self.on_dispatch = on_dispatch
        self.on_commit = on_commit
        p = self.properties
        # table statistics for per-fragment output estimates (the
        # OutputStatsEstimator's *expected* side); None disables the
        # estimate-vs-observed replan entirely
        if metadata is not None and not p.get("statistics_enabled", True):
            from ..plan.cost import RowCountOnlyMetadata

            metadata = RowCountOnlyMetadata(metadata)
        self.metadata = metadata
        from ..utils.faults import FaultInjector

        self._injector = FaultInjector.from_spec(p.get("fault_injection"))
        self.max_attempts = int(p.get("fte_max_attempts") or MAX_ATTEMPTS)
        self.task_timeout = float(
            p.get("fte_task_timeout_s") or TASK_TIMEOUT
        )
        self.spec_factor = float(
            p.get("fte_speculation_factor") or SPECULATION_FACTOR
        )
        self.spec_min_s = float(
            p.get("fte_speculation_min_s") or SPECULATION_MIN_S
        )
        # dispersion-aware speculation (obs/opstats): a primary is hedged
        # when its elapsed wall sits `straggler_dispersion_factor` robust
        # deviations above the sibling median, replacing the fixed
        # spec_factor*median age rule (which ignored how tight the
        # sibling distribution actually was)
        from ..obs.opstats import StragglerDetector

        self.straggler = StragglerDetector(
            factor=float(
                p.get("straggler_dispersion_factor") or 2.0
            ),
            min_s=self.spec_min_s,
        )

    # ------------------------------------------------------------------
    def run(self, plan: P.Output, query_id: Optional[str] = None) -> Page:
        query_id = query_id or f"q_{uuid.uuid4().hex[:12]}"
        self._created_tasks: List[Tuple[str, str]] = []  # (uri, task_id)
        # frag spool dir -> everything needed to re-run one producer task
        # of that stage (heals survive an adaptive re-fragmentation, which
        # renumbers fragments — the spool path keeps the OLD id)
        self._heal_ctx: Dict[str, tuple] = {}
        self._heal_lock = threading.RLock()  # heals can nest across stages
        self.heal_actions: List[dict] = []  # observability for chaos tests
        # observed spool bytes/rows per completed fragment (the
        # OutputStatsEstimator role) + the adaptive actions taken from
        # them (surfaced for tests/observability)
        self.output_stats: Dict[int, int] = {}
        self.output_rows: Dict[int, int] = {}
        self.fragment_estimates: Dict[int, float] = {}
        self.adaptive_actions: List[dict] = []
        # winning-attempt TaskInfo stats (operator timeline merge input)
        self.task_stats: List[dict] = []
        # host walls of the root read (the pipelined scheduler's keys)
        self.timings = {"rootFetchS": 0.0, "rootBytes": 0,
                        "rootDeserializeS": 0.0}
        # committed stages survive a replan when the new topology contains
        # a structurally identical fragment: spools are reused by signature
        committed_by_sig: Dict[str, List[str]] = {}
        stats_by_sig: Dict[str, Tuple[int, int]] = {}
        # restart resume: seed the signature map from WAL-replayed spool
        # paths, but only stages whose every attempt is still committed
        # on disk — a stale/evicted spool silently re-runs the stage
        # (width and buffer count are in the signature, so a changed
        # cluster size safely disables reuse instead of misrouting)
        for sig, paths in self.precommitted.items():
            if not paths or any(p is None for p in paths):
                continue
            if all(SpoolHandle(p).committed for p in paths):
                committed_by_sig[sig] = list(paths)
                stats_by_sig[sig] = self._spool_stats(list(paths))
        replans = 0
        try:
            while True:
                # post-replan stages spool under an epoch-suffixed query id
                # so renumbered fragments never collide with epoch-0 dirs
                epoch_qid = (
                    query_id if replans == 0 else f"{query_id}_r{replans}"
                )
                fragments = fragment_plan(plan)
                by_id = {f.id: f for f in fragments}
                consumer: Dict[int, int] = {}
                for f in fragments:
                    for sf in f.source_fragments:
                        consumer[sf] = f.id

                # stage width is fixed up-front (task count = buffer
                # addressing), but *placement* is re-chosen per attempt
                # from the alive set
                width: Dict[int, int] = {}
                cluster = self.node_manager.alive()
                if not cluster:
                    raise SchedulerError(
                        "NO_NODES_AVAILABLE: no alive workers"
                    )
                for f in fragments:
                    width[f.id] = (
                        len(cluster)
                        if f.partitioning in (SOURCE, HASH, ARBITRARY)
                        else 1
                    )

                sigs = self._fragment_signatures(fragments, width, consumer)
                est = self._estimate_fragments(fragments, by_id)
                self.fragment_estimates = dict(est)
                # committed spool dirs: frag -> [task_index -> spool path]
                committed: Dict[int, List[str]] = {}
                self.output_stats = {}
                self.output_rows = {}
                adaptive = bool(
                    self.properties.get("adaptive_replanning", True)
                )
                order = sorted(
                    (f for f in fragments if f.id != 0), key=lambda f: f.id
                ) + [by_id[0]]
                replanned = False
                for f in order:
                    reused = committed_by_sig.get(sigs[f.id])
                    if reused is not None:
                        committed[f.id] = reused
                        b, r = stats_by_sig.get(sigs[f.id], (0, 0))
                        self.output_stats[f.id] = b
                        self.output_rows[f.id] = r
                        continue
                    committed[f.id] = self._run_stage(
                        epoch_qid, f, width, committed, by_id, consumer,
                        sig=sigs[f.id],
                    )
                    committed_by_sig[sigs[f.id]] = committed[f.id]
                    if not adaptive:
                        continue
                    b, r = self._spool_stats(committed[f.id])
                    self.output_stats[f.id] = b
                    self.output_rows[f.id] = r
                    stats_by_sig[sigs[f.id]] = (b, r)
                    if replans == 0:
                        new_plan = self._maybe_replan(
                            plan, f, fragments, by_id, est, committed
                        )
                        if new_plan is not None:
                            plan = new_plan
                            replans += 1
                            replanned = True
                            break
                if not replanned:
                    break
            for _ in range(self.max_attempts):
                try:
                    t_root = time.perf_counter()
                    st = {"bytes": 0, "deserializeS": 0.0}
                    root_pages = read_spool_pages(
                        SpoolHandle(committed[0][0]).buffer_file(0),
                        stats=st,
                    )
                    self.timings.update(
                        rootFetchS=time.perf_counter() - t_root,
                        rootBytes=st["bytes"],
                        rootDeserializeS=st["deserializeS"],
                    )
                    break
                except SpoolCorruptionError as e:
                    # the ROOT attempt itself is corrupt: heal it like any
                    # other producer (decommit + re-run) and re-read
                    if not self._heal_corrupt_spool(e.path):
                        raise
            else:
                raise SchedulerError(
                    "root spool still corrupt after "
                    f"{self.max_attempts} heal attempts"
                )
            if not root_pages:
                raise SchedulerError("root stage produced no pages")
            return concat_pages(root_pages)
        finally:
            # abort + delete every attempt on the workers (frees task state;
            # abandoned attempts stop before re-creating spool dirs)
            for uri, task_id in self._created_tasks:
                try:
                    req = urllib.request.Request(
                        f"{uri}/v1/task/{task_id}", method="DELETE"
                    )
                    urllib.request.urlopen(req, timeout=5.0).read()
                except Exception:
                    pass
            self.exchange.cleanup_query(query_id)
            for i in range(1, replans + 1):
                self.exchange.cleanup_query(f"{query_id}_r{i}")

    # ------------------------------------------------------------------
    def _sources_for(
        self,
        f: PlanFragment,
        task_index: int,
        committed: Dict[int, List[str]],
        by_id: Dict[int, PlanFragment],
    ) -> Dict[str, list]:
        """Spool-file locations of the committed upstream attempts (same
        buffer routing as the pipelined scheduler, different location shape)."""
        sources: Dict[str, list] = {}
        for sf in f.source_fragments:
            src = by_id[sf]
            buf = source_buffer_index(src, task_index)
            sources[str(sf)] = [
                {"path": SpoolHandle(path).buffer_file(buf)}
                for path in committed[sf]
            ]
        return sources

    def _run_stage(
        self,
        query_id: str,
        f: PlanFragment,
        width: Dict[int, int],
        committed: Dict[int, List[str]],
        by_id: Dict[int, PlanFragment],
        consumer: Dict[int, int],
        sig: Optional[str] = None,
    ) -> List[str]:
        ntasks = width[f.id]
        out_buffers = (
            width[consumer[f.id]]
            if f.output_partitioning in (HASH, ARBITRARY)
            else 1
        )
        per_task_splits = assign_splits(self.catalogs, f, ntasks)
        root = self._adapt_fragment(f)
        frag_json = plan_to_json(root)
        from concurrent.futures import ThreadPoolExecutor

        sibling_times: List[float] = []  # completed task durations (stage)
        with ThreadPoolExecutor(max_workers=max(ntasks, 1)) as pool:
            futures = [
                pool.submit(
                    self._run_task_with_retries,
                    query_id, f, i, frag_json, per_task_splits[i],
                    out_buffers, committed, by_id, sibling_times, pool,
                )
                for i in range(ntasks)
            ]
            paths = [fut.result() for fut in futures]
        if self.on_commit is not None and sig is not None:
            # journal every winning attempt's spool path BEFORE the next
            # stage consumes it: a coordinator crash from here on resumes
            # this stage by signature instead of re-running it
            for i, path in enumerate(paths):
                try:
                    self.on_commit(sig, i, path)
                except Exception:
                    pass
        # retained so a later-detected corrupt committed attempt can be
        # healed by re-running exactly one producer task of this stage;
        # keyed by the fragment's spool dir (stable across a replan's
        # fragment renumbering) and holding this epoch's committed/by_id
        # so the heal re-run resolves its sources against the topology it
        # actually ran under
        if paths:
            frag_dir = os.path.dirname(os.path.abspath(paths[0]))
            self._heal_ctx[frag_dir] = (
                f, frag_json, per_task_splits, out_buffers, paths,
                query_id, dict(committed), by_id,
            )
        return paths

    def _spool_stats(self, spool_dirs: List[str]) -> Tuple[int, int]:
        """(uncompressed bytes, rows) committed by a stage, read from the
        page-frame headers only (serde.pages_stats) — the observed side
        of the adaptive planner's estimate-vs-actual comparison.
        Compressed file sizes would misrank sides (zstd flattens monotone
        int columns ~10x)."""
        import os

        from ..serde import pages_stats

        total = 0
        rows = 0
        for d in spool_dirs:
            try:
                for base, _dirs, files in os.walk(d):
                    for name in files:
                        p = os.path.join(base, name)
                        try:
                            with open(p, "rb") as fh:
                                r, ub = pages_stats(fh.read())
                            total += ub
                            rows += r
                        except Exception:
                            total += os.path.getsize(p)
            except OSError:
                pass
        return total, rows

    def _adapt_fragment(self, f: PlanFragment) -> P.PlanNode:
        """Adaptive replanning between stages (AdaptivePlanner.java +
        OutputStatsEstimator, scoped to the structure-preserving action):
        a not-yet-run fragment's inner join whose sides read committed
        upstream spools is RE-ORIENTED when the observed bytes contradict
        the planner's static choice — the build (right) side must be the
        smaller input.  Exchange topology, task widths, and buffer
        addressing are untouched; the in-fragment executor re-derives
        kernel flags (dup self-checks make a wrong uniqueness guess a
        retry, not an error)."""
        if not self.output_stats or not bool(
            self.properties.get("adaptive_replanning", True)
        ):
            return f.root

        stats = self.output_stats

        def observed(n: P.PlanNode) -> Optional[int]:
            """Bytes entering this subtree: committed spool sizes for
            RemoteSources (the real observation), connector-stats
            estimates for fragment-local scans (rows x cols x 8 — both
            sides must be comparable even when only one crossed an
            exchange)."""
            total = 0
            found = False
            bad = False

            def walk(x):
                nonlocal total, found, bad
                if isinstance(x, P.RemoteSource):
                    found = True
                    if x.fragment_id in stats:
                        total += stats[x.fragment_id]
                    else:
                        bad = True
                    return
                if isinstance(x, P.TableScan):
                    found = True
                    try:
                        md = self.catalogs.get(x.catalog).metadata()
                        rows = md.get_table_statistics(x.table).row_count
                        total += int(rows) * 8 * max(
                            len(x.assignments), 1
                        )
                    except Exception:
                        bad = True
                    return
                for s in x.sources:
                    walk(s)

            walk(n)
            if not found or bad:
                return None
            return total

        import dataclasses as dc

        def adapt(n: P.PlanNode) -> P.PlanNode:
            srcs = tuple(adapt(s) for s in n.sources)
            if srcs and any(a is not b for a, b in zip(srcs, n.sources)):
                from ..plan.memo import _replace_sources

                n = _replace_sources(n, srcs)
            if not (
                isinstance(n, P.Join)
                and n.kind == "inner"
                and n.criteria
            ):
                return n
            lb = observed(n.left)
            rb = observed(n.right)
            if lb is None or rb is None or rb <= lb * 2:
                return n
            # swapping must not disturb the fragment's TableScan preorder:
            # split assignment and dynamic filters address scans by index
            # (fragment.scan_tables), so only swap when at most one side
            # holds scans
            if _count_scans(n.left) and _count_scans(n.right):
                return n
            self.adaptive_actions.append({
                "action": "swap_join_sides",
                "fragment": f.id,
                "observed_left_bytes": lb,
                "observed_right_bytes": rb,
            })
            return P.Join(
                "inner", n.right, n.left,
                tuple((r, l) for l, r in n.criteria),
                n.filter,
                expansion=False,  # runtime dup checks re-derive exactly
                distribution=n.distribution,
                compact_rows=n.compact_rows,
            )

        try:
            return adapt(f.root)
        except Exception:
            return f.root

    # -- adaptive replanning (topology-changing tier) -------------------
    def _fragment_signatures(
        self,
        fragments: List[PlanFragment],
        width: Dict[int, int],
        consumer: Dict[int, int],
    ) -> Dict[int, str]:
        """Structural identity of every fragment: its plan shape (with
        each RemoteSource replaced by the SOURCE fragment's signature,
        so ids don't matter), task width and output shape.  After an
        adaptive replan renumbers fragments, a new fragment carrying the
        same signature as an already-committed one reuses that stage's
        spools verbatim instead of re-running."""
        import dataclasses as dc
        import hashlib

        by_id = {f.id: f for f in fragments}
        sigs: Dict[int, str] = {}

        def node_sig(n: P.PlanNode, child: Dict[int, str]) -> str:
            parts = [type(n).__name__]
            for fld in dc.fields(n):
                v = getattr(n, fld.name)
                if isinstance(v, P.PlanNode):
                    continue
                if isinstance(v, tuple) and any(
                    isinstance(x, P.PlanNode) for x in v
                ):
                    continue
                if isinstance(n, P.RemoteSource) and fld.name == "fragment_id":
                    parts.append(child.get(v, str(v)))
                    continue
                parts.append(f"{fld.name}={v!r}")
            for s in n.sources:
                parts.append(node_sig(s, child))
            return hashlib.blake2b(
                "\x1f".join(parts).encode(), digest_size=16
            ).hexdigest()

        def frag_sig(fid: int) -> str:
            if fid in sigs:
                return sigs[fid]
            f = by_id[fid]
            child = {sf: frag_sig(sf) for sf in f.source_fragments}
            out_buffers = (
                width[consumer[fid]]
                if f.output_partitioning in (HASH, ARBITRARY)
                else 1
            )
            doc = "|".join([
                node_sig(f.root, child),
                f.output_partitioning or "",
                ",".join(f.output_keys),
                str(width[fid]),
                str(out_buffers),
            ])
            sigs[fid] = hashlib.blake2b(
                doc.encode(), digest_size=16
            ).hexdigest()
            return sigs[fid]

        for f in fragments:
            frag_sig(f.id)
        return sigs

    def _frag_stats(self, est_map: Dict[int, float], by_id):
        """StatsProvider whose RemoteSource estimates resolve to the
        source fragment's rows in `est_map` — the fragment-graph analog
        of the planner's per-node StatsCalculator."""
        from ..plan import cost as C

        class _FragmentStats(C.StatsProvider):
            def _estimate(sp, node):
                if isinstance(node, P.RemoteSource):
                    try:
                        w = C._width_of(node)
                    except Exception:
                        w = 8.0
                    return C.Estimate(
                        float(est_map.get(node.fragment_id, 1.0)), w
                    )
                return super(_FragmentStats, sp)._estimate(node)

        return _FragmentStats(self.metadata, 1)

    def _estimate_fragments(
        self, fragments: List[PlanFragment], by_id
    ) -> Dict[int, float]:
        """Static estimated output rows per fragment — the *expected*
        side of the adaptive-replan comparison (OutputStatsEstimator's
        counterpart).  The seeded chaos site ``stats_estimate`` divides a
        fragment's estimate by its rule ``factor``, deterministically
        forcing the divergence the replan tests need."""
        if self.metadata is None:
            return {}
        est: Dict[int, float] = {}
        for f in sorted(fragments, key=lambda f: (f.id == 0, f.id)):
            sp = self._frag_stats(est, by_id)
            try:
                est[f.id] = float(sp.estimate(f.root).rows)
            except Exception:
                continue
            rule = self._injector.rules.get("stats_estimate")
            if rule is not None and self._injector.fires(
                "stats_estimate", key=f"fragment.{f.id}"
            ):
                factor = float(rule.get("factor", 10.0)) or 1.0
                est[f.id] = est[f.id] / factor
        return est

    def _maybe_replan(
        self,
        plan: P.PlanNode,
        f: PlanFragment,
        fragments: List[PlanFragment],
        by_id,
        est: Dict[int, float],
        committed: Dict[int, List[str]],
    ) -> Optional[P.PlanNode]:
        """The topology-CHANGING adaptive tier (AdaptivePlanner's
        partitioned/broadcast rule): when the just-committed fragment's
        observed output rows diverge from the static estimate by more
        than adaptive_replan_factor (either direction), re-cost the
        not-yet-run remainder with every observation substituted for its
        estimate; if that flips a pending inner join's build side across
        broadcast_join_threshold_rows, rewrite the ORIGINAL plan with the
        corrected Join.distribution and hand it back for
        re-fragmentation (committed stages are reused by signature)."""
        try:
            factor = float(
                self.properties.get("adaptive_replan_factor") or 0.0
            )
        except (TypeError, ValueError):
            return None
        if factor <= 0 or self.metadata is None:
            return None
        e = est.get(f.id)
        if e is None or e <= 0:
            return None
        o = max(float(self.output_rows.get(f.id, 0)), 1.0)
        if max(o / e, e / o) < factor:
            return None
        from ..config import BROADCAST_JOIN_THRESHOLD_ROWS

        try:
            threshold = int(
                self.properties.get("broadcast_join_threshold_rows")
                or BROADCAST_JOIN_THRESHOLD_ROWS
            )
        except (TypeError, ValueError):
            threshold = BROADCAST_JOIN_THRESHOLD_ROWS
        # corrected fragment estimates: observed rows where we have them,
        # re-derived estimates (over the corrected inputs) elsewhere
        corrected: Dict[int, float] = {}
        for g in sorted(fragments, key=lambda x: (x.id == 0, x.id)):
            if g.id in committed and g.id in self.output_rows:
                corrected[g.id] = max(float(self.output_rows[g.id]), 1.0)
            else:
                try:
                    corrected[g.id] = float(
                        self._frag_stats(corrected, by_id)
                        .estimate(g.root).rows
                    )
                except Exception:
                    corrected[g.id] = est.get(g.id, 1.0)
        sp_old = self._frag_stats(est, by_id)
        sp_new = self._frag_stats(corrected, by_id)
        for g in fragments:
            if g.id in committed:
                continue
            found = self._find_distribution_flip(
                g.root, sp_old, sp_new, threshold
            )
            if found is None:
                continue
            join, new_dist, old_rows, new_rows = found
            new_plan = self._flip_join_distribution(plan, join, new_dist)
            if new_plan is None:
                continue
            from ..utils.metrics import counter

            counter("trino_tpu_stats_replan_total").inc()
            self.adaptive_actions.append({
                "action": "flip_join_distribution",
                "fragment": g.id,
                "diverged_fragment": f.id,
                "estimated_rows": e,
                "observed_rows": o,
                "from": join.distribution,
                "to": new_dist,
                "build_rows_estimated": old_rows,
                "build_rows_corrected": new_rows,
            })
            return new_plan
        return None

    def _find_distribution_flip(
        self, root: P.PlanNode, sp_old, sp_new, threshold: int
    ):
        """First join under `root` whose corrected build-side rows land
        on the other side of the broadcast threshold from its planned
        distribution: (join, new_dist, old_rows, new_rows) or None."""
        found = None

        def walk(n: P.PlanNode):
            nonlocal found
            if found is not None:
                return
            if (
                isinstance(n, P.Join)
                and n.criteria
                and n.kind in ("inner", "left")
                and n.distribution in ("broadcast", "partitioned")
            ):
                try:
                    old_r = float(sp_old.estimate(n.right).rows)
                    new_r = float(sp_new.estimate(n.right).rows)
                except Exception:
                    old_r = new_r = None
                if new_r is not None:
                    if n.distribution == "broadcast" and new_r > threshold:
                        found = (n, "partitioned", old_r, new_r)
                        return
                    if (
                        n.distribution == "partitioned"
                        and new_r <= threshold
                        and old_r > threshold
                    ):
                        found = (n, "broadcast", old_r, new_r)
                        return
            for s in n.sources:
                walk(s)

        walk(root)
        return found

    def _flip_join_distribution(
        self, plan: P.PlanNode, join: P.Join, dist: str
    ) -> Optional[P.PlanNode]:
        """Rewrite the first Join in the ORIGINAL plan matching the
        fragment's copy (same kind/criteria/distribution — fragmentation
        preserves symbols) with the corrected distribution."""
        import dataclasses as dc

        hit = False

        def walk(n: P.PlanNode) -> P.PlanNode:
            nonlocal hit
            srcs = tuple(walk(s) for s in n.sources)
            if srcs and any(a is not b for a, b in zip(srcs, n.sources)):
                from ..plan.memo import _replace_sources

                n = _replace_sources(n, srcs)
            if (
                not hit
                and isinstance(n, P.Join)
                and n.kind == join.kind
                and n.criteria == join.criteria
                and n.distribution == join.distribution
            ):
                hit = True
                n = dc.replace(n, distribution=dist)
            return n

        try:
            new_plan = walk(plan)
        except Exception:
            return None
        return new_plan if hit else None

    def _start_attempt(
        self, query_id, f, task_index, attempt, frag_json, splits,
        out_buffers, committed, by_id, exclude_uri=None,
    ):
        """POST one attempt; returns (uri, task_id, sink).  exclude_uri
        steers a backup away from the straggling primary's worker."""
        workers = self.node_manager.alive()
        if not workers:
            raise SchedulerError("NO_NODES_AVAILABLE during retry")
        # quarantined nodes (device out, no CPU fallback) are skipped;
        # DEGRADED nodes stay eligible for retries — slow beats failed
        try:
            device = self.node_manager.device_states()
        except Exception:
            device = {}
        healthy = [
            w for w in workers
            if (device.get(w[0]) or {}).get("state") != "QUARANTINED"
        ] or workers
        candidates = [w for w in healthy if w[1] != exclude_uri] or healthy
        node_id, uri = candidates[(task_index + attempt) % len(candidates)]
        sink = self.exchange.sink(query_id, f.id, task_index, attempt)
        task_id = f"{query_id}.{f.id}.{task_index}.{attempt}"
        props = dict(self.properties)
        base_mem = props.get("query_max_memory_bytes")
        if base_mem and attempt:
            # re-try with exponentially grown memory
            # (ExponentialGrowthPartitionMemoryEstimator)
            props["query_max_memory_bytes"] = int(
                base_mem * (MEMORY_GROWTH_FACTOR ** attempt)
            )
        doc = {
            "fragment": frag_json,
            "splits": {
                str(k): [encode_value(s) for s in v]
                for k, v in splits.items()
            },
            "output": {
                "partitioning": f.output_partitioning,
                "keys": list(f.output_keys),
                "nbuffers": out_buffers,
            },
            "sources": self._sources_for(f, task_index, committed, by_id),
            "properties": props,
            "spool_path": sink.path,
        }
        # register before the POST: a worker that dies mid-dispatch may
        # have created the task without ever flushing the response, and
        # end-of-query cleanup must cover that half-created task too
        self._created_tasks.append((uri, task_id))
        _post_json(f"{uri}/v1/task/{task_id}", doc)
        if self.on_dispatch is not None:
            # WAL intent: this attempt now exists on a worker — a crashed
            # coordinator's replay knows work was in flight even if no
            # commit record ever follows
            try:
                self.on_dispatch(task_id, uri)
            except Exception:
                pass
        from ..utils.metrics import REGISTRY

        REGISTRY.counter(
            "trino_tpu_scheduler_dispatch_total",
            "Remote task creations dispatched to workers",
        ).inc()
        if attempt > 0:
            REGISTRY.counter(
                "trino_tpu_scheduler_retry_total",
                "Task attempts beyond the first (failover, backup, heal)",
            ).inc()
            from ..obs import journal

            journal.emit(
                journal.FTE_REASSIGN, query_id=query_id,
                task_id=task_id, node_id=node_id,
                severity=journal.WARN,
                attempt=attempt, uri=uri,
                excludedUri=str(exclude_uri or ""),
            )
        return uri, task_id, sink

    def _abort_task(self, uri, task_id):
        try:
            req = urllib.request.Request(
                f"{uri}/v1/task/{task_id}", method="DELETE"
            )
            urllib.request.urlopen(req, timeout=5.0).read()
        except Exception:
            pass

    def _run_task_with_retries(
        self, query_id, f, task_index, frag_json, splits, out_buffers,
        committed, by_id, sibling_times=None, pool=None, attempt_base=0,
    ) -> str:
        """Primary attempts with failover + at most one speculative backup
        per primary attempt; FIRST COMMITTED ATTEMPT WINS, the loser is
        aborted.  Backups run on daemon threads so neither the stage pool
        nor the retry loop ever blocks on a slow backup.  attempt_base > 0
        is the heal path re-running a producer whose earlier attempts'
        numbers (task ids + spool dirs) must never be reused."""
        speculate = bool(self.properties.get("speculative_execution", True))
        last_error = None
        # Monotonic attempt allocator: EVERY launched attempt (primary or
        # backup, finished or not) consumes a number, so a task_id / spool
        # dir {task}.{attempt} is never reused — a timed-out-but-running
        # backup can never collide with a later primary.
        next_attempt = attempt_base
        max_attempt = attempt_base + self.max_attempts
        backups: List[dict] = []  # {'done','path','duration','uri','task'}

        def backup_winner():
            for b in backups:
                if b["done"] and b["path"] is not None:
                    return b
            return None

        # after a failed attempt the next primary steers off that worker
        # (a device-lost task would otherwise land on the same sick node)
        failed_uri = None
        while next_attempt < max_attempt:
            attempt = next_attempt
            next_attempt += 1
            try:
                uri, task_id, sink = self._start_attempt(
                    query_id, f, task_index, attempt, frag_json, splits,
                    out_buffers, committed, by_id,
                    exclude_uri=failed_uri,
                )
            except SchedulerError:
                raise
            except Exception as e:
                last_error = e
                continue
            launched_backup = False
            poll_failures = 0
            t0 = time.time()
            try:
                while True:
                    state, polled = self._poll_task(uri, task_id)
                    if polled:
                        poll_failures = 0
                    else:
                        poll_failures += 1
                        if self._uri_gone(uri):
                            raise SchedulerError(
                                f"worker {uri} GONE (node lifecycle): "
                                "reassigning task to a survivor"
                            )
                        if poll_failures >= POLL_FAILURE_TOLERANCE:
                            raise SchedulerError(
                                f"worker {uri} lost (status polls failing)"
                            )
                    if state == "FINISHED":
                        break
                    if state is not None and state != "RUNNING":
                        raise SchedulerError(f"task {task_id} {state}")
                    if time.time() - t0 > self.task_timeout:
                        raise SchedulerError(f"task {task_id} timed out")
                    win = backup_winner()
                    if win is not None:
                        self._abort_task(uri, task_id)
                        if sibling_times is not None:
                            sibling_times.append(win["duration"])
                        return win["path"]
                    if (
                        speculate
                        and not launched_backup
                        and next_attempt < max_attempt
                        and sibling_times
                        and self.straggler.should_hedge(
                            time.time() - t0, list(sibling_times)
                        )
                    ):
                        launched_backup = True
                        self.straggler.record_hedge(
                            f.id, task_id, uri,
                            time.time() - t0, list(sibling_times),
                        )
                        battempt = next_attempt
                        next_attempt += 1
                        b = {"done": False, "path": None, "duration": 0.0,
                             "uri": None, "task": None}
                        backups.append(b)

                        def run_backup(b=b, battempt=battempt,
                                       primary_uri=uri):
                            bt0 = time.time()
                            try:
                                buri, btid, bsink = self._start_attempt(
                                    query_id, f, task_index, battempt,
                                    frag_json, splits, out_buffers,
                                    committed, by_id,
                                    exclude_uri=primary_uri,
                                )
                                b["uri"], b["task"] = buri, btid
                                self._await_task(buri, btid)
                                if bsink.committed:
                                    b["path"] = bsink.path
                            except Exception:
                                pass
                            finally:
                                b["duration"] = time.time() - bt0
                                b["done"] = True

                        threading.Thread(
                            target=run_backup, daemon=True
                        ).start()
                    time.sleep(POLL_INTERVAL)
                if not sink.committed:
                    raise SchedulerError(
                        f"task {task_id} finished without committing spool"
                    )
                # winning attempt: pull its TaskInfo stats (operator
                # frames ride "operatorStats") for the query timeline
                try:
                    with urllib.request.urlopen(
                        f"{uri}/v1/task/{task_id}", timeout=5.0
                    ) as resp:
                        info = json.loads(resp.read())
                    self.task_stats.append({
                        "taskId": task_id, "uri": uri,
                        "stats": info.get("stats") or {},
                    })
                except Exception:
                    pass
                # primary won: abort any still-running backup (frees the
                # worker; the loser's spool dir is never read)
                for b in backups:
                    if not b["done"] and b["uri"]:
                        self._abort_task(b["uri"], b["task"])
                if sibling_times is not None:
                    sibling_times.append(time.time() - t0)
                return sink.path
            except Exception as e:
                last_error = e
                failed_uri = uri
                win = backup_winner()
                if win is not None:
                    return win["path"]
                corrupt = _corrupt_spool_path(e)
                if corrupt is not None:
                    # an UPSTREAM committed attempt failed its CRCs: this
                    # consumer cannot succeed until the producer is healed
                    # — decommit + re-run it, then retry the consumer
                    # against the spliced-in fresh spool path
                    self._heal_corrupt_spool(corrupt)
                # never block on a pending backup — it stays in the race;
                # the next primary draws a fresh number from next_attempt
                continue
        # primaries exhausted: grant outstanding backups a bounded grace
        deadline = time.time() + 30.0
        while time.time() < deadline and any(
            not b["done"] for b in backups
        ):
            win = backup_winner()
            if win is not None:
                return win["path"]
            time.sleep(POLL_INTERVAL)
        win = backup_winner()
        if win is not None:
            return win["path"]
        raise SchedulerError(
            f"task {query_id}.{f.id}.{task_index} failed after "
            f"{self.max_attempts} attempts: {last_error}"
        )

    def _heal_corrupt_spool(self, path: str) -> bool:
        """Retire the corrupt committed attempt owning `path` and re-run
        its producer task under fresh attempt numbers, splicing the new
        spool dir into the committed list every consumer reads.  Returns
        True once the producer is healthy again (including when a
        concurrent consumer got there first); False when the path doesn't
        map to a healable stage."""
        # path: {base}/{query}/{fragment}/{task}.{attempt}/buffer_{id}.bin
        attempt_dir = os.path.dirname(os.path.abspath(path))
        frag_dir = os.path.dirname(attempt_dir)
        task_s, _, attempt_s = os.path.basename(attempt_dir).partition(".")
        ctx = self._heal_ctx.get(frag_dir)
        try:
            task_index = int(task_s)
        except ValueError:
            return False
        if ctx is None:
            return False
        (f, frag_json, per_task_splits, out_buffers, paths,
         epoch_qid, epoch_committed, epoch_by_id) = ctx
        if task_index >= len(paths):
            return False
        with self._heal_lock:
            if os.path.abspath(paths[task_index]) != attempt_dir:
                return True  # another consumer already healed this one
            SpoolHandle(attempt_dir).decommit()
            # fresh attempt numbers: above every attempt dir ever created
            # for this task — task ids must not be reused (the worker's
            # create_or_update is idempotent and would hand back the old
            # task instead of re-running it)
            used = [int(attempt_s)] if attempt_s.isdigit() else []
            try:
                for d in os.listdir(frag_dir):
                    t, _, a = d.partition(".")
                    if t == task_s and a.isdigit():
                        used.append(int(a))
            except OSError:
                pass
            attempt_base = max(used, default=-1) + 1
            new_path = self._run_task_with_retries(
                epoch_qid, f, task_index, frag_json,
                per_task_splits[task_index], out_buffers, epoch_committed,
                epoch_by_id, attempt_base=attempt_base,
            )
            paths[task_index] = new_path
            self.heal_actions.append({
                "action": "respawn_corrupt_attempt",
                "fragment": f.id,
                "task": task_index,
                "corrupt_path": attempt_dir,
                "healed_path": new_path,
            })
            from ..obs import journal

            journal.emit(
                journal.SPOOL_HEAL, query_id=epoch_qid,
                task_id=f"{epoch_qid}.{f.id}.{task_index}",
                severity=journal.WARN,
                fragment=f.id, corruptPath=attempt_dir,
                healedPath=new_path,
            )
            return True

    def _uri_gone(self, uri: str) -> bool:
        """True when the node manager has declared the attempt's host
        GONE: the poll-failure tolerance (meant for GC pauses and slow
        responses) is skipped and the attempt fails over immediately,
        reusing every already-committed upstream spool."""
        fn = getattr(self.node_manager, "gone_uris", None)
        if fn is None:
            return False
        try:
            return uri in fn()
        except Exception:
            return False

    def _poll_task(self, uri: str, task_id: str):
        """One status poll: (state, reachable) — state None while running
        or on a transient poll failure."""
        try:
            with urllib.request.urlopen(
                f"{uri}/v1/task/{task_id}", timeout=5.0
            ) as resp:
                doc = json.loads(resp.read())
        except (urllib.error.URLError, ConnectionError, OSError):
            return None, False
        state = doc.get("state")
        if state == "FINISHED":
            return "FINISHED", True
        if state in ("FAILED", "ABORTED", "CANCELED"):
            return f"{state}: {doc.get('error')}", True
        return None, True

    def _await_task(self, uri: str, task_id: str):
        deadline = time.time() + TASK_TIMEOUT
        consecutive_failures = 0
        while time.time() < deadline:
            try:
                with urllib.request.urlopen(
                    f"{uri}/v1/task/{task_id}", timeout=5.0
                ) as resp:
                    doc = json.loads(resp.read())
                consecutive_failures = 0
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                # tolerate transient poll blips (a stalled worker thread is
                # not a dead worker); ContinuousTaskStatusFetcher backoff
                consecutive_failures += 1
                if self._uri_gone(uri):
                    raise SchedulerError(
                        f"worker {uri} GONE (node lifecycle): {e}"
                    )
                if consecutive_failures >= POLL_FAILURE_TOLERANCE:
                    raise SchedulerError(f"worker {uri} lost: {e}")
                time.sleep(0.2)
                continue
            state = doc.get("state")
            if state == "FINISHED":
                return
            if state in ("FAILED", "ABORTED", "CANCELED"):
                raise SchedulerError(
                    f"task {task_id} {state}: {doc.get('error')}"
                )
            time.sleep(POLL_INTERVAL)
        raise SchedulerError(f"task {task_id} timed out")
