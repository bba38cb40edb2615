"""Out-of-core (spilled) execution: split batches on the device, host
memory as the spill tier.

Counterpart of trino_tpu/exec/spill.py, copied: the plans and the host
merges are the JAX package's, and every batch runs through the port's
FragmentExecutor on the card.  Reference parity: spiller/
(FileSingleStreamSpiller feeding SpillableHashAggregationBuilder ->
MergingHashAggregationBuilder) triggered by
memory/MemoryRevokingScheduler.java:47 when revocable memory exceeds the
pool.  The reference serializes state to local disk; here the device is
the scarce tier and host memory the spill target:

  - aggregation: scan splits run in batches sized to the limit, each
    batch's PARTIAL accumulator page stays on the host, and one FINAL /
    INTERMEDIATE merge runs over them (the kernels of the distributed
    merge);
  - join: both sides evaluated batch-wise, co-partitioned by key hash on
    the host, one device join per partition;
  - sort: device-sorted batches merged by one stable host lexsort;
  - window: rows hash-partitioned by the PARTITION BY keys, the window
    run per partition;
  - DISTINCT: grouped queries partition by the GROUP BY keys and run the
    original single-step aggregate per partition; global count(DISTINCT)
    unions the batches' deduped values on the host.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..plan import nodes as P
from .scan import merge_pages_to_arrays, table_scans

SPILL_SOURCE_ID = -1  # RemoteSource id for in-process spilled partials
SAFETY_FACTOR = 4  # batch working-set headroom under the limit


def find_spillable_aggregate(
    plan: P.Output,
) -> Optional[Tuple[P.Aggregate, P.TableScan]]:
    """Match a plan whose (unique) Aggregate sits over a pure scan chain
    (Filter/Project only down to one TableScan) and is partializable.
    Anything above the Aggregate is fine — it runs after the merge."""
    found: List[P.Aggregate] = []

    def find_agg(n: P.PlanNode):
        if isinstance(n, P.Aggregate):
            found.append(n)
            return
        for s in n.sources:
            find_agg(s)

    find_agg(plan)
    if len(found) != 1:
        return None
    agg = found[0]
    if agg.step not in ("single", "partial"):
        return None
    if not all(a.partializable for a in agg.aggs):
        return None
    node = agg.source
    while isinstance(node, (P.Filter, P.Project)):
        node = node.source
    if not isinstance(node, P.TableScan):
        return None
    # the aggregate's scan must be the plan's only scan: the rewritten plan
    # replaces the whole scan chain, so remaining scans would lose their
    # split assignment
    if len(table_scans(plan)) != 1:
        return None
    return agg, node


def scan_row_bytes(scan: P.TableScan) -> int:
    return sum(t.np_dtype.itemsize + 1 for _, t in scan.types)


def _replace_aggregate(
    node: P.PlanNode, agg: P.Aggregate, replacement: P.PlanNode
) -> P.PlanNode:
    if node is agg:
        return replacement
    new_sources = tuple(
        _replace_aggregate(s, agg, replacement) for s in node.sources
    )
    if all(a is b for a, b in zip(new_sources, node.sources)):
        return node
    import dataclasses

    if isinstance(node, P.SetOperation):
        return dataclasses.replace(node, inputs=new_sources)
    # other plan nodes hold their sources as individual PlanNode fields in
    # declaration order matching .sources
    updates = {}
    src_iter = iter(new_sources)
    for f in dataclasses.fields(node):
        if isinstance(getattr(node, f.name), P.PlanNode):
            updates[f.name] = next(src_iter)
    return dataclasses.replace(node, **updates)


def execute_spilled_aggregation(
    executor,  # LocalExecutor or FragmentExecutor (late import cycle)
    plan: P.Output,
    agg: P.Aggregate,
    scan: P.TableScan,
    splits: List,
    batch_size: int,
):
    """Run the scan->partial-agg pipeline per split batch, keep partial
    pages on host, then run the rewritten plan (Aggregate replaced by a
    merge over the spilled partials)."""
    from .fragment_exec import FragmentExecutor

    partial = P.Aggregate(agg.source, agg.keys, agg.aggs, "partial")
    syms = tuple(partial.output_symbols())
    partial_plan = P.Output(partial, syms, syms)

    # the plan's only scan is preorder index 0 in both the original fragment
    # and the partial subplan, so collected dynamic filters carry over
    dyn_filters = getattr(executor, "dynamic_filters", None)
    orig_remote = dict(getattr(executor, "remote_pages", {}) or {})

    partial_pages = []
    rows_pruned = 0
    scan_bytes = 0
    batch_config = dict(executor.config)
    batch_config.pop("memory_limit_bytes", None)  # batches are pre-sized
    # and so is their device tier: the JAX package keeps the session's
    # manager here, whose device reservation then estimates the whole
    # table for every batch and refuses it (the other spills drop it)
    batch_config.pop("memory_manager", None)
    for start in range(0, max(len(splits), 1), batch_size):
        batch = splits[start : start + batch_size]
        sub = FragmentExecutor(
            executor.catalogs, batch_config, {0: batch}, orig_remote,
            dyn_filters,
        )
        partial_pages.append(sub.execute(partial_plan))
        rows_pruned += sub.df_rows_pruned
        scan_bytes += sub.scan_bytes

    merged_step = "final" if agg.step == "single" else "intermediate"
    rs = P.RemoteSource(
        SPILL_SOURCE_ID, syms, tuple(partial.output_types().items())
    )
    merged = P.Aggregate(rs, agg.keys, agg.aggs, merged_step)
    rewritten = _replace_aggregate(plan, agg, merged)

    # the rewritten plan has no TableScan (single-scan precondition) but may
    # still hold RemoteSources above the aggregate (e.g. a broadcast build
    # side of a join over the agg) — keep the fragment's original pages
    merged_remote = dict(orig_remote)
    merged_remote[SPILL_SOURCE_ID] = partial_pages
    final_ex = FragmentExecutor(
        executor.catalogs, batch_config, {}, merged_remote
    )
    page = final_ex.execute(rewritten)
    # surface batch stats on the outer executor (task info reporting)
    executor.df_rows_pruned = rows_pruned
    executor.scan_bytes = scan_bytes
    return page


def plan_spill(
    executor,
    plan: P.Output,
    memory_limit: int,
) -> Optional[Tuple[P.Aggregate, P.TableScan, List, int]]:
    """Decide whether to spill: returns (agg, scan, splits, batch_size) when
    the estimated scan working set exceeds the limit (the same threshold
    _account_memory enforces) and the plan shape allows out-of-core
    aggregation.  Batches are sized to limit/SAFETY_FACTOR so each batch
    plus kernel temporaries stays under the limit."""
    match = find_spillable_aggregate(plan)
    if match is None:
        return None
    agg, scan = match
    conn = executor.catalogs.get(scan.catalog)
    est_table = conn.metadata().get_table_statistics(
        scan.table
    ).row_count * scan_row_bytes(scan)
    batch_budget = max(memory_limit // SAFETY_FACTOR, 1)

    splits_map: Dict[int, List] = getattr(executor, "splits_by_scan", None)
    if splits_map is not None:
        # fragment executor: this task's assigned splits of the (single,
        # preorder-index-0) scan
        splits = splits_map.get(0, [])
        if not splits:
            return None
        est = est_table * len(splits) / max(splits[0].total, 1)
        if est <= memory_limit:
            return None
        per_split = est / len(splits)
        batch = max(1, int(batch_budget / max(per_split, 1)))
        if batch >= len(splits):
            return None
        return agg, scan, splits, batch
    if est_table <= memory_limit:
        return None
    nbatches = math.ceil(est_table / batch_budget)
    splits = conn.split_manager().get_splits(
        scan.table, nbatches, scan.constraint
    )
    if len(splits) <= 1:
        return None
    return agg, scan, splits, max(1, len(splits) // nbatches)


# ---------------------------------------------------------------------
# Join / sort / window out-of-core execution (round 2).
#
# Reference parity: operator/join/HashBuilderOperator.java:162-182
# (SPILLING_INPUT state machine over spiller/GenericPartitioningSpiller),
# OrderByOperator's spillable PagesIndex, and window partition spill —
# all triggered by execution/MemoryRevokingScheduler.java:47.
#
# TPU-native redesign: host RAM is the spill tier (HBM<->host DMA is the
# new "disk").  Each input side is evaluated split-batch-wise on device
# and its result pages retained on host; joins then co-partition both
# sides by key hash (the partitioned lookup join) and run one device join
# per partition; sorts merge device-sorted runs host-side; windows run
# per hash-partition-batch of their PARTITION BY keys.

JOIN_LEFT_ID = -2
JOIN_RIGHT_ID = -3
JOIN_OUT_ID = -4
SORT_RUNS_ID = -5
WINDOW_SRC_ID = -6
DISTINCT_SRC_ID = -7


def _is_scan_chain(node: P.PlanNode) -> Optional[P.TableScan]:
    while isinstance(node, (P.Filter, P.Project)):
        node = node.source
    return node if isinstance(node, P.TableScan) else None


def _single(plan: P.Output, node_type) -> Optional[P.PlanNode]:
    found: List[P.PlanNode] = []

    def walk(n: P.PlanNode):
        if isinstance(n, node_type):
            found.append(n)
        for s in n.sources:
            walk(s)

    walk(plan)
    return found[0] if len(found) == 1 else None


def _est_side(executor, scan: P.TableScan) -> float:
    conn = executor.catalogs.get(scan.catalog)
    stats = conn.metadata().get_table_statistics(scan.table)
    return stats.row_count * scan_row_bytes(scan)


def _spill_ctx(executor):
    """Config + carried-over state for spill sub-executors: the spill
    framework owns memory, and the outer fragment's exchange pages /
    dynamic filters must stay visible (a RemoteSource above the spilled
    node would otherwise silently read zero rows)."""
    cfg = dict(executor.config)
    cfg.pop("memory_limit_bytes", None)
    cfg.pop("memory_manager", None)
    orig_remote = dict(getattr(executor, "remote_pages", {}) or {})
    dyn = getattr(executor, "dynamic_filters", None)
    return cfg, orig_remote, dyn


def _side_pages(executor, side: P.PlanNode, scan: P.TableScan,
                memory_limit: int):
    """Evaluate one input side per split batch on device; pages stay on
    host (the spill tier)."""
    from .fragment_exec import FragmentExecutor

    syms = tuple(side.output_symbols())
    side_plan = P.Output(side, syms, syms)
    conn = executor.catalogs.get(scan.catalog)
    est = _est_side(executor, scan)
    batch_budget = max(memory_limit // SAFETY_FACTOR, 1)
    nbatches = max(1, math.ceil(est / batch_budget))
    splits = conn.split_manager().get_splits(
        scan.table, nbatches, scan.constraint
    )
    batch = max(1, len(splits) // nbatches)
    cfg, orig_remote, dyn = _spill_ctx(executor)
    pages = []
    for start in range(0, len(splits), batch):
        sub = FragmentExecutor(
            executor.catalogs, cfg, {0: splits[start : start + batch]},
            orig_remote, dyn,
        )
        pages.append(sub.execute(side_plan))
    return pages, syms, tuple(side.output_types().items())


def plan_join_spill(executor, plan: P.Output, memory_limit: int):
    """Out-of-core partitioned join: both inputs are scan chains whose
    combined estimate exceeds the memory limit."""
    join = _single(plan, P.Join)
    if join is None or join.kind not in ("inner", "left") or not join.criteria:
        return None
    lscan = _is_scan_chain(join.left)
    rscan = _is_scan_chain(join.right)
    if lscan is None or rscan is None:
        return None
    if len(table_scans(plan)) != 2:
        return None
    est = _est_side(executor, lscan) + _est_side(executor, rscan)
    if est <= memory_limit:
        return None
    npart = max(2, math.ceil(est * 2 / memory_limit))
    return (join, lscan, rscan, npart)


def execute_spilled_join(executor, plan, join, lscan, rscan, npart):
    """Phase 1: evaluate + host-partition both sides by key hash
    (GenericPartitioningSpiller).  Phase 2: one device join per partition
    (partition-restore of HashBuilderOperator).  Phase 3: the plan above
    the join runs over the spilled join output."""
    import dataclasses

    from ..exec.partitioner import partition_page
    from .fragment_exec import FragmentExecutor

    limit = int(executor.config.get("memory_limit_bytes"))
    lkeys = [l for l, _ in join.criteria]
    rkeys = [r for _, r in join.criteria]

    lparts: List[List] = [[] for _ in range(npart)]
    rparts: List[List] = [[] for _ in range(npart)]
    for side, scan, keys, parts in (
        (join.left, lscan, lkeys, lparts),
        (join.right, rscan, rkeys, rparts),
    ):
        pages, _, _ = _side_pages(executor, side, scan, limit)
        for page in pages:
            for p, sub in enumerate(partition_page(page, keys, npart)):
                if sub.count:
                    parts[p].append(sub)

    lsyms = tuple(join.left.output_symbols())
    rsyms = tuple(join.right.output_symbols())
    ltypes = tuple(join.left.output_types().items())
    rtypes = tuple(join.right.output_types().items())
    jsyms = tuple(join.output_symbols())
    jtypes = tuple(join.output_types().items())
    part_join = dataclasses.replace(
        join,
        left=P.RemoteSource(JOIN_LEFT_ID, lsyms, ltypes),
        right=P.RemoteSource(JOIN_RIGHT_ID, rsyms, rtypes),
    )
    jplan = P.Output(part_join, jsyms, jsyms)
    cfg, orig_remote, dyn = _spill_ctx(executor)
    join_pages = []
    for p in range(npart):
        if not lparts[p]:
            continue
        if not rparts[p] and join.kind != "left":
            continue
        remote = dict(orig_remote)
        remote[JOIN_LEFT_ID] = lparts[p]
        remote[JOIN_RIGHT_ID] = rparts[p]
        sub = FragmentExecutor(executor.catalogs, cfg, {}, remote, dyn)
        page = sub.execute(jplan)
        if page.count:
            join_pages.append(page)

    rewritten = _replace_aggregate(
        plan, join, P.RemoteSource(JOIN_OUT_ID, jsyms, jtypes)
    )
    merged_remote = dict(orig_remote)
    merged_remote[JOIN_OUT_ID] = join_pages
    final = FragmentExecutor(
        executor.catalogs, cfg, {}, merged_remote, dyn
    )
    return final.execute(rewritten)


def plan_sort_spill(executor, plan: P.Output, memory_limit: int):
    sort = _single(plan, P.Sort)
    if sort is None:
        return None
    scan = _is_scan_chain(sort.source)
    if scan is None or _single(plan, P.TableScan) is None:
        return None
    if _est_side(executor, scan) <= memory_limit:
        # the scan side fits, but reserve-before-dispatch gates on the
        # whole compiled program (devgen temporaries included) — spill
        # rather than let the in-core path fail its HBM reservation
        from .streaming import estimate_program_bytes

        if estimate_program_bytes(executor, plan) <= memory_limit:
            return None
    return (sort, scan)


def execute_spilled_sort(executor, plan, sort, scan):
    """Device-sorted runs merged HOST-side (FileSingleStreamSpiller +
    MergeOperator roles): each split batch sorts on device, the final
    total order comes from one stable host lexsort over the concatenated
    runs' transformed keys — device memory never holds more than a batch.
    Cross-batch varchar dictionaries are UNIFIED by merge_pages_to_arrays
    (codes remapped) before any rank transform."""
    import numpy as np

    from ..page import Column, Page
    from .fragment_exec import FragmentExecutor

    limit = int(executor.config.get("memory_limit_bytes"))
    syms = tuple(sort.output_symbols())
    types_map = sort.output_types()
    pages, _, _ = _side_pages(
        executor, P.Sort(sort.source, sort.keys), scan, limit
    )
    dicts: Dict[str, object] = {}
    merged, total = merge_pages_to_arrays(
        pages, list(syms), [(s, types_map[s]) for s in syms], dicts
    )
    # host lexsort: last key is primary
    lex = []
    for k in reversed(sort.keys):
        vals, oks = merged[k.column]
        if oks is None:
            oks = np.ones(total, bool)
        d = dicts.get(k.column)
        if d is not None:
            # dictionary codes -> DENSE lexicographic ranks (duplicate
            # values under distinct codes must tie so later keys apply)
            dd = np.asarray(d).astype(str)
            order = np.argsort(dd, kind="stable")
            sd = dd[order]
            dense = np.zeros(len(order), dtype=np.int64)
            if len(order) > 1:
                dense[1:] = np.cumsum(sd[1:] != sd[:-1])
            rank = np.empty(len(order), dtype=np.int64)
            rank[order] = dense
            safe = np.clip(vals, 0, max(len(order) - 1, 0)).astype(np.int64)
            v = rank[safe]
        else:
            v = vals
        if v.ndim == 2:
            # wide (two-limb) decimal key: minor operand = low limb in
            # unsigned order (sign bit flipped into the signed domain),
            # major = signed high limb; DESC complements both
            lo = v[:, 0].astype(np.int64) ^ np.int64(-(2**63))
            hi = v[:, 1].astype(np.int64)
            if not k.ascending:
                lo, hi = ~lo, ~hi
            lex.append(lo)
            lex.append(hi)
        else:
            if not k.ascending:
                # ints reverse via bitwise complement (negation wraps at
                # INT64_MIN, so it would sort first under DESC); floats
                # negate
                v = -v if v.dtype.kind == "f" else ~v.astype(np.int64)
            lex.append(v)
        nullbit = ~oks if not k.nulls_first else oks
        lex.append(nullbit)
    idx = np.lexsort(lex) if lex else np.arange(total)
    cols = []
    for sym in syms:
        vals, oks = merged[sym]
        if oks is None:
            oks = np.ones(total, bool)
        cols.append(
            Column(
                types_map[sym], vals[idx],
                None if oks.all() else oks[idx],
                dicts.get(sym),
            )
        )
    sorted_page = Page(cols, total, list(syms))
    if plan.source is sort:
        # nothing above the sort: emit the merged page directly instead of
        # round-tripping the full result through device memory
        out_cols = [
            sorted_page.columns[syms.index(s)] for s in plan.symbols
        ]
        return Page(out_cols, total, list(plan.names))
    cfg, orig_remote, dyn = _spill_ctx(executor)
    rewritten = _replace_aggregate(
        plan, sort,
        P.RemoteSource(SORT_RUNS_ID, syms, tuple(types_map.items())),
    )
    merged_remote = dict(orig_remote)
    merged_remote[SORT_RUNS_ID] = [sorted_page]
    final = FragmentExecutor(
        executor.catalogs, cfg, {}, merged_remote, dyn
    )
    return final.execute(rewritten)


def plan_window_spill(executor, plan: P.Output, memory_limit: int):
    win = _single(plan, P.Window)
    if win is None or not win.partition_by:
        return None
    scan = _is_scan_chain(win.source)
    if scan is None or _single(plan, P.TableScan) is None:
        return None
    est = _est_side(executor, scan)
    if est <= memory_limit:
        from .streaming import estimate_program_bytes

        if estimate_program_bytes(executor, plan) <= memory_limit:
            return None
        est = max(est, float(memory_limit))
    npart = max(2, math.ceil(est * 2 / memory_limit))
    return (win, scan, npart)


def execute_spilled_window(executor, plan, win, scan, npart):
    """Hash-partition rows by PARTITION BY keys host-side, run the window
    per partition batch on device (window partitions never straddle hash
    partitions), concatenate outputs."""
    import dataclasses

    from ..exec.partitioner import partition_page
    from .fragment_exec import FragmentExecutor

    limit = int(executor.config.get("memory_limit_bytes"))
    pages, syms, types_ = _side_pages(executor, win.source, scan, limit)
    parts: List[List] = [[] for _ in range(npart)]
    for page in pages:
        for p, sub in enumerate(
            partition_page(page, list(win.partition_by), npart)
        ):
            if sub.count:
                parts[p].append(sub)
    wsyms = tuple(win.output_symbols())
    wtypes = tuple(win.output_types().items())
    win_sub = dataclasses.replace(
        win, source=P.RemoteSource(WINDOW_SRC_ID, syms, types_)
    )
    wplan = P.Output(win_sub, wsyms, wsyms)
    cfg, orig_remote, dyn = _spill_ctx(executor)
    out_pages = []
    for p in range(npart):
        if not parts[p]:
            continue
        remote = dict(orig_remote)
        remote[WINDOW_SRC_ID] = parts[p]
        sub = FragmentExecutor(executor.catalogs, cfg, {}, remote, dyn)
        page = sub.execute(wplan)
        if page.count:
            out_pages.append(page)
    rewritten = _replace_aggregate(
        plan, win, P.RemoteSource(JOIN_OUT_ID, wsyms, wtypes)
    )
    merged_remote = dict(orig_remote)
    merged_remote[JOIN_OUT_ID] = out_pages
    final = FragmentExecutor(
        executor.catalogs, cfg, {}, merged_remote, dyn
    )
    return final.execute(rewritten)


def plan_distinct_spill(executor, plan: P.Output, memory_limit: int):
    """Out-of-core DISTINCT aggregation — the LOCAL analog of the mesh
    path's hash repartition by grouping keys: a single-step Aggregate
    carrying distinct aggregates over a scan chain whose working set
    exceeds the limit.  GROUP BY queries hash-partition rows by their
    grouping keys (groups never straddle partitions, so per-partition
    single-step aggregation is exact for ANY aggregate, distinct
    included); global queries spill per-argument distinct state to host
    arrays and count it there."""
    agg = _single(plan, P.Aggregate)
    if agg is None or agg.step != "single":
        return None
    if not any(a.distinct for a in agg.aggs):
        return None
    scan = _is_scan_chain(agg.source)
    if scan is None or _single(plan, P.TableScan) is None:
        return None
    if getattr(executor, "splits_by_scan", None) is not None:
        # fragment task: the distributed planner already hash-partitions
        # distinct aggregation across tasks; this rewrite re-enumerates
        # whole-table splits and would double-count another task's rows
        return None
    if not agg.keys:
        # global: only count(DISTINCT x) reduces to host-side uniques;
        # the remaining aggs must merge through partial/final kernels
        for a in agg.aggs:
            if a.distinct and (
                a.kind != "count" or a.arg is None or a.arg2 is not None
            ):
                return None
            if not a.distinct and not a.partializable:
                return None
    est = _est_side(executor, scan)
    if est <= memory_limit:
        from .streaming import estimate_program_bytes

        if estimate_program_bytes(executor, plan) <= memory_limit:
            return None
        est = max(est, float(memory_limit))
    npart = max(2, math.ceil(est * 2 / memory_limit))
    return (agg, scan, npart)


def _host_distinct_count(pages, sym, typ):
    """Union per-batch deduped pages (the spilled distinct state) in host
    arrays and count distinct non-null values.  Varchar compares by STRING
    VALUE, not dictionary code — batches may dictionary-encode the same
    string under different codes, and merge_pages_to_arrays only unifies
    (it does not dedup) the merged dictionary."""
    import numpy as np

    dicts: Dict[str, object] = {}
    merged, total = merge_pages_to_arrays(pages, [sym], [(sym, typ)], dicts)
    vals, oks = merged[sym]
    if oks is not None:
        vals = vals[oks] if vals.ndim == 1 else vals[oks, :]
    d = dicts.get(sym)
    if d is not None:
        safe = np.clip(vals, 0, max(len(d) - 1, 0)).astype(np.int64)
        return int(len(np.unique(np.asarray(d).astype(str)[safe])))
    if vals.ndim == 2:  # wide decimal: a value is its (lo, hi) limb pair
        return int(len(np.unique(vals, axis=0)))
    return int(len(np.unique(vals)))


def execute_spilled_distinct(executor, plan, agg, scan, npart):
    """Grouped: hash-partition rows by GROUP BY keys host-side, run the
    ORIGINAL single-step aggregate (distinct and all) per partition —
    groups are disjoint across partitions so concatenation is exact.
    Global: per split batch run a device Distinct over each
    count(DISTINCT) argument; the batches' deduped values are the spilled
    distinct state, unioned and counted in host arrays, while any
    non-distinct aggs merge through the ordinary partial/final spill."""
    import dataclasses

    from ..expr import ir
    from ..page import Page, column_from_pylist
    from .fragment_exec import FragmentExecutor

    limit = int(executor.config.get("memory_limit_bytes"))
    cfg, orig_remote, dyn = _spill_ctx(executor)
    syms = tuple(agg.output_symbols())
    types_map = agg.output_types()

    if agg.keys:
        from ..exec.partitioner import partition_page

        pages, src_syms, src_types = _side_pages(
            executor, agg.source, scan, limit
        )
        parts: List[List] = [[] for _ in range(npart)]
        for page in pages:
            for p, sub in enumerate(
                partition_page(page, list(agg.keys), npart)
            ):
                if sub.count:
                    parts[p].append(sub)
        agg_sub = dataclasses.replace(
            agg,
            source=P.RemoteSource(DISTINCT_SRC_ID, src_syms, src_types),
        )
        aplan = P.Output(agg_sub, syms, syms)
        out_pages = []
        for p in range(npart):
            if not parts[p]:
                continue
            remote = dict(orig_remote)
            remote[DISTINCT_SRC_ID] = parts[p]
            sub = FragmentExecutor(executor.catalogs, cfg, {}, remote, dyn)
            page = sub.execute(aplan)
            if page.count:
                out_pages.append(page)
    else:
        conn = executor.catalogs.get(scan.catalog)
        batch_budget = max(limit // SAFETY_FACTOR, 1)
        nbatches = max(
            1, math.ceil(_est_side(executor, scan) / batch_budget)
        )
        splits = conn.split_manager().get_splits(
            scan.table, nbatches, scan.constraint
        )
        batch = max(1, len(splits) // nbatches)
        src_types = agg.source.output_types()
        d_cols = sorted({a.arg for a in agg.aggs if a.distinct})
        state: Dict[str, List[Page]] = {c: [] for c in d_cols}
        dplans = {
            c: P.Output(
                P.Distinct(
                    P.Project(
                        agg.source,
                        ((c, ir.ColumnRef(src_types[c], c)),),
                    )
                ),
                (c,), (c,),
            )
            for c in d_cols
        }
        for start in range(0, max(len(splits), 1), batch):
            bsplits = splits[start : start + batch]
            for c in d_cols:
                sub = FragmentExecutor(
                    executor.catalogs, cfg, {0: bsplits}, orig_remote, dyn
                )
                state[c].append(sub.execute(dplans[c]))
        counts = {
            c: _host_distinct_count(state[c], c, src_types[c])
            for c in d_cols
        }
        nd_aggs = tuple(a for a in agg.aggs if not a.distinct)
        nd_page = None
        if nd_aggs:
            # the remaining (partializable) aggs merge through the same
            # partial/final kernels the exchange uses, per split batch
            nd_partial = P.Aggregate(agg.source, (), nd_aggs, "partial")
            psyms = tuple(nd_partial.output_symbols())
            pplan = P.Output(nd_partial, psyms, psyms)
            partial_pages = []
            for start in range(0, max(len(splits), 1), batch):
                sub = FragmentExecutor(
                    executor.catalogs, cfg,
                    {0: splits[start : start + batch]}, orig_remote, dyn,
                )
                partial_pages.append(sub.execute(pplan))
            nd_final = P.Aggregate(
                P.RemoteSource(
                    SPILL_SOURCE_ID, psyms,
                    tuple(nd_partial.output_types().items()),
                ),
                (), nd_aggs, "final",
            )
            nd_syms = tuple(nd_final.output_symbols())
            remote = dict(orig_remote)
            remote[SPILL_SOURCE_ID] = partial_pages
            sub = FragmentExecutor(executor.catalogs, cfg, {}, remote, dyn)
            nd_page = sub.execute(P.Output(nd_final, nd_syms, nd_syms))
        cols = []
        for a in agg.aggs:
            if a.distinct:
                cols.append(
                    column_from_pylist(a.output_type, [counts[a.arg]])
                )
            else:
                cols.append(nd_page.by_name(a.output))
        out_pages = [Page(cols, 1, list(syms))]

    rewritten = _replace_aggregate(
        plan, agg, P.RemoteSource(JOIN_OUT_ID, syms, tuple(types_map.items()))
    )
    merged_remote = dict(orig_remote)
    merged_remote[JOIN_OUT_ID] = out_pages
    final = FragmentExecutor(
        executor.catalogs, cfg, {}, merged_remote, dyn
    )
    return final.execute(rewritten)
