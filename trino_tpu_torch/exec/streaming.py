"""Streaming (bounded-working-set) local execution.

Counterpart of trino_tpu/exec/streaming.py.  Reference parity: the
reference's worker runtime streams (operator/Driver.java:372 moves
bounded Pages through the operator chain,
ScanFilterAndProjectOperator.java:190 pulls split by split), so one node
can scan a table far bigger than its memory.

The streaming unit is a tile of splits sized to the device budget, and
the carried state is the PARTIAL page state the distributed path ships
between workers.  The optimized plan is cut by the regular Fragmenter
(plan/fragment.py); each SOURCE fragment's splits run tile by tile
through a FragmentExecutor, and its output pages accumulate on the host.
Downstream fragments consume the gathered pages as a remote worker
would: local streaming is distributed execution with one worker and
host memory as the exchange buffer.

The gate and the tile counts are the JAX package's: the estimate is the
scan bytes times (1 + 0.28 per wide aggregate) plus, with
device_generation on, DEVGEN_TEMP_LANES int64 lanes a row of every scan
whose connector generates on the device (the generator's temporaries,
connectors/tpch_device.py), and tiles are ceil(scan estimate /
(limit // 3)).  The JAX package also quantizes a tile's padded capacity
onto its padding ladder (scan_cap_override), so every tile reuses one
compiled program; eager execution pads nothing and compiles nothing, so
that step is left out.

On a worker the streamed fragment is the task's own (exec/fragment_exec.py):
its tiles read only the splits the task was given, each cut by its
connector where the task holds fewer splits than tiles
(SplitManager.subdivide), and its RemoteSources are read whole by every
tile from the pages the task fetched.  A fragment whose root is already
a PARTIAL aggregate streams as PARTIAL tiles merged by an INTERMEDIATE
step (plan/fragment.py), so the task emits every accumulator lane its
consumer reads, wide-decimal limbs included.  Each tile's run is a
`stream_tile` span (fragment, tile, rows read).

Tiles run double-buffered: while tile i runs on the card, up to
`double_buffer_depth` later tiles load on a prefetch thread and put
their scan lanes on the device on a side CUDA stream
(FragmentExecutor.preupload): a device-generated scan generates its
row range there, any other scan copies its host arrays.
"""
from __future__ import annotations

import math
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import torch

from ..page import Page
from ..plan import nodes as P
from ..plan.fragment import fragment_plan
from ..utils.tracing import TRACER
from .scan import plan_leaves, table_scans

# a tile's scan working set is bounded to limit/SAFETY so scan arrays,
# operator temporaries and partial state fit together
SAFETY_FACTOR = 3


def _scan_row_bytes(node: P.TableScan) -> int:
    total = 0
    for sym, _col in node.assignments:
        t = dict(node.types)[sym]
        width = 8
        try:
            width = t.np_dtype.itemsize
        except NotImplementedError:
            pass
        if getattr(t, "wide", False):
            width = 16
        total += width + 1  # validity byte
    return max(total, 1)


# the JAX package's name: the gate's parity tests call it on both packages
_find_scan_nodes = table_scans


def _est_scan_bytes(executor, catalog: str, table: str, node) -> float:
    conn = executor.catalogs.get(catalog)
    try:
        stats = conn.metadata().get_table_statistics(table)
    except Exception:  # noqa: BLE001 — unknown stats: assume small
        return 0.0
    return float(stats.row_count) * _scan_row_bytes(node)


def estimate_plan_scan_bytes(executor, plan: P.PlanNode) -> float:
    return sum(
        _est_scan_bytes(executor, sc.catalog, sc.table, sc)
        for sc in _find_scan_nodes(plan)
    )


def _wide_agg_count(plan: P.PlanNode) -> int:
    """Aggregates whose accumulation runs 128-bit chunked math at input
    width (decimal sums/avgs): each adds full-width chunk-lane
    temporaries to the working set."""
    n = 0

    def walk(node: P.PlanNode):
        nonlocal n
        if isinstance(node, P.Aggregate):
            for a in node.aggs:
                try:
                    if a.to_spec()._wide_sum:
                        n += 1
                except Exception:  # noqa: BLE001
                    pass
        for s in node.sources:
            walk(s)

    walk(plan)
    return n


# int64 lanes the generator keeps live per row on top of its output
# lanes: the row-index lane, the splitmix64 hash state, one value lane
# (reused across columns), and lineitem's cumsum/searchsorted slot
# machinery (connectors/tpch_device.py generates in chunks to stay inside)
DEVGEN_TEMP_LANES = 4


def _devgen_temp_bytes(executor, plan: P.PlanNode) -> float:
    """Device temporaries of on-device scan generation: DEVGEN_TEMP_LANES
    int64 lanes a row of every scan whose connector generates on the
    device (the JAX package's estimate, whatever columns the scan reads)."""
    if not executor.config.get("device_generation", True):
        return 0.0
    total = 0.0
    for sc in _find_scan_nodes(plan):
        conn = executor.catalogs.get(sc.catalog)
        if getattr(conn, "device_generation", None) is None:
            continue
        try:
            stats = conn.metadata().get_table_statistics(sc.table)
        except Exception:  # noqa: BLE001 — unknown stats: assume small
            continue
        total += float(stats.row_count) * 8.0 * DEVGEN_TEMP_LANES
    return total


def wide_agg_temp_bytes(scan_bytes: float, plan: P.PlanNode) -> float:
    """Wide-decimal accumulation temporaries (the JAX package's
    calibration: 0.28 of the scan bytes per wide aggregate)."""
    return scan_bytes * 0.28 * _wide_agg_count(plan)


def estimate_program_bytes(executor, plan: P.PlanNode) -> float:
    """Estimated device peak of the in-memory run: scan lanes plus
    wide-decimal accumulation temporaries plus on-device generator
    temporaries."""
    scan = estimate_plan_scan_bytes(executor, plan)
    return (
        scan + wide_agg_temp_bytes(scan, plan)
        + _devgen_temp_bytes(executor, plan)
    )


# additive counters a tile executor accumulates that must surface in the
# parent executor's kernel profile (tile executors are discarded)
# (streamLoadS: a tile's load and its lanes' generation or upload on the
# prefetch thread;
# streamWaitS: the executing thread waiting for it; streamRunS: the
# tile's run, its copy of the output to the host included)
_TILE_COUNTERS = ("preuploads", "preupload_bytes", "pregenerated_bytes",
                  "deviceGeneratedScans",
                  "hostGeneratedScans", "fusedAggregates",
                  "fusedTerms", "fusedWideSums", "fusionRejects",
                  "streamLoadS", "streamWaitS", "streamRunS")


def _merge_tile_counters(executor, fe) -> None:
    prof = fe.kernel_profile
    for k in _TILE_COUNTERS:
        v = prof.get(k)
        if v:
            executor.kernel_profile[k] = executor.kernel_profile.get(k, 0) + v
    if prof.get("lastFusionReject"):
        executor.kernel_profile["lastFusionReject"] = prof["lastFusionReject"]


def plan_streaming(executor, plan: P.Output, memory_limit: int,
                   force: bool = False):
    """Decide whether to stream: the estimated working set exceeds the
    memory limit and the plan fragments cleanly.  Returns the fragment
    list or None.  `force` skips the estimate gate (the out-of-memory
    fallback already knows the in-memory run does not fit)."""
    if not force and max(
        estimate_plan_scan_bytes(executor, plan),
        estimate_program_bytes(executor, plan),
    ) <= memory_limit:
        return None
    # the fragment DAG is cached per plan object and budget (vetting
    # depends on the budget); refused plans are cached as False
    fcache = executor.config.get("fragment_cache")
    fkey = (id(plan), int(memory_limit))
    cached = fcache.get(fkey) if fcache is not None else None
    if cached is not None and cached[0] is plan:
        return None if cached[1] is False else cached[1]

    def _remember(value):
        if fcache is not None:
            fcache[fkey] = (plan, value)  # the plan pins id(plan)
            for k in list(fcache)[:-256]:
                fcache.pop(k, None)
        return None if value is False else value

    try:
        # a task's plan reads upstream fragments: number the new ones after
        first = 1 + max((n.fragment_id for n in plan_leaves(plan)
                          if isinstance(n, P.RemoteSource)), default=0)
        frags = fragment_plan(plan, first_id=first)
    except NotImplementedError:
        return _remember(False)
    if len(frags) < 2:
        return _remember(False)  # nothing to tile (plain scan output)
    # every oversized scan must sit in a tileable SOURCE fragment;
    # oversized build-side scans are the join spill's job
    budget = max(memory_limit // SAFETY_FACTOR, 1)
    by_id = {f.id: f for f in frags}

    def _reduces(n: P.PlanNode) -> bool:
        if isinstance(n, (P.Aggregate, P.TopN, P.Distinct, P.Limit)):
            return True
        return any(_reduces(s) for s in n.sources)

    for f in frags:
        scans = _find_scan_nodes(f.root)
        oversized = any(
            _est_scan_bytes(executor, cat, tab, scans[idx]) > budget
            for idx, (cat, tab, _cons) in f.scan_tables.items()
        )
        if not oversized:
            continue
        if f.partitioning != "source":
            return _remember(False)
        # an oversized fragment gathered straight into its consumer must
        # reduce, or the tile outputs re-materialize the input downstream
        # (pure sorts belong to the spilled sort)
        if f.output_partitioning == "single" and not _reduces(f.root):
            return _remember(False)
    if 0 not in by_id:
        return _remember(False)
    return _remember(frags)


def tile_counts(executor, frags, memory_limit: int) -> Dict[int, int]:
    """Tiles per SOURCE fragment: ceil(scan estimate / (limit // 3))."""
    budget = max(memory_limit // SAFETY_FACTOR, 1)
    out = {}
    for f in frags:
        if f.partitioning == "source":
            (idx, (cat, tab, _cons)), = f.scan_tables.items()
            est = _est_scan_bytes(executor, cat, tab, _find_scan_nodes(f.root)[idx])
            out[f.id] = max(1, math.ceil(est / budget))
    return out


def _task_splits(executor, plan: P.PlanNode):
    """A task's assigned splits by id(scan node) (the fragmenter keeps the
    scan nodes), or None on one node, which reads every split."""
    assigned = getattr(executor, "splits_by_scan", None)
    if assigned is None:
        return None
    return {id(sc): assigned.get(i, []) for i, sc in enumerate(_find_scan_nodes(plan))}


def _splits(executor, task_splits, scan_table, node: P.TableScan, want: int) -> list:
    """The splits a fragment's scan reads, at least `want` where they can
    be had: the connector's on one node, the task's own (cut by the
    connector when fewer) on a worker."""
    cat, tab, cons = scan_table
    sm = executor.catalogs.get(cat).split_manager()
    if task_splits is None:
        return sm.get_splits(tab, want, cons)
    splits = task_splits.get(id(node), [])
    if len(splits) >= want:
        return splits
    parts = math.ceil(want / max(len(splits), 1))
    return [p for s in splits for p in sm.subdivide(s, parts)]


def execute_streaming(executor, plan: P.Output, frags, memory_limit: int) -> Page:
    """Run the fragment DAG locally, tiling SOURCE fragments' splits."""
    from .fragment_exec import FragmentExecutor
    from .scan import RemoteInputs

    by_id = {f.id: f for f in frags}
    ntiles_of = tile_counts(executor, frags, memory_limit)
    task_splits = _task_splits(executor, plan)
    # a task's upstream pages, fetched already, under their fragment ids
    pages_by_fragment: Dict[int, List[Page]] = dict(
        getattr(executor, "remote_pages", None) or {})
    # remote inputs merged and uploaded once for every tile of this run
    # (tiles must not thrash the session's scan cache)
    remote_inputs = RemoteInputs()
    dev = executor.device
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    executor.kernel_profile["streamedTiles"] = {}

    def tile_config() -> dict:
        cfg = dict(executor.config)
        # the per-query manager would double-count across tiles and
        # spill in a tile would recurse, but the limit stays enforced: a
        # tile's own _account_memory raises when splits cannot realize
        # the planned tile count
        cfg.pop("memory_manager", None)
        cfg["spill_enabled"] = False
        cfg["scan_cache"] = None
        return cfg

    def run_fragment(fid: int):
        if fid in pages_by_fragment:
            return
        f = by_id[fid]
        for src in f.source_fragments:
            run_fragment(src)
        remote = {src: pages_by_fragment[src] for src in f.source_fragments}
        scans = _find_scan_nodes(f.root)
        if f.partitioning != "source":
            splits_by_scan = {
                idx: _splits(executor, task_splits, st, scans[idx], 1)
                for idx, st in f.scan_tables.items()
            }
            fe = FragmentExecutor(executor.catalogs, tile_config(), splits_by_scan, remote,
                                  remote_inputs=remote_inputs)
            pages_by_fragment[fid] = [fe.execute(f.root)]
            _merge_tile_counters(executor, fe)
            return
        (idx, st), = f.scan_tables.items()
        ntiles = ntiles_of[fid]
        splits = _splits(executor, task_splits, st, scans[idx], ntiles)
        per = max(1, math.ceil(len(splits) / ntiles))
        tile_starts = list(range(0, len(splits), per))
        executor.kernel_profile["streamedTiles"][fid] = len(tile_starts)

        def make_loaded(i: int):
            t0 = time.perf_counter()
            fe = FragmentExecutor(executor.catalogs, tile_config(),
                                  {idx: splits[i: i + per]}, remote,
                                  remote_inputs=remote_inputs)
            loaded = fe.preload(f.root)
            # the next tile's copies start on this (prefetch) thread, on
            # the side stream, overlapping the current tile's kernels
            fe.preupload(loaded, copy_stream)
            fe.kernel_profile["streamLoadS"] = time.perf_counter() - t0
            return fe, loaded

        # double-buffered: while tile i runs, up to `double_buffer_depth`
        # later tiles load and upload (each staged tile holds its scan
        # working set on the device, so depth multiplies tile residency)
        depth = max(1, int(executor.config.get("double_buffer_depth", 1) or 1))
        out: List[Page] = []
        with ThreadPoolExecutor(max_workers=depth) as prefetch:
            pending = deque(prefetch.submit(make_loaded, i)
                            for i in tile_starts[:depth])
            nexti = depth
            for tile in range(len(tile_starts)):
                t0 = time.perf_counter()
                fe, loaded = pending.popleft().result()  # a prefetch failure raises here
                t1 = time.perf_counter()
                if nexti < len(tile_starts):
                    pending.append(prefetch.submit(make_loaded, tile_starts[nexti]))
                    nexti += 1
                with TRACER.span("stream_tile", fragment=fid, tile=tile) as span:
                    out.append(fe.execute(f.root, loaded))
                    span.attributes["rows"] = int(
                        fe.kernel_profile.get("summary", {}).get("actualRows", 0))
                prof = fe.kernel_profile
                prof["streamWaitS"] = t1 - t0
                prof["streamRunS"] = time.perf_counter() - t1
                _merge_tile_counters(executor, fe)
        pages_by_fragment[fid] = out

    run_fragment(0)
    (result,) = pages_by_fragment[0]
    executor.kernel_profile["streamedFragments"] = len(frags)
    return result
