"""Local execution: logical plan -> eager PyTorch operators on one device.

Counterpart of trino_tpu/exec/local.py, for the plans the 22 TPC-H
queries, the TPC-DS statements of the tests, SELECT DISTINCT, the set
operations, GROUPING SETS, window functions, arrays and UNNEST,
MATCH_RECOGNIZE, TABLESAMPLE and the writes reach.  Where the JAX
package traces a whole fragment into one jitted XLA program over padded
lanes, this executor walks the plan and runs each operator eagerly on
the executor's device:
  1. loads splits on the host (numpy), merging per-split dictionaries,
     unless the connector generates the scan on the device
     (`device_generation`: connectors/tpch_device.py makes the lanes from
     a row range, and no host array exists),
  2. uploads scan columns through page-locked memory (or generates them
     on the device) and keeps them there across queries
     (DeviceScanCache),
  3. runs the operators (filter / project / sample / join / cross join /
     semi join (IN, EXISTS and, under a NOT filter, their negations) /
     scalar join / GROUPING SETS row expansion / aggregate, DISTINCT
     aggregates included — first trying the fused megakernel, then
     direct or hash-sort grouping — / distinct / union, intersect,
     except / window / unnest / match_recognize / sort / top-N / limit),
  4. re-runs the plan when a runtime check fails (the JAX package's
     retry ladder): a direct-address join whose build keys break the
     planner's domain/uniqueness proof retries on the sorted unique
     kernel, a duplicate build key then on the expansion join, a
     grouping hash collision under a new salt, and a decimal overflow
     flag with the 128-bit kernels; then copies the selected output rows
     back to the host,
  5. hands a write's host page to the connector's PageSink
     (_execute_write: INSERT, CREATE TABLE AS, DELETE, UPDATE, MERGE).

Queries larger than their memory budget (`memory_limit_bytes`, the
session's query_max_memory_bytes) take the JAX package's gate, in its
order: the DISTINCT spill, streaming through the fragment DAG
(exec/streaming.py, tiles of splits run by exec/fragment_exec.py), then
the aggregation, join, sort and window spills (exec/spill.py).  The
scan working set is accounted against the limit (_account_memory) and
the device working set reserved against the session's
LocalMemoryManager before the run; a device-tier refusal or a
torch.OutOfMemoryError re-runs the plan streamed
(_try_forced_streaming, counted in kernel_profile["forcedStreaming"]).
The aggregate runs all three steps: SINGLE, PARTIAL (accumulator
columns, ops/aggregation.accumulate) and FINAL / INTERMEDIATE
(ops/aggregation.merge_accumulators).

No padding ladder: eager execution has no compile to bound, so lanes
keep their exact row counts, and group and join-expansion capacities
are the true counts (no capacity retries).  Batch representation:
dict[symbol -> (values, valid)] plus a boolean selection mask `sel`.

Variable-length results are staged on the host, as in the JAX package:
UNNEST measures and flattens each distinct array once (the rows repeat
and gather their elements on the device), array_agg / map_agg / listagg
put the selected rows in group order on the device and build one
dictionary entry per group from one copy of the lanes
(ops/aggregation.host_staged_lanes), and MATCH_RECOGNIZE sorts on the
device and runs the row-at-a-time matcher (ops/matcher.py) per
partition.  Every lane they return lives on the executor's device.

With `collect_node_stats` (EXPLAIN ANALYZE, `operator_stats`) every
operator's rows, bytes and walls land in `node_stats`, the card
synchronized after each one; with `bandwidth_ledger` each run's bytes
over its synchronized wall go to obs/bandwidth.py.

Every operator visit, kernel launch and device->host sync crosses the
session's device supervisor (runtime/supervisor.py): a lost or wedged
card raises DeviceFaultError naming the culprit kernel and quarantines
the device.  Nothing re-runs the query elsewhere (the JAX package
re-runs it on the CPU; the port has no such path on purpose).

`distributed = true` runs the plan over a mesh of shards instead
(parallel/mesh_executor.py, whose shards run these visitors).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as D
from .. import types as T
from ..cache.compile_cache import fragment_family
from ..catalog import CatalogManager, Metadata
from ..expr import ir
from ..expr.functions import memoized
from ..expr.lower import LoweringContext, compile_expr
from ..ops import aggregation as agg_ops
from ..ops import join as join_ops
from ..ops import sort as sort_ops
from ..ops import window as window_ops
from ..obs import compile_observatory
from ..page import Column, Page
from ..plan import nodes as P
from ..runtime import supervisor as rt
from ..runtime.supervisor import Breadcrumb, DeviceFaultError


class DeviceScanCache:
    """Cross-query scan cache: host merged arrays + device lanes.

    Repeated scans of an unchanged (connector-versioned) table reuse the
    uploaded device tensors.  Entries evict in insertion order once the
    byte budget is exceeded: by default a quarter of the card's memory on
    CUDA (the lanes stay resident there beside the queries' working
    memory), 6 GiB of host arrays on the CPU.  Its hits, misses, puts
    and evictions are system.runtime.caches' scan_cache row."""

    def __init__(self, max_bytes: Optional[int] = None,
                 device: Optional[torch.device] = None):
        if max_bytes is None:
            max_bytes = 6 << 30
            if device is not None and device.type == "cuda":
                max_bytes = torch.cuda.get_device_properties(device).total_memory // 4
        self.max_bytes = max_bytes
        self.entries: Dict[tuple, dict] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0

    def drop_all(self) -> int:
        """Evict everything; returns the bytes freed (the session's
        revocable listener: the scan cache goes first under pressure)."""
        freed = self.bytes
        self.evictions += len(self.entries)
        self.entries.clear()
        self.bytes = 0
        return freed

    def get(self, key: tuple, record: bool = True):
        """record=False for a second lookup of an entry already counted
        (the device-lane bind re-reads what the scan load found)."""
        entry = self.entries.get(key)
        if record:
            if entry is not None:
                self.hits += 1
            else:
                self.misses += 1
        return entry

    def put(self, key: tuple, entry: dict, nbytes: int):
        while self.bytes + nbytes > self.max_bytes and self.entries:
            oldest = next(iter(self.entries))
            self.bytes -= self.entries.pop(oldest).get("nbytes", 0)
            self.evictions += 1
        entry["nbytes"] = nbytes
        self.entries[key] = entry
        self.bytes += nbytes
        self.puts += 1

    def stats(self) -> Dict[str, int]:
        return {
            "name": "scan_cache",
            "hits": self.hits,
            "misses": self.misses,
            "puts": self.puts,
            "evictions": self.evictions,
            "entries": len(self.entries),
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "heals": 0,
            "invalidations": 0,
        }

    def evict_table(self, catalog: str, table: str) -> None:
        """Drop every scan of one table (after a write: its entries are
        keyed by the old data version and would only hold memory)."""
        for key in [k for k in self.entries if k[:2] == (catalog, table)]:
            self.bytes -= self.entries.pop(key).get("nbytes", 0)


class ExecutionError(RuntimeError):
    pass


@dataclasses.dataclass
class Batch:
    lanes: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    sel: torch.Tensor
    ordered: bool = False  # rows already compacted+ordered (sort output)


def _single_row_plan(n: P.PlanNode) -> bool:
    """Does this plan emit at most one row, statically?  (Global
    aggregates and LIMIT<=1, through projections/filters.)"""
    if isinstance(n, P.Aggregate):
        return not n.keys and n.step in ("single", "final")
    if isinstance(n, P.Limit):
        return n.count <= 1 or _single_row_plan(n.sources[0])
    if isinstance(n, P.Values):
        return len(n.rows) <= 1
    if isinstance(n, (P.Project, P.Filter)):
        return _single_row_plan(n.sources[0])
    return False


class _LazyDeviceLane:
    """Placeholder for a scan column that will be generated on the device
    (no host array exists).  Carries the byte size of the lane it becomes
    so memory accounting sees the device footprint."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int):
        self.nbytes = int(nbytes)


def merge_pages_to_arrays(pages, symbols, types, dicts):
    """Concatenate pages column-wise into host arrays; varchar
    dictionaries from different splits are merged with codes remapped.
    Fast path: pages sharing one dictionary pass codes through."""
    tmap = dict(types)
    merged = {}
    total = sum(p.count for p in pages)
    for sym in symbols:
        t = tmap[sym]
        vals_parts: List[np.ndarray] = []
        ok_parts: List[np.ndarray] = []
        live = [p for p in pages if p.count > 0]
        if t.is_dictionary:
            page_dicts = []
            for p in live:
                d = p.by_name(sym).dictionary
                if d is None:
                    raise ExecutionError(f"varchar column {sym} without dict")
                page_dicts.append(d)
            shared = all(
                d is page_dicts[0] or np.array_equal(page_dicts[0], d)
                for d in page_dicts[1:]
            )
            if shared:
                dicts[sym] = (
                    page_dicts[0] if page_dicts else np.array([], dtype=object)
                )
                for p in live:
                    col = p.by_name(sym)
                    vals_parts.append(
                        np.asarray(col.values)[: p.count].astype(np.int32)
                    )
                    ok_parts.append(_valid_of(col, p.count))
            else:
                index: Dict[str, int] = {}
                entries: List[str] = []
                for p, d in zip(live, page_dicts):
                    col = p.by_name(sym)
                    codes = np.asarray(col.values)[: p.count]
                    # an all-NULL page's dictionary is empty: its codes
                    # map to no entry (-1)
                    remap = np.full(max(len(d), 1), -1, dtype=np.int32)
                    for i, s in enumerate(d):
                        s = str(s)
                        if s not in index:
                            index[s] = len(entries)
                            entries.append(s)
                        remap[i] = index[s]
                    safe = np.clip(codes, 0, max(len(d) - 1, 0))
                    vals_parts.append(
                        np.where(codes >= 0, remap[safe], -1).astype(np.int32)
                    )
                    ok_parts.append(_valid_of(col, p.count))
                dicts[sym] = np.array(entries, dtype=object)
        else:
            for p in live:
                col = p.by_name(sym)
                vals_parts.append(np.asarray(col.values)[: p.count])
                ok_parts.append(_valid_of(col, p.count))
        if vals_parts:
            vals = np.concatenate(vals_parts)
            ok = np.concatenate(ok_parts)
        else:
            vals = np.zeros(0, dtype=t.np_dtype)
            ok = np.zeros(0, dtype=bool)
        merged[sym] = (vals, None if ok.all() else ok)
    return merged, total


def _read_checks(ctx: "_TraceCtx"):
    """The run's runtime checks as Python ints, read in one copy: (decimal
    overflow flags fired, join duplicate/violation counts, grouping
    collision counts, bigint sum overflow flags)."""
    wides = ctx.lowering.overflow_flags
    dev = ctx.ex.device  # a mesh's checks come from every shard's device
    groups = ([sum(f.reshape(()).to(dev, torch.int64) for f in wides)] if wides else [],
              [d for _, d in ctx.dup_checks], list(ctx.collision_checks),
              list(ctx.sum_overflow))
    flat = [v for g in groups for v in g]
    tensors = [v for v in flat if isinstance(v, torch.Tensor)]
    read = iter(torch.stack([t.reshape(()).to(dev, torch.int64) for t in tensors]).tolist()
                if tensors else [])
    vals = [next(read) if isinstance(v, torch.Tensor) else int(v) for v in flat]
    out, i = [], 0
    for g in groups:
        out.append(vals[i:i + len(g)])
        i += len(g)
    return (out[0][0] if out[0] else 0), out[1], out[2], out[3]


def _is_null_expr(e: ir.Expr) -> bool:
    while isinstance(e, ir.Cast):
        e = e.term
    if isinstance(e, ir.Constant) and e.value is None:
        return True
    return e.type.name == "unknown"


def _run_heads(gid: torch.Tensor) -> torch.Tensor:
    """First row of each run of equal ids in a sorted gid lane."""
    one = torch.ones(1, dtype=torch.bool, device=gid.device)
    return torch.cat([one, gid[1:] != gid[:-1]])[: gid.shape[0]]


def _broadcast_first_row(keep: Batch, single: Batch):
    """keep's lanes plus single's first selected row broadcast over
    keep's rows (NULL where single selects no row; wide decimals keep
    their limb dimension), and whether single selects a row."""
    n = keep.sel.shape[0]
    m = single.sel.shape[0]
    has = single.sel.sum() > 0
    first = torch.argmax(single.sel.to(torch.int8)) if m else None
    lanes = dict(keep.lanes)
    for s, (v, ok) in single.lanes.items():
        if m:
            fv, fok = v[first], ok[first] & has
        else:
            fv = torch.zeros(v.shape[1:], dtype=v.dtype, device=v.device)
            fok = has
        lanes[s] = (fv.expand((n,) + tuple(v.shape[1:])).contiguous(),
                    fok.expand((n,)).contiguous())
    return lanes, has


def _rows_page(n: int) -> Page:
    """A write's result: one BIGINT row, the affected-row count."""
    return Page([Column(T.BIGINT, np.array([n], dtype=np.int64))], 1, ["rows"])


def _object_array(items) -> np.ndarray:
    """1-D object array of the items (np.array would make equal-length
    tuple entries, i.e. arrays, into a 2-D array)."""
    out = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        out[i] = x
    return out


def sample_keep(n: int, fraction: float, device) -> torch.Tensor:
    """TABLESAMPLE's mask over a batch of n rows: position i is kept when
    u_i < fraction, u_i = (splitmix64(i) >> 11) / 2^53, the JAX
    package's bits (uint64 arithmetic in int64, logical shifts)."""
    from ..ops.aggregation import _splitmix64
    from ..ops.int128 import srl

    z = _splitmix64(torch.arange(n, dtype=torch.int64, device=device))
    return srl(z, 11).to(torch.float64) / float(1 << 53) < fraction


class FlatArrays:
    """An array column's dictionary measured and flattened once on the
    host: each entry's length and offset into one flat table of its
    elements.  Elements of a dictionary type get ids in order of first
    appearance in that table (`sid`, -1 for NULL; `distinct` the values);
    others a value table and its validity in the element's dtype."""

    def __init__(self, entries: np.ndarray, et):
        import itertools

        self.lengths = np.fromiter((len(e) for e in entries), dtype=np.int64,
                                   count=len(entries))
        self.offsets = np.zeros(len(entries), dtype=np.int64)
        if len(entries) > 1:
            np.cumsum(self.lengths[:-1], out=self.offsets[1:])
        elements = list(itertools.chain.from_iterable(entries))
        if et.is_dictionary:
            index: Dict[object, int] = {}
            self.sid = np.array([-1 if x is None else index.setdefault(x, len(index))
                                 for x in elements], dtype=np.int64)
            self.distinct = _object_array(list(index))
        else:
            self.vals = np.array([0 if x is None else x for x in elements],
                                 dtype=et.np_dtype)
            self.vok = np.array([x is not None for x in elements], dtype=bool)


def unnest_lanes(lanes, sel, node: P.Unnest, flat: FlatArrays):
    """UNNEST's output lanes (UnnestOperator's row replication) and the
    element lane's dictionary (None unless the element type has one).
    Every selected row repeats once per element of its array (a NULL or
    empty array: once, NULL-extended, under LEFT JOIN UNNEST; not at all
    otherwise); the elements come from the flat table of the
    dictionary's arrays, gathered on the device.  A dictionary-typed
    element lane lists its values in order of first appearance among the
    output rows, as column_from_pylist over them gives it."""
    from ..expr.functions import dict_gather

    dev = sel.device
    et = node.element_type
    rows = torch.nonzero(sel).flatten()
    av, aok = lanes[node.array_symbol]
    codes = av[rows].to(torch.int64)
    lens = torch.where(aok[rows] & (codes >= 0),
                       dict_gather(flat.lengths, codes, 0), 0)
    eff = torch.clamp(lens, min=1) if node.outer else lens
    total = int(eff.sum())
    which = torch.repeat_interleave(
        torch.arange(rows.shape[0], device=dev), eff, output_size=total)
    src = rows[which]
    first_out = torch.cumsum(eff, 0) - eff
    k = torch.arange(total, dtype=torch.int64, device=dev) - first_out[which]
    has = lens[which] > 0  # False on a NULL-extended row
    out = {sym: (v[src], ok[src]) for sym, (v, ok) in lanes.items()
           if sym != node.array_symbol}
    flat_at = torch.where(has, dict_gather(flat.offsets, codes, 0)[which] + k, 0)
    element_dict = None
    if et.is_dictionary:
        osid = torch.where(has, dict_gather(flat.sid, flat_at, -1), -1)
        live = osid >= 0
        nd = len(flat.distinct)
        pos = torch.arange(total, dtype=torch.int64, device=dev)
        first = torch.full((nd,), total, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, osid[live], pos[live], "amin")
        order = torch.argsort(first, stable=True)
        present = int((first < total).sum())
        recode = torch.empty(nd, dtype=torch.int64, device=dev)
        recode[order] = torch.arange(nd, dtype=torch.int64, device=dev)
        ev = torch.where(live, recode[torch.clamp(osid, min=0)] if nd else -1, -1)
        out[node.element_symbol] = (ev.to(torch.int32), live)
        element_dict = flat.distinct[D.to_numpy(order[:present])]
    else:
        ok = has & dict_gather(flat.vok, flat_at, False)
        ev = torch.where(ok, dict_gather(flat.vals, flat_at, 0), 0)
        out[node.element_symbol] = (ev.to(D.torch_dtype(et.np_dtype)), ok)
    if node.ordinality_symbol:
        out[node.ordinality_symbol] = (torch.where(has, k + 1, 0), has)
    return out, element_dict


def _dense_ranks(d: np.ndarray) -> np.ndarray:
    """Each dictionary entry's dense lexicographic rank (equal strings
    under distinct codes tie)."""
    dd = np.asarray(d, dtype=str)
    order = np.argsort(dd, kind="stable")
    sd = dd[order]
    dense = np.zeros(len(d), dtype=np.int64)
    if len(d) > 1:
        dense[1:] = np.cumsum(sd[1:] != sd[:-1])
    ranks = np.empty(len(d), dtype=np.int64)
    ranks[order] = dense
    return ranks


def _tensor_bytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _scan_bytes(scans) -> int:
    """Bytes of the scan lanes a run reads: host arrays, device-generated
    lanes by their size, validity lanes included."""
    return sum(int(v.nbytes) + (int(ok.nbytes) if ok is not None else 0)
               for arrays in scans.values() for v, ok in arrays.values())


def _valid_of(col: Column, n: int) -> np.ndarray:
    return (
        np.ones(n, bool)
        if col.validity is None
        else np.asarray(col.validity)[:n]
    )


class LocalExecutor:
    """Executes an optimized logical plan on one device."""

    def __init__(self, catalogs: CatalogManager, config: Optional[dict] = None):
        self.catalogs = catalogs
        self.metadata = Metadata(catalogs)
        self.config = config or {}
        self.device = D.resolve(self.config.get("device"))
        self.kernel_profile: Dict[str, object] = {"kernels": [], "summary": {}}
        self._scan_keys: Dict[int, tuple] = {}
        # id(scan node) -> the connector's on-device generation spec
        self._devgen: Dict[int, dict] = {}
        self.dicts: Dict[str, np.ndarray] = {}
        self.force_wide_mul = False
        self.query_id = str(self.config.get("query_id", "query"))
        self.scan_bytes = 0  # the host reservation (scan working set)
        self.device_bytes = 0  # the device-tier reservation
        # (plan, scans, dicts, counts) a streaming prefetcher loaded
        self._preloaded = None
        # EXPLAIN ANALYZE / operator_stats: id(plan node) -> {rows, bytes,
        # wall_s, device_wall_s, calls} (OperatorStats), filled when
        # collect_node_stats is set; obs/opstats.frames_from_plan turns
        # them into frames.  blocked_memory_s: waiting on reservations.
        self.node_stats: Dict[int, dict] = {}
        self.blocked_memory_s = 0.0
        self.bandwidth_ledger = None
        # generator temporaries of the scans generated during the run the
        # ledger is timing (warm scans and host-path scans generate none)
        self._devgen_temp_bytes = 0
        if self.config.get("bandwidth_ledger"):
            from ..obs.bandwidth import BandwidthLedger

            self.bandwidth_ledger = BandwidthLedger()
        # the supervised boundary: the session's supervisor when wired,
        # the process default otherwise (bare executors in tests)
        self.supervisor = (self.config.get("device_supervisor")
                           or rt.default_supervisor())
        # the encoded megakernel programs: the process's shared cache, or
        # the executor's own (the session's compile_cache = false)
        self.compile_cache = self.config.get("compile_cache")
        if self.compile_cache is None:
            from ..cache.compile_cache import shared_compile_cache

            self.compile_cache = shared_compile_cache()

    # ------------------------------------------------------------------
    def execute(self, plan: P.PlanNode) -> Page:
        assert isinstance(plan, P.Output)
        if isinstance(plan.source, P.TableWriter):
            return self._execute_write(plan.source)
        sup = self.supervisor
        sup.maybe_probe()
        if not sup.healthy():
            # the device is already out: refuse with the structured error
            bc = self._crumb("pre-dispatch", "gate")
            raise DeviceFaultError("device_" + sup.device_state().lower(), bc)
        return self._execute_supervised(plan)

    def _execute_supervised(self, plan: P.Output) -> Page:
        """One run of the plan inside the supervisor's scope, with the
        compiles it made counted by cause."""
        sup = self.supervisor
        before = compile_observatory.get_observatory().counts_by_cause()
        try:
            with rt.supervising(sup, self.query_id,
                                str(self.config.get("task_id") or ""),
                                lambda: self.device_bytes):
                page = self._execute_inner(plan)
        except DeviceFaultError as fault:
            self.kernel_profile["last_breadcrumb"] = fault.breadcrumb.to_dict()
            raise
        # the compiles this execution made (nvcc builds, program encodes,
        # retry-ladder re-runs), by the observatory's cause
        after = compile_observatory.get_observatory().counts_by_cause()
        by_cause = {c: n - before.get(c, 0) for c, n in after.items()
                    if n - before.get(c, 0)}
        summary = self.kernel_profile.setdefault("summary", {})
        summary["compilesByCause"] = by_cause
        summary["compiles"] = sum(by_cause.values())
        return page

    def _crumb(self, kernel: str, mode: str, shapes=None) -> Breadcrumb:
        bc = Breadcrumb(kernel, query_id=self.query_id,
                        task_id=str(self.config.get("task_id") or ""),
                        mode=mode, shapes=shapes,
                        hbm_reserved_bytes=self.device_bytes)
        # forensics ride the kernel profile (EXPLAIN ANALYZE, tests)
        self.kernel_profile["last_breadcrumb"] = bc.to_dict()
        return bc

    def _device_get(self, fn, what: str, shapes=None):
        """A supervised device->host sync (the reference's device_get):
        `fn` reads or copies device tensors once the card has finished
        the queued work, under the watchdog."""
        return self.supervisor.device_get(
            fn, self._crumb(what, "sync", shapes), device=self.device)

    def _execute_inner(self, plan: P.Output) -> Page:
        limit = self.config.get("memory_limit_bytes")
        if limit and self.config.get("spill_enabled", True):
            from . import spill, streaming

            # DISTINCT aggregation first: the fragmenter keeps a distinct
            # Aggregate single-step behind one hash exchange, which would
            # gather every input row into one fragment
            # kernel_profile["outOfCore"] names the path taken
            sp = spill.plan_distinct_spill(self, plan, int(limit))
            if sp is not None:
                self.kernel_profile["outOfCore"] = "distinct-spill"
                return spill.execute_spilled_distinct(self, plan, *sp)
            frags = streaming.plan_streaming(self, plan, int(limit))
            if frags is not None:
                self.kernel_profile["outOfCore"] = "stream"
                return streaming.execute_streaming(self, plan, frags, int(limit))
            for path, planner, runner in (
                ("aggregation-spill", spill.plan_spill,
                 spill.execute_spilled_aggregation),
                ("join-spill", spill.plan_join_spill, spill.execute_spilled_join),
                ("sort-spill", spill.plan_sort_spill, spill.execute_spilled_sort),
                ("window-spill", spill.plan_window_spill,
                 spill.execute_spilled_window),
            ):
                sp = planner(self, plan, int(limit))
                if sp is not None:
                    self.kernel_profile["outOfCore"] = path
                    return runner(self, plan, *sp)
        pre = self._preloaded
        if pre is not None and pre[0] is plan:
            _, scans, dicts, counts = pre
            self._preloaded = None
        else:
            scans, dicts, counts = {}, {}, {}
            self._load_scans(plan, scans, dicts, counts)
        self._account_memory(scans, limit)
        manager = self.config.get("memory_manager")
        self.device_bytes = 0
        if manager is not None:
            # the device tier: the estimated working set is reserved
            # before the run, so a query that would not fit is blocked,
            # streamed or refused here instead of failing mid-run
            from ..memory import QueryKilledError
            from ..utils.memory import ExceededMemoryLimitError
            from .streaming import estimate_program_bytes

            est = int(max(self.scan_bytes, estimate_program_bytes(self, plan)))
            try:
                t_blk = time.perf_counter()
                manager.reserve(
                    self.query_id, est, tier="device",
                    timeout=float(self.config.get("memory_blocked_timeout_s") or 0.0),
                )
                self.blocked_memory_s += time.perf_counter() - t_blk
                self.device_bytes = est
            except ExceededMemoryLimitError as exc:
                manager.free(self.query_id, self.scan_bytes, tier="host")
                self.scan_bytes = 0
                if isinstance(exc, QueryKilledError):
                    raise
                out = self._try_forced_streaming(plan)
                if out is not None:
                    return out
                raise
        try:
            try:
                return self._run_plan(plan, scans, dicts, counts)
            except torch.OutOfMemoryError as exc:
                # leave the handler first: its traceback holds the failed
                # run's tensors, which the streamed run needs freed
                oom = exc.with_traceback(None)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            out = self._try_forced_streaming(plan)
            if out is None:
                raise oom
            return out
        finally:
            if manager is not None:
                manager.free(self.query_id, self.scan_bytes, tier="host")
                if self.device_bytes:
                    manager.free(self.query_id, self.device_bytes, tier="device")

    def _try_forced_streaming(self, plan: P.Output) -> Optional[Page]:
        """The out-of-memory fallback: re-run the query through the
        streaming tiled executor although the estimate gate did not
        trigger (the device said the in-memory run does not fit).
        Returns None when the plan is untileable or streaming itself
        fails; the caller then raises the original error."""
        limit = self.config.get("memory_limit_bytes")
        if not (limit and self.config.get("spill_enabled", True)):
            return None
        from . import streaming

        try:
            frags = streaming.plan_streaming(self, plan, int(limit), force=True)
            if frags is None:
                return None
            out = streaming.execute_streaming(self, plan, frags, int(limit))
        except DeviceFaultError:
            raise
        except Exception:  # noqa: BLE001 — the original error surfaces
            return None
        prof = self.kernel_profile
        prof["forcedStreaming"] = prof.get("forcedStreaming", 0) + 1
        from ..obs import journal

        # the doctor's memory_pressure evidence
        journal.emit(journal.FORCED_STREAMING, query_id=self.query_id,
                     severity=journal.WARN,
                     fragments=len(frags) if hasattr(frags, "__len__") else 0)
        return out

    def _account_memory(self, scans, limit):
        """Reserve the scan working set against the session's manager and
        enforce the per-query limit (ExceededMemoryLimitException).
        Scan arrays dominate the footprint; operator temporaries are
        proportional and covered by the limit's headroom."""
        from ..utils.memory import ExceededMemoryLimitError

        scan_total = 0
        for arrays in scans.values():
            for v, ok in arrays.values():
                scan_total += int(v.nbytes) + (int(ok.nbytes) if ok is not None else 0)
        # fragment tasks also hold the exchange pages they read: counted
        # toward the host reservation, not against the device limit
        total = scan_total + int(getattr(self, "exchange_bytes", 0))
        self.scan_bytes = total
        if limit and scan_total > int(limit):
            raise ExceededMemoryLimitError(
                f"query exceeded memory limit: scan working set "
                f"{scan_total} > {limit} bytes (and plan is not spillable)"
            )
        manager = self.config.get("memory_manager")
        if manager is not None:  # freed after the run (_execute_inner)
            t_blk = time.perf_counter()
            manager.reserve(
                self.query_id, total, tier="host",
                timeout=float(self.config.get("memory_blocked_timeout_s") or 0.0),
            )
            self.blocked_memory_s += time.perf_counter() - t_blk

    def _run_plan(self, plan: P.Output, scans, dicts, counts) -> Page:
        """Run the operators over loaded scans through the retry ladder
        and copy the selected output rows to the host."""
        self.dicts = dicts
        hints = self.config.get("capacity_hints")
        hint = hints.get(id(plan)) if hints is not None else None
        # start where the last run of this plan landed, so warm repeats
        # are single-shot: the 128-bit kernels, and the join nodes (by id)
        # whose build side broke the direct-address proof (run on the
        # sorted unique kernel) or held duplicate keys (the expansion join)
        self.force_wide_mul = bool(hint[0]) if hint else False
        self.force_expansion = set(hint[2]) if hint else set()
        self.force_no_direct = set(hint[3]) if hint else set()
        self.group_salt = 0  # the grouping hash's salt
        for attempt in range(7):
            if self.bandwidth_ledger is not None:
                self._sync()  # the ledger times this run's device work only
                self._devgen_temp_bytes = 0
            t0 = time.perf_counter()
            ctx = self._new_ctx(scans, counts)
            out_lanes, sel = self._run(plan, ctx)
            if self.bandwidth_ledger is not None:
                self._ledger_record(out_lanes, sel, "eager-%d" % attempt, plan,
                                    scans, t0)
            checks = self._device_get(lambda: _read_checks(ctx), "runtime checks")
            self._record_kernel(
                "eager-%d" % attempt, time.perf_counter() - t0, False,
                mode="eager",
            )
            if attempt:
                # each re-run of the ladder is a compile of the plan's
                # family with new parameters (the observatory's ladder_rung)
                compile_observatory.record_compile(
                    kernel="eager-%d" % attempt, family=fragment_family(plan),
                    mode="eager", actual_rows=sum(int(c) for c in counts.values()),
                    compile_wall_s=time.perf_counter() - t0,
                    query_id=self.query_id,
                    task_id=str(self.config.get("task_id") or ""),
                    ladder_attempt=attempt, scan_rows=[],
                )
            if not self._retry_needed(ctx, checks):
                break
        else:
            raise ExecutionError("the executor's retry ladder did not settle")
        if hint is None:
            # the serving observatory's affinity: this node ran the family
            compile_observatory.get_observatory().note_warm(
                fragment_family(plan))
        if hints is not None:
            hints[id(plan)] = (
                self.force_wide_mul, plan, frozenset(self.force_expansion),
                frozenset(self.force_no_direct),
            )
            for k in list(hints)[:-512]:
                hints.pop(k, None)

        def copy_out():
            idx = torch.nonzero(sel).flatten()
            return {
                s: (D.to_numpy(out_lanes[s][0][idx]),
                    D.to_numpy(out_lanes[s][1][idx]))
                for s in plan.symbols
            }

        host_lanes = self._device_get(
            copy_out, "output copy",
            rt.shape_summary({"sel": sel, **{s: out_lanes[s][0]
                                             for s in plan.symbols}}))
        self._finalize_kernel_profile(scans, counts, host_lanes)
        return self._materialize_host(plan, host_lanes)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self._device_get(lambda: torch.cuda.synchronize(self.device),
                             "synchronize")

    def _ledger_record(self, out_lanes, sel, digest, plan, scans, start):
        """Close one bandwidth-ledger observation: wait for the run's
        device work and fold its bytes over the wall."""
        from . import streaming

        self._sync()
        wall = time.perf_counter() - start
        try:
            inter = int(streaming.wide_agg_temp_bytes(
                streaming.estimate_plan_scan_bytes(self, plan), plan))
        except Exception:  # noqa: BLE001 — exotic plans: input+output only
            inter = 0
        inter += self._devgen_temp_bytes
        out = sel.numel() + sum(_tensor_bytes(v) + _tensor_bytes(ok)
                                for v, ok in out_lanes.values())
        self.bandwidth_ledger.record(
            digest, "eager", input_bytes=_scan_bytes(scans),
            output_bytes=out, intermediate_bytes=inter, wall_s=wall,
        )

    def _finalize_kernel_profile(self, scans, counts, host_lanes) -> None:
        """The profile's summary once the run settles: the runs made, the
        rows scanned, the bytes copied to the device (host scan arrays;
        device-generated lanes copy nothing) and back."""
        kernels: List[dict] = self.kernel_profile["kernels"]  # type: ignore[assignment]
        h2d = sum(int(v.nbytes) + (int(ok.nbytes) if ok is not None else 0)
                  for arrays in scans.values() for v, ok in arrays.values()
                  if not isinstance(v, _LazyDeviceLane))
        d2h = sum(int(v.nbytes) + int(ok.nbytes) for v, ok in host_lanes.values())
        summary = {
            "kernels": len(kernels),
            "executions": sum(k["executions"] for k in kernels),
            "actualRows": sum(int(c) for c in counts.values()),
            "h2dBytes": h2d,
            "d2hBytes": d2h,
        }
        led = self.bandwidth_ledger
        if led is not None:
            ls = led.summary()
            self.kernel_profile["bandwidth"] = led.entries()
            summary.update(effectiveGbps=ls["effectiveGbps"],
                           rooflinePct=ls["rooflinePct"],
                           rooflineGbps=ls["rooflineGbps"],
                           ledgerBytes=ls["totalBytes"],
                           deviceWallS=ls["deviceWallS"])
        self.kernel_profile["summary"] = summary

    def _execute_write(self, w: P.TableWriter) -> Page:
        """INSERT / CREATE TABLE AS / DELETE / UPDATE / MERGE
        (TableWriterOperator and TableFinishOperator in one): run the
        source query, hand its host page to the connector's PageSink,
        commit at finish().  The result is the affected-row count."""
        conn = self.catalogs.get(w.catalog)
        md = conn.metadata()
        if w.create_schema is not None:
            from ..spi import ColumnSchema, TableSchema

            if w.if_not_exists and w.table in md.list_tables():
                return _rows_page(0)
            md.create_table(TableSchema(
                w.table, tuple(ColumnSchema(c, t) for c, t in w.create_schema)
            ))
        before = 0
        if w.report_deleted or w.count_mode == "merge":
            before = int(md.get_table_statistics(w.table).row_count)
        names = list(w.columns)
        if w.count_symbol is not None:
            names.append("__update_count__")
        page = self.execute(
            P.Output(w.source, tuple(names), tuple(w.source.output_symbols()))
        )
        sink = conn.page_sink_provider().create_sink(
            w.table, list(w.columns), overwrite=w.overwrite
        )
        sink.append(page)
        written = sink.finish()
        if w.count_symbol is not None:
            marker = np.asarray(page.by_name("__update_count__").values)[: page.count]
            if w.count_mode == "merge":
                # 1 = updated, 2 = inserted; the deleted rows are the
                # shortfall against the count before the write
                updates = int((marker == 1).sum())
                inserts = int((marker == 2).sum())
                result = updates + inserts + (before + inserts - page.count)
            else:
                result = int(marker.sum())
        elif w.report_deleted:
            result = before - written
        else:
            result = written
        return _rows_page(result)

    def _retry_needed(self, ctx: "_TraceCtx", checks) -> bool:
        """Act on the run's runtime checks (_read_checks): arm the next
        rung of the retry ladder and return True when the run must be
        repeated."""
        wide_fired, dups, collisions, overflows = checks
        fell_back = False
        for (join_node, _), dup in zip(ctx.dup_checks, dups):
            if dup > 0:
                if (join_node.direct_domain is not None
                        and id(join_node) not in self.force_no_direct):
                    # direct-table domain/dup proof failed: retry on the
                    # sorted unique kernel first
                    self.force_no_direct.add(id(join_node))
                else:
                    # duplicate build keys: the many-to-many expansion
                    self.force_expansion.add(id(join_node))
                fell_back = True
        for cv in collisions:
            if cv > 0:
                # locator hash collision in grouping: a fresh salt
                self.group_salt += 1
                fell_back = True
        if wide_fired and not self.force_wide_mul:
            # decimal product/quotient or decimal(38) sum near the int64
            # range: re-run with the 128-bit kernels
            self.force_wide_mul = True
            fell_back = True
        if fell_back:
            return True
        # only a settled run may raise: a retried run piles unrelated
        # groups into one segment, making the shadow flag spurious
        for sv in overflows:
            if sv > 0:
                raise ExecutionError("sum overflows the bigint accumulator")
        return False

    # ------------------------------------------------------------------
    def _load_scans(self, node: P.PlanNode, scans, dicts, counts):
        if isinstance(node, P.TableScan):
            conn = self.catalogs.get(node.catalog)
            splits = conn.split_manager().get_splits(
                node.table, 1, node.constraint
            )
            self._load_one_scan(node, splits, scans, dicts, counts)
            return
        for s in node.sources:
            self._load_scans(s, scans, dicts, counts)

    def _scan_cache_key(self, node: P.TableScan, splits):
        conn = self.catalogs.get(node.catalog)
        if not getattr(conn, "cacheable", False):
            return None
        return (
            node.catalog,
            node.table,
            tuple(c for _, c in node.assignments),
            node.constraint,
            tuple(repr(sp) for sp in splits),
            conn.data_version(node.table),
            str(self.device),
        )

    def _load_one_scan(self, node: P.TableScan, splits, scans, dicts, counts):
        """Load the splits of one scan into host arrays, merging per-split
        dictionaries; cached across queries for versioned connectors."""
        cache: Optional[DeviceScanCache] = self.config.get("scan_cache")
        key = self._scan_cache_key(node, splits)
        self._scan_keys[id(node)] = key
        if cache is not None and key is not None:
            hit = cache.get(key)
            if hit is not None:
                sym_of = {c: self._sym_for(node, c) for _, c in node.assignments}
                scans[id(node)] = {
                    sym_of[col]: lane for col, lane in hit["merged"].items()
                }
                for col, d in hit["dicts"].items():
                    dicts[sym_of[col]] = d
                counts[id(node)] = hit["total"]
                if hit.get("devgen") is not None:
                    self._devgen[id(node)] = hit["devgen"]
                return
        conn = self.catalogs.get(node.catalog)
        cols = [c for _, c in node.assignments]
        if self._try_device_generation(conn, node, cols, splits, key, cache,
                                       scans, dicts, counts):
            return
        provider = conn.page_source_provider()
        tmap = dict(node.types)
        sym_of = {c: self._sym_for(node, c) for c in cols}
        pages: List[Page] = []
        for sp in splits:
            src = provider.create_page_source(sp, cols)
            for page in src.pages():
                src_dicts = src.dictionaries()
                new_cols = []
                for c, col in zip(page.names, page.columns):
                    d = (
                        col.dictionary
                        if col.dictionary is not None
                        else src_dicts.get(c)
                    )
                    new_cols.append(Column(col.type, col.values, col.validity, d))
                pages.append(
                    Page(new_cols, page.count, [sym_of[c] for c in page.names])
                )
        symbols = [sym_of[c] for c in cols]
        types = [(s, tmap[s]) for s in symbols]
        merged, total = merge_pages_to_arrays(pages, symbols, types, dicts)
        for s, t in types:
            if t.is_dictionary and s not in dicts:
                dicts[s] = np.array([], dtype=object)
        scans[id(node)] = merged
        counts[id(node)] = total
        nbytes = sum(
            int(v.nbytes) + (int(ok.nbytes) if ok is not None else 0)
            for v, ok in merged.values()
        )
        if cache is not None and key is not None:
            col_of = {s: c for s, c in node.assignments}
            cache.put(
                key,
                {
                    "merged": {col_of[s]: lane for s, lane in merged.items()},
                    "dicts": {
                        col_of[s]: dicts[s] for s, _ in node.assignments
                        if s in dicts
                    },
                    "total": total, "dev": {},
                },
                nbytes,
            )

    def _try_device_generation(self, conn, node, cols, splits, key, cache,
                               scans, dicts, counts) -> bool:
        """On-device scan materialization: when the connector makes every
        requested column as a pure function of the row index
        (connectors/tpch_device.py), no host array is made; _device_lanes
        generates the lanes on the device.  A scan that reads a column the
        generator cannot make takes the host generator (the connector's
        `supports`), counted as hostGeneratedScans; a generator that fails
        raises."""
        devgen_fn = getattr(conn, "device_generation", None)
        if devgen_fn is None or not self.config.get("device_generation", True):
            return False
        spec = devgen_fn(node.table, cols, splits)
        prof = self.kernel_profile
        if spec is None:
            prof["hostGeneratedScans"] = prof.get("hostGeneratedScans", 0) + 1
            return False
        prof["deviceGeneratedScans"] = prof.get("deviceGeneratedScans", 0) + 1
        sym_of = {c: self._sym_for(node, c) for c in cols}
        count = int(spec["count"])
        merged = {
            sym_of[c]: (_LazyDeviceLane(count * spec["widths"].get(c, 8)), None)
            for c in cols
        }
        tmap = dict(node.types)
        for c, d in spec["dicts"].items():
            dicts[sym_of[c]] = d
        for c in cols:
            s = sym_of[c]
            if tmap[s].is_dictionary and s not in dicts:
                dicts[s] = np.array([], dtype=object)
        scans[id(node)] = merged
        counts[id(node)] = count
        self._devgen[id(node)] = spec
        if cache is not None and key is not None:
            col_of = {s: c for s, c in node.assignments}
            cache.put(
                key,
                {"merged": {col_of[s]: merged[s] for s in merged},
                 "dicts": dict(spec["dicts"]), "total": count, "dev": {},
                 "devgen": spec},
                sum(lane[0].nbytes for lane in merged.values()),
            )
        return True

    def _generate_device_scan(self, spec: dict, syms, sym_to_col):
        """Run the connector's on-device generator for one scan; returns
        {symbol: (values, ok)} on this executor's device."""
        from ..connectors import tpch_device

        from .streaming import DEVGEN_TEMP_LANES

        cols = [sym_to_col.get(s, s) for s in syms]
        self._devgen_temp_bytes += int(spec["count"]) * 8 * DEVGEN_TEMP_LANES
        parts = [
            tpch_device.device_lanes(
                spec["table"], cols, int(lo), int(hi), float(spec["sf"]),
                int(n), self.device,
            )
            for lo, hi, n in spec["ranges"]
        ]
        if len(parts) == 1:
            lanes = parts[0]
        else:  # the splits' contiguous runs, in split order
            lanes = {
                c: (torch.cat([p[c][0] for p in parts]),
                    torch.cat([p[c][1] for p in parts]))
                for c in cols
            }
        return {s: lanes[c] for s, c in zip(syms, cols)}

    def _device_lanes(self, node: P.TableScan, arrays, count):
        """Upload one scan's host arrays to device lanes (page-locked
        copies on CUDA), reusing device tensors cached by an earlier
        query of the same versioned scan."""
        staged = getattr(self, "_preuploaded", None)
        if staged and id(node) in staged:
            # copied ahead on the prefetch thread's stream: order this
            # stream after the copies, and tell the caching allocator the
            # tensors are used here
            lanes, event = staged.pop(id(node))
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for v, ok in lanes.values():
                    v.record_stream(stream)
                    ok.record_stream(stream)
            return lanes
        cache: Optional[DeviceScanCache] = (
            self.config.get("scan_cache") or getattr(self, "_streaming_cache", None)
        )
        key = self._scan_keys.get(id(node))
        entry = cache.get(key, record=False) if (cache is not None and key) else None
        sym_to_col = dict(getattr(node, "assignments", ()))
        dev = self.device
        lanes = {}
        generated = None
        for sym, (arr, valid) in arrays.items():
            col = sym_to_col.get(sym, sym)
            if entry is not None and col in entry["dev"]:
                lanes[sym] = entry["dev"][col]
                continue
            if isinstance(arr, _LazyDeviceLane):
                if generated is None:  # every missing lane in one pass
                    lazy = [s for s, (a, _v) in arrays.items()
                            if isinstance(a, _LazyDeviceLane)
                            and not (entry is not None
                                     and sym_to_col.get(s, s) in entry["dev"])]
                    generated = self._generate_device_scan(
                        self._devgen[id(node)], lazy, sym_to_col)
                lanes[sym] = generated[sym]
                if entry is not None:
                    entry["dev"][col] = generated[sym]
                continue
            v = D.to_device(arr, dev, pin=True)
            if valid is None:
                ok = torch.ones(count, dtype=torch.bool, device=dev)
            else:
                ok = D.to_device(valid, dev, pin=True)
            lanes[sym] = (v, ok)
            if entry is not None:
                entry["dev"][col] = (v, ok)
        return lanes

    @staticmethod
    def _sym_for(scan: P.TableScan, col: str) -> str:
        for s, c in scan.assignments:
            if c == col:
                return s
        raise KeyError(col)

    def _megakernel_mode(self) -> str:
        """Effective fused scan->filter->aggregate mode: 'on'/'off'.
        Session prop `megakernels`: 'auto' fuses where the CUDA kernel
        runs (on for a CUDA device, off on the CPU); 'on' forces fusion
        (the kernel's plain version on the CPU — how the parity tests
        drive the fused path); 'off' disables."""
        v = str(self.config.get("megakernels", "auto") or "auto").lower()
        if v not in ("auto", "on", "off"):
            v = "auto"
        if v == "auto":
            return "on" if self.device.type == "cuda" else "off"
        return v

    def _record_kernel(
        self, digest: str, compile_s: float, cached: bool, mode: str = "eager",
    ) -> dict:
        """Accumulate one program execution into kernel_profile."""
        kernels: List[dict] = self.kernel_profile["kernels"]  # type: ignore[assignment]
        rec = None
        for k in kernels:
            if k["digest"] == digest:
                rec = k
                break
        if rec is None:
            rec = {"digest": digest, "mode": mode, "compiles": 0,
                   "compileWallS": 0.0, "executions": 0, "cacheHits": 0}
            kernels.append(rec)
        rec["executions"] += 1
        if cached:
            rec["cacheHits"] += 1
        else:
            rec["compiles"] += 1
            rec["compileWallS"] += compile_s
        return rec

    # ------------------------------------------------------------------
    def _new_ctx(self, scans, counts) -> "_TraceCtx":
        return _TraceCtx(self, scans, counts)

    def _run(self, plan: P.Output, ctx: "_TraceCtx"):
        batch = ctx.visit(plan.source)
        out = {s: batch.lanes[s] for s in plan.symbols}
        return out, batch.sel

    def _materialize_host(self, plan: P.Output, host_lanes) -> Page:
        types = plan.source.output_types()
        cols = []
        n = 0
        for name, sym in zip(plan.names, plan.symbols):
            vals, valid = host_lanes[sym]
            n = vals.shape[0]
            t = types[sym]
            if getattr(t, "wide", False) and vals.ndim == 1:
                # lane-narrow/type-wide: widen so clients decode two limbs
                vals = np.stack([vals, vals >> np.int64(63)], axis=-1)
            validity = None if valid.all() else valid
            cols.append(Column(t, vals, validity, self.dicts.get(sym)))
        return Page(cols, n, list(plan.names))


def timed_visit(ex: LocalExecutor, node: P.PlanNode, run, batches_of):
    """EXPLAIN ANALYZE instrumentation (OperatorContext timing) of one
    operator visit: `run()` makes its output, whose batches (one, or one
    a mesh shard) `batches_of` lists.  The wall is inclusive of the
    children (obs/opstats subtracts); the enqueue-to-sync split
    approximates host vs device wall."""
    t0 = time.perf_counter()
    out = run()
    t1 = time.perf_counter()
    ex._sync()
    t2 = time.perf_counter()
    st = ex.node_stats.setdefault(
        id(node), {"rows": 0, "bytes": 0, "wall_s": 0.0,
                   "device_wall_s": 0.0, "calls": 0})
    batches = batches_of(out)
    rows = sum(int(b.sel.sum()) for b in batches)
    cap = sum(int(b.sel.shape[0]) for b in batches)
    lane_bytes = sum(_tensor_bytes(v) + _tensor_bytes(ok)
                     for b in batches for v, ok in b.lanes.values())
    st["rows"] = rows
    # logical bytes: the lanes' footprint scaled by the live fraction
    st["bytes"] = int(lane_bytes * rows / cap) if cap else lane_bytes
    st["wall_s"] += t2 - t0
    st["device_wall_s"] += t2 - t1
    st["calls"] += 1
    return out


class _TraceCtx:
    """One run of the plan's operators (the JAX package's trace)."""

    # a mesh shard's context runs these visitors over its shard: the
    # mesh fuses an aggregate across shards before they run, and a
    # broadcast build side is built once for the shards of a device
    # (_build_once)
    allow_fusion = True

    def __init__(self, ex: LocalExecutor, scans, counts):
        self.ex = ex
        self.scans = scans
        self.counts = counts
        # BIGINT sum-accumulator overflow flags (decimal sums are exact
        # via wide chunk accumulators; bigint wrap raises loudly)
        self.sum_overflow: List[torch.Tensor] = []
        # (join node, violation/duplicate count) and grouping collision
        # counts: read by the executor's retry ladder after the run
        self.dup_checks: List[Tuple[P.Join, torch.Tensor]] = []
        self.collision_checks: List[torch.Tensor] = []
        self.lowering = LoweringContext(ex.dicts)
        self.lowering.force_wide_mul = ex.force_wide_mul
        self.lowering.memo = ex.config.get("projection_memo")
        # the breadcrumbs of the operators being visited (innermost last)
        self._crumbs: List[Breadcrumb] = []

    def visit(self, node: P.PlanNode) -> Batch:
        name = type(node).__name__
        m = getattr(self, f"_visit_{name.lower()}", None)
        if m is None:
            raise ExecutionError(f"{name} is not in this slice of the port")
        ex = self.ex
        # one supervised step per operator: its breadcrumb names the
        # operator and gains its inputs' shapes as its children return
        parent = self._crumbs[-1] if self._crumbs else None
        bc = Breadcrumb(f"op:{name}", query_id=ex.query_id,
                        task_id=str(ex.config.get("task_id") or ""),
                        mode="operator", hbm_reserved_bytes=ex.device_bytes)
        self._crumbs.append(bc)
        try:
            b = ex.supervisor.dispatch(lambda: self._visit_timed(node, m), bc)
        finally:
            self._crumbs.pop()
        if parent is not None:
            parent.shapes[f"{name}#{len(parent.shapes)}"] = (
                f"rows({b.sel.shape[0]}) lanes({len(b.lanes)})")
        return b

    def _visit_timed(self, node: P.PlanNode, m) -> Batch:
        if not self.ex.config.get("collect_node_stats"):
            return m(node)
        return timed_visit(self.ex, node, lambda: m(node), lambda b: [b])

    # -- leaves ---------------------------------------------------------
    def _visit_tablescan(self, node: P.TableScan) -> Batch:
        count = self.counts[id(node)]
        lanes = self.ex._device_lanes(node, self.scans[id(node)], count)
        sel = torch.ones(count, dtype=torch.bool, device=self.ex.device)
        return Batch(dict(lanes), sel)

    def _visit_remotesource(self, node: P.RemoteSource) -> Batch:
        """Exchange input of a fragment (exec/fragment_exec.py): the
        merged remote pages load like a scan."""
        return self._visit_tablescan(node)

    def _visit_values(self, node: P.Values) -> Batch:
        n = len(node.rows)
        dev = self.ex.device
        lanes = {}
        tmap = dict(node.types_)
        for sym, d in getattr(node, "dicts", ()):
            # array entries are tuples: one object per entry
            self.ex.dicts[sym] = _object_array(d)
        for i, sym in enumerate(node.symbols):
            colvals = [r[i] for r in node.rows]
            t = tmap[sym]
            ok = np.zeros(n, dtype=bool)
            if getattr(t, "wide", False):
                from ..ops.wide_decimal import from_python_int

                arr = np.zeros((n, 2), dtype=np.int64)
                for j, v in enumerate(colvals):
                    if v is not None:
                        arr[j, 0], arr[j, 1] = from_python_int(int(v))
                        ok[j] = True
            else:
                arr = np.zeros(n, dtype=t.np_dtype)
                for j, v in enumerate(colvals):
                    if v is not None:
                        arr[j] = v
                        ok[j] = True
            lanes[sym] = (D.to_device(arr, dev), D.to_device(ok, dev))
        sel = torch.ones(n, dtype=torch.bool, device=dev)
        return Batch(lanes, sel)

    # -- unary ----------------------------------------------------------
    def _visit_sample(self, node: P.Sample) -> Batch:
        """TABLESAMPLE (BERNOULLI and SYSTEM alike): a deterministic mask
        of the source batch's positions (sample_keep).  The source is the
        table scan itself: no filter or compaction sits below it."""
        b = self.visit(node.source)
        keep = sample_keep(b.sel.shape[0], node.fraction, b.sel.device)
        return Batch(b.lanes, b.sel & keep, b.ordered)

    def _visit_unnest(self, node: P.Unnest) -> Batch:
        """CROSS / LEFT JOIN UNNEST [WITH ORDINALITY] (unnest_lanes)."""
        b = self.visit(node.source)
        entries = self.ex.dicts.get(node.array_symbol)
        if entries is None:
            raise ExecutionError(
                f"no dictionary for array column {node.array_symbol}"
            )
        if getattr(node.element_type, "is_array", False):
            raise ExecutionError("UNNEST of nested arrays is not supported")
        flat = memoized(self.lowering, ("unnest", node.element_type), entries,
                        lambda: FlatArrays(entries, node.element_type))
        lanes, d = unnest_lanes(b.lanes, b.sel, node, flat)
        if d is not None:
            self.ex.dicts[node.element_symbol] = d
        n = lanes[node.element_symbol][0].shape[0]
        return Batch(lanes, torch.ones(n, dtype=torch.bool, device=b.sel.device))

    def _visit_matchrecognize(self, node: P.MatchRecognize) -> Batch:
        """MATCH_RECOGNIZE: the selected rows sorted on the device by the
        partition keys (ascending, NULLs last) and the ORDER BY keys,
        ties in row order (the JAX package's stable comparator sort;
        varchar keys by lexicographic rank), copied to the host once and
        handed to the row-at-a-time matcher (ops/matcher.py) one
        partition at a time; the matches come back as device lanes."""
        from ..ops.matcher import find_matches
        from ..page import column_from_pylist

        b = self.visit(node.source)
        keys = [sort_ops.SortKey(s) for s in node.partition_by] + [
            sort_ops.SortKey(k.column, k.ascending, bool(k.nulls_first))
            for k in node.order_by
        ]
        keys = self._rank_sort_keys(keys, b)
        n = int(b.sel.sum())
        rows = sort_ops.sort_perm(keys, b.lanes, b.sel)[:n]
        # partition starts: a partition key's validity or value changes
        brk = torch.zeros(n, dtype=torch.bool, device=rows.device)
        for k in keys[: len(node.partition_by)]:
            v, ok = b.lanes[k.column]
            v, ok = v[rows], ok[rows]
            if n:
                brk[1:] |= (ok[1:] != ok[:-1]) | (ok[1:] & (v[1:] != v[:-1]))
        if n:
            brk[0] = True
        starts = D.to_numpy(torch.nonzero(brk).flatten()).tolist() + [n]
        src_types = node.source.output_types()
        cols: Dict[str, list] = {}
        for sym in node.source.output_symbols():
            if sym not in b.lanes:
                continue
            v, ok = b.lanes[sym]
            vv, oo = D.to_numpy(v[rows]), D.to_numpy(ok[rows])
            t = src_types[sym]
            if t.is_dictionary and not getattr(t, "is_array", False):
                d = self.ex.dicts.get(sym)
                strs = _object_array([str(x) for x in d])
                live = oo & (vv >= 0)
                col = np.full(n, None, dtype=object)
                col[live] = strs[vv[live]]
                cols[sym] = col.tolist()
            else:
                col = vv.tolist()
                for i in np.flatnonzero(~oo):
                    col[i] = None
                cols[sym] = col
        defines = dict(node.defines)
        measures = [(s, e) for s, e, _ in node.measures]
        all_rows = node.rows_per_match == "all"
        out_rows: List[dict] = []
        for i, j in zip(starts[:-1], starts[1:]):
            pcols = {c: vals[i:j] for c, vals in cols.items()}
            pkey = tuple(cols[s][i] for s in node.partition_by)
            for m in find_matches(pcols, j - i, node.pattern, defines, measures,
                                  node.after_match, all_rows):
                if all_rows:
                    r = m.pop("__row__")
                    for c in pcols:
                        m[c] = pcols[c][r]
                else:
                    for s, v in zip(node.partition_by, pkey):
                        m[s] = v
                out_rows.append(m)
        total = len(out_rows)
        dev = self.ex.device
        out_types = node.output_types()
        lanes = {}
        for sym in node.output_symbols():
            t = out_types[sym]
            vals = [m.get(sym) for m in out_rows]
            if t.is_dictionary and not getattr(t, "is_array", False):
                col = column_from_pylist(t, vals)
                self.ex.dicts[sym] = col.dictionary
                arr = np.asarray(col.values)
                okv = (np.ones(total, bool) if col.validity is None
                       else np.asarray(col.validity))
            else:
                arr = np.array([0 if x is None else x for x in vals],
                               dtype=t.np_dtype)
                okv = np.array([x is not None for x in vals], dtype=bool)
            lanes[sym] = (D.to_device(arr, dev), D.to_device(okv, dev))
        return Batch(lanes, torch.ones(total, dtype=torch.bool, device=dev))

    def _maybe_compact(self, b: Batch, node) -> Batch:
        """Gather the survivors of a selective filter (the optimizer's
        compact_rows estimate) into dense lanes.  Eager execution knows
        the exact survivor count, so no capacity check is needed."""
        est = getattr(node, "compact_rows", None)
        if est is None or b.ordered:
            return b
        n = b.sel.shape[0]
        if int(est * 1.3) >= n:
            return b
        from ..ops.filter_project import permute_lanes

        idx = torch.nonzero(b.sel).flatten()
        lanes = permute_lanes(b.lanes, idx)
        sel = torch.ones(idx.shape[0], dtype=torch.bool, device=b.sel.device)
        return Batch(lanes, sel, b.ordered)

    def _visit_filter(self, node: P.Filter) -> Batch:
        b = self.visit(node.source)
        f = compile_expr(node.predicate, self.lowering)
        v, ok = f(b.lanes)
        out = Batch(b.lanes, b.sel & v & ok, b.ordered)
        return self._maybe_compact(out, node)

    def _visit_project(self, node: P.Project) -> Batch:
        b = self.visit(node.source)
        out = {}
        for sym, e in node.assignments:
            out[sym] = compile_expr(e, self.lowering)(b.lanes)
            if isinstance(e, ir.ColumnRef) and e.name in self.ex.dicts:
                self.ex.dicts[sym] = self.ex.dicts[e.name]
            else:
                d = self.lowering.dict_for_expr(e)
                if d is not None:
                    self.ex.dicts[sym] = d
                elif e.type.is_dictionary and _is_null_expr(e):
                    self.ex.dicts[sym] = np.array([], dtype=object)
        return Batch(out, b.sel, b.ordered)

    def _visit_limit(self, node: P.Limit) -> Batch:
        b = self.visit(node.source)
        lanes, sel = sort_ops.limit(b.lanes, b.sel, node.count, node.offset)
        return Batch(lanes, sel, b.ordered)

    def _visit_distinct(self, node: P.Distinct) -> Batch:
        b = self.visit(node.source)
        key_lanes = [b.lanes[s] for s in node.output_symbols()]
        return self._distinct_rows(b.lanes, b.sel, key_lanes)

    def _distinct_rows(self, lanes, sel, key_lanes) -> Batch:
        """First row of each distinct key tuple, on the hash-sort
        grouping (rows permuted into group order)."""
        n = sel.shape[0]
        perm, gid, _ = self._group_sort(key_lanes, sel, max(n, 1))
        from ..ops.filter_project import permute_lanes

        return Batch(permute_lanes(lanes, perm), sel[perm] & _run_heads(gid))

    def _visit_groupid(self, node: P.GroupId) -> Batch:
        """GROUPING SETS row expansion: every selected row once per
        grouping set, with the grouping keys a set lacks masked to NULL
        and a [0..G) group-id lane telling the copies apart.  The JAX
        package tiles whole padded lanes G times; here the selected rows
        are gathered first, so memory grows G-fold over them only (the
        rows keep their order, so the pages are the same)."""
        b = self.visit(node.source)
        dev = b.sel.device
        G = len(node.sets)
        idx = torch.nonzero(b.sel).flatten()
        n = idx.shape[0]
        key_union = {s for st in node.sets for s in st}
        lanes = {}
        for sym, (v, ok) in b.lanes.items():
            v2 = v[idx].repeat((G,) + (1,) * (v.dim() - 1))
            ok2 = ok[idx].repeat(G)
            if sym in key_union and any(sym not in st for st in node.sets):
                keep = torch.tensor([sym in st for st in node.sets],
                                    dtype=torch.bool, device=dev)
                ok2 = ok2 & keep.repeat_interleave(n)
            lanes[sym] = (v2, ok2)
        gid = torch.arange(G, dtype=torch.int64, device=dev).repeat_interleave(n)
        lanes[node.gid_symbol] = (gid, torch.ones(G * n, dtype=torch.bool,
                                                  device=dev))
        return Batch(lanes, torch.ones(G * n, dtype=torch.bool, device=dev))

    # -- aggregation ------------------------------------------------------
    def _visit_aggregate(self, node: P.Aggregate) -> Batch:
        """All three steps (AggregationNode.java:346): SINGLE and PARTIAL
        accumulate raw rows (PARTIAL emits the accumulator columns);
        FINAL and INTERMEDIATE merge shipped accumulator columns."""
        if node.step in ("single", "partial") and self.allow_fusion:
            from ..ops import megakernel

            fused = megakernel.try_fused(self, node)
            if fused is not None:
                return fused
        b = self.visit(node.source)
        types = node.source.output_types()
        b, aggs = self._agg_dict_setup(node, b)
        all_specs = [a.to_spec() for a in aggs]
        # array_agg / map_agg / listagg build their values on the host
        host_specs = [s for s in all_specs if s.kind in agg_ops.HOST_STAGED_KINDS]
        specs = [s for s in all_specs if s.kind not in agg_ops.HOST_STAGED_KINDS]
        final = node.step in ("final", "intermediate")  # merges accumulators
        partial = node.step in ("partial", "intermediate")  # emits them
        if host_specs and (final or partial):
            raise ExecutionError("host-staged aggregates cannot split PARTIAL/FINAL")

        def host_lanes(out, lanes, gid, sel, cap):
            for hs in host_specs:
                out[hs.output], self.ex.dicts[hs.output] = agg_ops.host_staged_lanes(
                    hs, lanes, gid, sel, cap, self.ex.dicts)
            return out

        def reduce_rows(lanes, gid, sel, cap, seg=None):
            if final:
                acc_in = {n: lanes[n] for s in specs for n in s.accumulator_names}
                return agg_ops.merge_accumulators(
                    specs, acc_in, gid, sel, cap, overflow_flags=self.sum_overflow,
                )
            return agg_ops.accumulate(
                specs, lanes, gid, sel, cap,
                step="partial" if partial else "single",
                overflow_flags=self.sum_overflow,
                wide_flags=self.lowering.overflow_flags,
                force_wide=self.lowering.force_wide_mul,
                seg=seg,
            )

        def out_lanes(accs):
            if partial:
                return {n: (v, torch.ones(v.shape[0], dtype=torch.bool, device=v.device))
                        for n, v in accs.items()}
            return agg_ops.finalize(specs, accs)

        if not node.keys:
            gid = torch.zeros(b.sel.shape[0], dtype=torch.int64, device=b.sel.device)
            lanes = out_lanes(reduce_rows(b.lanes, gid, b.sel, 1))
            host_lanes(lanes, b.lanes, gid, b.sel, 1)
            present = torch.ones(1, dtype=torch.bool, device=b.sel.device)
            return self._finish_aggregate(node, [], lanes, present, 1)
        key_lanes = [b.lanes[k] for k in node.keys]
        domains = self._direct_domains(node.keys, types)
        if domains is not None:
            gid, cap = agg_ops.direct_group_ids(key_lanes, domains)
            accs = reduce_rows(b.lanes, gid, b.sel, cap)
            present = agg_ops._seg_count(b.sel, gid, cap) > 0
            keys_out = agg_ops.group_keys_output(key_lanes, gid, b.sel, cap)
            host_src = (b.lanes, gid, b.sel)
        else:
            # hash-sort grouping.  Eager execution knows the group count,
            # so the capacity is exactly it: ids sorted with capacity n
            # and clipped to ngroups - 1 are those the JAX package gets
            # at any capacity >= ngroups
            n = b.sel.shape[0]
            perm, gid, ngroups = self._group_sort(key_lanes, b.sel, max(n, 1))
            cap = max(int(ngroups), 1)
            gid = torch.clamp(gid, max=cap - 1)
            sel_sorted = b.sel[perm]
            from ..ops.filter_project import permute_lanes

            sorted_lanes = permute_lanes(b.lanes, perm)
            # gid is sorted: one shared run-range computation replaces
            # per-aggregate scatters (SortedSegments)
            ss = agg_ops.SortedSegments(gid, cap)
            accs = reduce_rows(sorted_lanes, gid, sel_sorted, cap, seg=ss)
            present = torch.arange(cap, device=gid.device) < ngroups
            keys_out = agg_ops.group_keys_output(
                [sorted_lanes[k] for k in node.keys], gid, sel_sorted, cap,
                starts=ss.starts,
            )
            host_src = (sorted_lanes, gid, sel_sorted)
        out = host_lanes(out_lanes(accs), *host_src, cap)
        return self._finish_aggregate(node, keys_out, out, present, cap)

    def _fused_partials(self, scan: P.TableScan, run):
        """The fused megakernel's (term, group) sums over the scan's batch
        (`run` launches it) and the batch; the mesh merges the shards'."""
        b = self.visit(scan)
        return run(b), b

    def _build_once(self, node, kind: str, build):
        """A join's lookup source; a mesh shard shares a replicated build
        side's with the other shards of its device."""
        return build()

    def _finish_aggregate(self, node, keys_out, out, present, cap):
        """Shared aggregate tail (unfused and megakernel paths): merge
        key and output lanes; `present` selects the live groups."""
        lanes = {}
        for k, kl in zip(node.keys, keys_out):
            lanes[k] = kl
        for s in out:
            lanes[s] = out[s]
        return Batch(lanes, present)

    def _agg_dict_setup(self, node: P.Aggregate, b: Batch):
        """Dictionary handling for ordering/value-carrying aggregates:
        min/max over varchar and the varchar ordering key of
        min_by/max_by compare lexicographic ranks of the codes (the
        sorted dictionary is registered for a min/max output), and
        value-carrying aggregates (arbitrary, the min_by/max_by value)
        keep the input's dictionary.  At the raw steps the dictionaries
        are also registered for the $val/$key accumulator columns, so
        PARTIAL pages stay decodable; the merge steps read them back."""
        raw_step = node.step in ("single", "partial")
        dicts = self.ex.dicts
        lanes = None

        def rank_lane(sym: str):
            nonlocal lanes
            d = dicts.get(sym)
            if d is None or len(d) == 0:
                return sym, d if d is not None else np.array([], dtype=object)

            def ranks():
                order = np.argsort(np.array([str(x) for x in d]))
                rank = np.empty(len(d), dtype=np.int32)
                rank[order] = np.arange(len(d), dtype=np.int32)
                return order, rank

            order, rank = memoized(self.lowering, "agg-rank", d, ranks)
            v, ok = b.lanes[sym]
            rk = torch.as_tensor(rank, device=v.device)[
                torch.clamp(v.to(torch.int64), 0, len(d) - 1)
            ]
            rsym = sym + "$rank"
            if lanes is None:
                lanes = dict(b.lanes)
            lanes[rsym] = (torch.where(v >= 0, rk, -1).to(v.dtype), ok)
            return rsym, d[order]

        def carry(a, src):
            """The output (and its $val state) keeps src's dictionary at a
            raw step; a merge step reads it back from $val."""
            if raw_step and src in dicts:
                dicts[a.output] = dicts[f"{a.output}$val"] = dicts[src]
            elif not raw_step and f"{a.output}$val" in dicts:
                dicts[a.output] = dicts[f"{a.output}$val"]

        aggs = []
        for a in node.aggs:
            it, i2t = a.input_type, a.input2_type
            if a.kind in ("min", "max") and it is not None and it.is_dictionary:
                if raw_step:
                    rsym, sorted_d = rank_lane(a.arg)
                    a = dataclasses.replace(a, arg=rsym)
                    dicts[a.output] = dicts[f"{a.output}$val"] = sorted_d
                else:
                    carry(a, None)
            elif a.kind in ("min_by", "max_by"):
                if i2t is not None and i2t.is_dictionary and raw_step:
                    rsym, sorted_d = rank_lane(a.arg2)
                    a = dataclasses.replace(a, arg2=rsym)
                    dicts[f"{a.output}$key"] = sorted_d
                if it is not None and it.is_dictionary:
                    carry(a, a.arg)
            elif a.output_type.is_dictionary:  # arbitrary etc.
                carry(a, a.arg)
            aggs.append(a)
        if lanes is not None:
            b = dataclasses.replace(b, lanes=lanes)
        return b, aggs

    def _direct_domains(self, keys, types) -> Optional[List[int]]:
        domains = []
        prod = 1
        for k in keys:
            t = types[k]
            if t.is_dictionary and k in self.ex.dicts:
                d = len(self.ex.dicts[k])
            elif t.name == "boolean":
                d = 2
            else:
                return None
            domains.append(d)
            prod *= d + 1
        return domains if prod <= 4096 else None

    def _group_sort(self, key_lanes, sel, cap):
        """Salted hash-sort grouping with exact verification; a detected
        locator collision re-runs the plan under a fresh salt (the
        executor's retry ladder), so grouping is always exact."""
        perm, gid, ngroups, coll = agg_ops.sort_group_ids(
            key_lanes, sel, cap, self.ex.group_salt
        )
        self.collision_checks.append(coll)
        return perm, gid, ngroups

    # -- joins -----------------------------------------------------------
    def _visit_join(self, node: P.Join) -> Batch:
        left = self.visit(node.left)
        right = self.visit(node.right)
        out = self._join_batches(node, left, right)
        if node.kind == "inner":
            out = self._maybe_compact(out, node)
        return out

    def _join_batches(self, node: P.Join, left: Batch, right: Batch) -> Batch:
        if node.kind == "cross":
            return self._cross_join(node, left, right)
        if node.expansion or id(node) in self.ex.force_expansion:
            return self._expansion_join(node, left, right)
        # unique-keyed build on right, probe on left
        lkeys = [left.lanes[l] for l, _ in node.criteria]
        rkeys = [right.lanes[r] for _, r in node.criteria]
        self._check_join_dicts(node)
        # JOINT hashing decision: either side being multi-column or wide
        # forces both sides onto the hashed locator + exact verification
        need_verify = join_ops.needs_verification(
            rkeys
        ) or join_ops.needs_verification(lkeys)
        bkey = join_ops.composite_key(rkeys, right.sel, need_verify)
        pkey = join_ops.composite_key(lkeys, left.sel, need_verify)
        if (
            node.direct_domain is not None
            and not need_verify
            and id(node) not in self.ex.force_no_direct
        ):
            # dense-domain direct addressing: one scatter builds, one
            # gather (the direct_probe kernel) probes; a violation or
            # duplicate count retries on the sorted unique kernel
            lo, hi = node.direct_domain
            dsrc = self._build_once(node, "direct", lambda: join_ops.build_direct(
                bkey, right.sel, lo, hi - lo + 1))
            self.dup_checks.append((node, dsrc.violations))
            row, matched = join_ops.probe_direct(dsrc, pkey, left.sel)
        else:
            src = self._build_once(node, "unique",
                                   lambda: join_ops.build_unique(bkey, right.sel))
            self.dup_checks.append((node, src.dup_count))
            row, matched = join_ops.probe(src, pkey, left.sel)
        if need_verify:
            # exact equality on the real key columns: a 64-bit locator
            # collision must reject the candidate, not return a wrong row
            matched = matched & join_ops.verify_rows(rkeys, lkeys, row)
        build_cols = join_ops.gather_build(right.lanes, row, matched)
        lanes = dict(left.lanes)
        lanes.update(build_cols)
        if node.kind == "inner":
            sel = left.sel & matched
        elif node.kind == "left":
            sel = left.sel
        else:
            raise ExecutionError(f"join kind {node.kind} is not in this slice of the port")
        if node.filter is not None:
            f = compile_expr(node.filter, self.lowering)
            v, ok = f(lanes)
            if node.kind == "inner":
                sel = sel & v & ok
            else:
                # left join residual: failed residual nulls the build side
                keep = matched & v & ok
                for name in build_cols:
                    bv, bok = lanes[name]
                    lanes[name] = (bv, bok & keep)
        return Batch(lanes, sel)

    def _expansion_join(self, node: P.Join, left: Batch, right: Batch) -> Batch:
        """General (duplicate-build-key) join: each probe row expanded by
        its candidate count, candidates verified on the real key columns;
        an outer probe row with no surviving candidate emits one
        null-extended row.  Eager execution knows the expanded size, so
        the capacity is the true total."""
        lkeys = [left.lanes[l] for l, _ in node.criteria]
        rkeys = [right.lanes[r] for _, r in node.criteria]
        self._check_join_dicts(node)
        need_verify = join_ops.needs_verification(
            rkeys
        ) or join_ops.needs_verification(lkeys)
        bkey = join_ops.composite_key(rkeys, right.sel, need_verify)
        pkey = join_ops.composite_key(lkeys, left.sel, need_verify)
        src = self._build_once(node, "multi",
                               lambda: join_ops.build_multi(bkey, right.sel))
        counts, lo = join_ops.probe_counts(src, pkey, left.sel)
        if node.kind not in ("inner", "left"):
            raise ExecutionError(
                f"join kind {node.kind} not supported by the expansion "
                "kernel (right/full rewrite to left at planning)"
            )
        outer = node.kind == "left"
        probe_cap = left.sel.shape[0]
        capacity = self.ex._device_get(
            lambda: int((torch.clamp(counts, min=1) if outer else counts).sum()),
            "join capacity", rt.shape_summary({"counts": counts}))
        probe_row, build_row, matched, total, k = join_ops.expand_join_slots(
            src, counts, lo, capacity, outer=outer
        )
        psel = left.sel[probe_row]
        if need_verify:
            matched = matched & join_ops.verify_rows(
                rkeys, lkeys, build_row, probe_row
            )
        from ..ops.filter_project import permute_lanes

        lanes = dict(permute_lanes(left.lanes, probe_row))
        take = join_ops.take  # an empty build side reads zeros
        for s, (v, ok) in right.lanes.items():
            lanes[s] = (take(v, build_row), take(ok, build_row) & matched)
        surviving = matched & psel
        if node.filter is not None:
            f = compile_expr(node.filter, self.lowering)
            v, ok = f(lanes)
            surviving = surviving & v & ok
        if node.kind == "inner":
            sel = surviving
        else:
            hits = torch.zeros(probe_cap, dtype=torch.int64, device=counts.device)
            any_match = hits.index_add_(0, probe_row, surviving.to(torch.int64)) > 0
            within = torch.arange(capacity, device=counts.device) < total
            outer_emit = within & (k == 0) & psel & ~any_match[probe_row]
            sel = surviving | outer_emit
            for s in right.lanes:
                bv, bok = lanes[s]
                lanes[s] = (bv, bok & surviving)
        return Batch(lanes, sel)

    def _check_join_dicts(self, node: P.Join):
        for l, r in node.criteria:
            dl, dr = self.ex.dicts.get(l), self.ex.dicts.get(r)
            if (dl is None) != (dr is None):
                raise ExecutionError(
                    f"join key {l}={r} mixes varchar dictionary and non-dict"
                )
            if dl is not None and dl is not dr and not np.array_equal(dl, dr):
                raise ExecutionError(
                    f"join on varchar keys {l}={r} requires shared dictionary"
                )

    def _cross_join(self, node: P.Join, left: Batch, right: Batch) -> Batch:
        # a side whose plan guarantees at most one row broadcasts
        if _single_row_plan(node.right):
            return self._scalar_cross(left, right)
        if _single_row_plan(node.left):
            return self._scalar_cross(right, left)
        # only small cross joins; replicate rows (rows = left x right)
        rcap = right.sel.shape[0]
        lcap = left.sel.shape[0]
        if rcap * lcap > 1 << 22:
            raise ExecutionError("cross join too large")
        dev = left.sel.device
        li = torch.arange(lcap, device=dev).repeat_interleave(rcap)
        ri = torch.arange(rcap, device=dev).repeat(lcap)
        lanes = {}
        for s, (v, ok) in left.lanes.items():
            lanes[s] = (v[li], ok[li])
        for s, (v, ok) in right.lanes.items():
            lanes[s] = (v[ri], ok[ri])
        return Batch(lanes, left.sel[li] & right.sel[ri])

    def _scalar_cross(self, keep: Batch, single: Batch) -> Batch:
        """Cross join against a <=1-row side: broadcast its first selected
        row onto the kept side (empty single side = empty result)."""
        lanes, has = _broadcast_first_row(keep, single)
        return Batch(lanes, keep.sel & has)

    def _visit_semijoin(self, node: P.SemiJoin) -> Batch:
        """Membership mark (IN / EXISTS); NOT IN / NOT EXISTS are this mark
        under a NOT filter."""
        src = self.visit(node.source)
        filt = self.visit(node.filtering)
        hit = self._semi_hit(node, src, filt)
        lanes = dict(src.lanes)
        lanes[node.output] = (hit, torch.ones_like(hit))
        return Batch(lanes, src.sel, src.ordered)

    def _semi_hit(self, node: P.SemiJoin, src: Batch, filt: Batch):
        """Membership mark; duplicates in the filtering side are fine
        (sorted search, any match counts).  Single-column keys compare the
        real value directly (collision-free); multi-column keys and residual
        predicates go through the expansion path with exact verification."""
        skeys, fkeys = self._semi_keys(node, src, filt)
        if (
            node.filter is not None
            or join_ops.needs_verification(skeys)
            or join_ops.needs_verification(fkeys)
        ):
            return self._semi_hit_expanded(node, src, filt)
        build = self._build_once(node, "multi",
                                 lambda: join_ops.build_multi(fkeys[0], filt.sel))
        counts, _ = join_ops.probe_counts(build, skeys[0], src.sel)
        return counts > 0

    def _semi_keys(self, node: P.SemiJoin, src: Batch, filt: Batch):
        """Source and filtering key lanes.  Varchar keys compare
        dictionary codes, so a source key whose dictionary differs from
        its filtering key's is recoded into the filtering side's codes; a
        value the filtering side lacks gets one past its last code, which
        no filtering row holds.  (The JAX package compares the codes
        as they are: see ROADMAP.md, C.)"""
        from ..expr.functions import dict_gather

        skeys = []
        for s, f in zip(node.source_keys, node.filtering_keys):
            v, ok = src.lanes[s]
            ds, df = self.ex.dicts.get(s), self.ex.dicts.get(f)
            if (ds is None) != (df is None):
                raise ExecutionError(
                    f"semi join key {s}={f} mixes varchar dictionary and non-dict"
                )
            if ds is not None and ds is not df and not np.array_equal(ds, df):
                index = {x: i for i, x in enumerate(df)}
                table = np.array([index.get(x, len(df)) for x in ds], dtype=np.int64)
                v = dict_gather(table, v, -1).to(v.dtype)
            skeys.append((v, ok))
        return skeys, [filt.lanes[f] for f in node.filtering_keys]

    def _semi_hit_expanded(self, node: P.SemiJoin, src: Batch, filt: Batch):
        """Mark join via candidate expansion: expand (source, filtering)
        pairs on the equi-key locator ranges, verify exact key equality,
        evaluate the residual if any, reduce any-match per source row
        (EXISTS with non-equality correlation, e.g. TPC-H Q21).  Eager
        execution knows the pair count, so the capacity is the true
        total."""
        skeys, fkeys = self._semi_keys(node, src, filt)
        need_verify = join_ops.needs_verification(
            fkeys
        ) or join_ops.needs_verification(skeys)
        bkey = join_ops.composite_key(fkeys, filt.sel, need_verify)
        pkey = join_ops.composite_key(skeys, src.sel, need_verify)
        build = self._build_once(node, "multi-expanded",
                                 lambda: join_ops.build_multi(bkey, filt.sel))
        counts, lo = join_ops.probe_counts(build, pkey, src.sel)
        n_src = src.sel.shape[0]
        capacity = self.ex._device_get(lambda: int(counts.sum()), "semi join capacity",
                                       rt.shape_summary({"counts": counts}))
        probe_row, build_row, matched, _, _ = join_ops.expand_join_slots(
            build, counts, lo, capacity
        )
        if need_verify:
            matched = matched & join_ops.verify_rows(
                fkeys, skeys, build_row, probe_row
            )
        pair_ok = matched & src.sel[probe_row]
        if node.filter is not None:
            from ..ops.filter_project import permute_lanes

            lanes = dict(permute_lanes(src.lanes, probe_row))
            take = join_ops.take  # an empty filtering side reads zeros
            for s, (v, ok) in filt.lanes.items():
                lanes[s] = (take(v, build_row), take(ok, build_row) & matched)
            fv, fok = compile_expr(node.filter, self.lowering)(lanes)
            pair_ok = pair_ok & fv & fok
        marks = torch.zeros(n_src, dtype=torch.int64, device=pair_ok.device)
        marks.index_add_(0, probe_row, pair_ok.to(torch.int64))
        return marks > 0

    def _visit_scalarjoin(self, node: P.ScalarJoin) -> Batch:
        """Broadcast the subquery's first selected row onto every source
        row (EnforceSingleRow); no selected row gives NULLs."""
        src = self.visit(node.source)
        lanes, _ = _broadcast_first_row(src, self.visit(node.subquery))
        return Batch(lanes, src.sel, src.ordered)

    # -- ordering --------------------------------------------------------
    def _visit_sort(self, node: P.Sort) -> Batch:
        b = self.visit(node.source)
        keys = self._rank_sort_keys(node.keys, b)
        perm = sort_ops.sort_perm(keys, b.lanes, b.sel)
        lanes, sel = sort_ops.apply_perm(b.lanes, perm, b.sel)
        return Batch(lanes, sel, ordered=True)

    def _visit_topn(self, node: P.TopN) -> Batch:
        b = self.visit(node.source)
        keys = self._rank_sort_keys(node.keys, b)
        lanes, sel, _check = sort_ops.topn(keys, b.lanes, b.sel, node.count)
        return Batch(lanes, sel, ordered=True)

    def _rank_sort_keys(self, keys, b: Batch):
        """Replace dict-coded sort columns by their dense lexicographic
        ranks (equal strings under distinct codes tie)."""
        out = []
        for k in keys:
            d = self.ex.dicts.get(k.column)
            if d is not None and len(d) == 0:
                d = None
            if d is not None:
                ranks = memoized(self.lowering, "sort-rank", d, lambda: _dense_ranks(d))
                v, ok = b.lanes[k.column]
                rank_tbl = torch.as_tensor(ranks, device=v.device)
                safe = torch.clamp(v.to(torch.int64), 0, len(d) - 1)
                rv = torch.where(v >= 0, rank_tbl[safe], -1)
                hidden = f"{k.column}$rank"
                b.lanes[hidden] = (rv, ok)
                out.append(sort_ops.SortKey(hidden, k.ascending, k.nulls_first))
            else:
                out.append(k)
        return out

    # -- window functions ------------------------------------------------
    def _visit_window(self, node: P.Window) -> Batch:
        """WindowOperator: one sort groups partitions and orders peers,
        then every function is a vector program over the sorted lanes
        (ops/window.py)."""
        b = self.visit(node.source)
        part_keys = tuple(sort_ops.SortKey(s) for s in node.partition_by)
        order_keys = tuple(self._rank_sort_keys(node.order_by, b))
        perm = sort_ops.sort_perm(part_keys + order_keys, b.lanes, b.sel)
        lanes, sel = sort_ops.apply_perm(b.lanes, perm, b.sel)
        part_lanes = [lanes[s] for s in node.partition_by]
        ord_lanes = [lanes[k.column] for k in order_keys]
        bounds = window_ops.compute_bounds(part_lanes, ord_lanes, sel)
        for f in node.functions:
            lanes[f.output] = self._window_output(f, lanes, sel, bounds)
            if f.args:
                d = self.ex.dicts.get(f.args[0])
                if d is not None and f.output_type.is_dictionary:
                    self.ex.dicts[f.output] = d
        return Batch(lanes, sel)

    def _window_output(self, f: P.WindowFunc, lanes, sel, b):
        W = window_ops
        if f.kind == "row_number":
            return W.row_number(b)
        if f.kind == "rank":
            return W.rank(b)
        if f.kind == "dense_rank":
            return W.dense_rank(b)
        if f.kind == "percent_rank":
            return W.percent_rank(b, sel)
        if f.kind == "cume_dist":
            return W.cume_dist(b, sel)
        if f.kind == "ntile":
            return W.ntile(b, sel, f.constants[0])
        if f.kind in ("lag", "lead"):
            off, default = f.constants
            return W.shift_value(
                lanes[f.args[0]], b, off, default, f.kind == "lead"
            )
        start, end = W.frame_range(f.frame, b)
        nonempty = end >= start
        if f.kind == "first_value":
            return W.value_at(lanes[f.args[0]], start, nonempty)
        if f.kind == "last_value":
            return W.value_at(lanes[f.args[0]], end, nonempty)
        if f.kind == "nth_value":
            return W.nth_value(lanes[f.args[0]], start, end, f.constants[0])
        if f.kind in ("count", "count_star"):
            lane = lanes[f.args[0]] if f.args else None
            _, cnt = W.framed_sum_count(
                lane, sel, start, end, count_star=f.kind == "count_star"
            )
            return cnt, torch.ones_like(sel)
        if f.kind in ("min", "max"):
            if lanes[f.args[0]][0].dim() == 2:
                # wide (two-limb) decimal lane: limb-wise masked compares
                v, cnt = W.framed_minmax_wide(
                    lanes[f.args[0]], sel, b, f.frame, f.kind
                )
                return torch.where((cnt > 0)[:, None], v, 0), cnt > 0
            v, cnt = W.framed_minmax(lanes[f.args[0]], sel, b, f.frame, f.kind)
            return torch.where(cnt > 0, v, torch.zeros_like(v)), cnt > 0
        if f.kind in ("sum", "avg"):
            return self._window_sum_avg(f, lanes[f.args[0]], sel, start, end)
        raise ExecutionError(f"window function {f.kind} not implemented")

    def _window_sum_avg(self, f: P.WindowFunc, in_lane, sel, start, end):
        W = window_ops
        ot, it_ = f.output_type, f.input_type
        wide_out = getattr(ot, "wide", False)
        if wide_out or in_lane[0].dim() == 2:
            # exact 128-bit windowed decimal sum (chunk prefix sums)
            from ..ops import wide_decimal as wd

            wsum, cnt = W.framed_sum_wide(in_lane, sel, start, end)
            if f.kind == "sum":
                return (wsum if wide_out else wd.narrow(wsum)), cnt > 0
            num = wd.rescale(wsum, ot.scale - it_.scale)
            q = wd.div_round(num, torch.clamp(cnt, min=1))
            return (q if wide_out else wd.narrow(q)), cnt > 0
        ssum, cnt = W.framed_sum_count(in_lane, sel, start, end)
        if f.kind == "sum":
            return ssum, cnt > 0
        den = torch.clamp(cnt, min=1)
        if ssum.is_floating_point():
            v = ssum / den
        elif ot.name in ("double", "real"):
            v = ssum.to(D.torch_dtype(ot.np_dtype)) / den
        elif ot.is_decimal and it_ is not None:
            num = ssum * 10 ** (ot.scale - it_.scale)
            anum = torch.abs(num)
            q = torch.div(anum, den, rounding_mode="floor")
            rem = anum - q * den
            v = torch.sign(num) * (q + (2 * rem >= den).to(torch.int64))
        else:
            v = torch.div(ssum, den, rounding_mode="floor")
        return v, cnt > 0

    # -- set operations --------------------------------------------------
    def _visit_setoperation(self, node: P.SetOperation) -> Batch:
        """UNION [ALL] / INTERSECT / EXCEPT.  Intersect/except use distinct
        semantics via one sort over the concatenated inputs with per-side
        presence counts."""
        if node.kind in ("intersect", "except"):
            return self._intersect_except(node)
        lanes, sel, _ = self._union_lanes(node)
        if node.all:
            return Batch(lanes, sel)
        # UNION DISTINCT via the Distinct path
        return self._distinct_rows(lanes, sel, [lanes[s] for s in node.symbols])

    def _union_lanes(self, node: P.SetOperation):
        """Visit and concatenate all inputs positionally; returns
        (lanes, sel, per-input row counts)."""
        batches = [self.visit(i) for i in node.inputs]
        caps = [b.sel.shape[0] for b in batches]
        lanes = {}
        for pos, (out_sym, (_, t)) in enumerate(zip(node.symbols, node.types_)):
            vs, oks = [], []
            src_syms = [inp.output_symbols()[pos] for inp in node.inputs]
            if t.is_dictionary:
                # re-encode each input's codes into a merged dictionary
                in_dicts = [self.ex.dicts.get(s) for s in src_syms]
                if any(d is None for d in in_dicts):
                    raise ExecutionError("union of non-dict varchar")
                merged: List[str] = []
                index: Dict[str, int] = {}
                remaps = []
                for d in in_dicts:
                    table = np.empty(len(d), dtype=np.int32)
                    for i, s in enumerate(d):
                        if s not in index:
                            index[s] = len(merged)
                            merged.append(s)
                        table[i] = index[s]
                    remaps.append(table)
                self.ex.dicts[out_sym] = np.array(merged, dtype=object)
                from ..expr.functions import dict_gather

                for b, s, tbl in zip(batches, src_syms, remaps):
                    v, ok = b.lanes[s]
                    vs.append(dict_gather(tbl, v, -1).to(torch.int32))
                    oks.append(ok)
            else:
                wide_t = getattr(t, "wide", False)
                for b, s in zip(batches, src_syms):
                    v, ok = b.lanes[s]
                    if wide_t:
                        # inputs may mix two-limb lanes with narrow
                        # fast-path lanes of the same wide type
                        from ..ops.wide_decimal import promote

                        vs.append(promote(v))
                    else:
                        vs.append(v.to(D.torch_dtype(t.np_dtype)))
                    oks.append(ok)
            lanes[out_sym] = (torch.cat(vs), torch.cat(oks))
        sel = torch.cat([b.sel for b in batches])
        return lanes, sel, caps

    def _setop_tag_reduce(self, node, lanes0, sel, tag):
        """INTERSECT/EXCEPT membership over tagged rows: group-sort by the
        full row, per-side presence marks, keep-group predicate,
        first-of-group dedup."""
        key_lanes = [lanes0[s] for s in node.symbols]
        cap = max(sel.shape[0], 1)
        perm, gid, _ = self._group_sort(key_lanes, sel, cap)
        sel_sorted = sel[perm]
        tag_sorted = tag[perm]
        side0 = agg_ops._seg_count(sel_sorted & (tag_sorted == 0), gid, cap) > 0
        side1 = agg_ops._seg_count(sel_sorted & (tag_sorted == 1), gid, cap) > 0
        keep_group = side0 & side1 if node.kind == "intersect" else side0 & ~side1
        from ..ops.filter_project import permute_lanes

        lanes = permute_lanes(lanes0, perm)
        return Batch(lanes, sel_sorted & _run_heads(gid) & keep_group[gid])

    def _intersect_except(self, node: P.SetOperation) -> Batch:
        if node.all:
            raise ExecutionError(
                f"{node.kind.upper()} ALL not supported (DISTINCT only)"
            )
        if len(node.inputs) != 2:
            raise ExecutionError(f"{node.kind} takes two inputs")
        lanes0, sel, caps = self._union_lanes(node)
        dev = sel.device
        tag = torch.cat([
            torch.zeros(caps[0], dtype=torch.int32, device=dev),
            torch.ones(caps[1], dtype=torch.int32, device=dev),
        ])
        return self._setop_tag_reduce(node, lanes0, sel, tag)
