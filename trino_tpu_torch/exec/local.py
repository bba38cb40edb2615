"""Local execution: logical plan -> eager PyTorch operators on one device.

Counterpart of trino_tpu/exec/local.py, for the plans the 22 TPC-H
queries, SELECT DISTINCT, the set operations and window functions
reach.  Where the JAX package traces a whole fragment into one jitted
XLA program over padded lanes, this executor walks the plan and runs
each operator eagerly on the executor's device:
  1. loads splits on the host (numpy), merging per-split dictionaries,
  2. uploads scan columns through page-locked memory and keeps them on
     the device across queries (DeviceScanCache),
  3. runs the operators (filter / project / join / cross join / semi
     join (IN, EXISTS and, under a NOT filter, their negations) / scalar
     join / aggregate, DISTINCT aggregates included — first trying the
     fused megakernel, then direct or hash-sort grouping — / distinct /
     union, intersect, except / window / sort / top-N / limit),
  4. re-runs the plan when a runtime check fails (the JAX package's
     retry ladder): a direct-address join whose build keys break the
     planner's domain/uniqueness proof retries on the sorted unique
     kernel, a duplicate build key then on the expansion join, a
     grouping hash collision under a new salt, and a decimal overflow
     flag with the 128-bit kernels; then copies the selected output rows
     back to the host.

No padding ladder: eager execution has no compile to bound, so lanes
keep their exact row counts, and group and join-expansion capacities
are the true counts (no capacity retries).  Batch representation:
dict[symbol -> (values, valid)] plus a boolean selection mask `sel`.

Not in this slice (ExecutionError / NotImplementedError): unnest,
match_recognize, grouping sets, sample, writes, spill and streaming,
the device supervisor and the mesh executor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as D
from ..catalog import CatalogManager, Metadata
from ..expr import ir
from ..expr.lower import LoweringContext, compile_expr
from ..ops import aggregation as agg_ops
from ..ops import join as join_ops
from ..ops import sort as sort_ops
from ..ops import window as window_ops
from ..page import Column, Page
from ..plan import nodes as P


class DeviceScanCache:
    """Cross-query scan cache: host merged arrays + device lanes.

    Repeated scans of an unchanged (connector-versioned) table reuse the
    uploaded device tensors.  Entries evict in insertion order once the
    byte budget is exceeded: by default a quarter of the card's memory on
    CUDA (the lanes stay resident there beside the queries' working
    memory), 6 GiB of host arrays on the CPU."""

    def __init__(self, max_bytes: Optional[int] = None,
                 device: Optional[torch.device] = None):
        if max_bytes is None:
            max_bytes = 6 << 30
            if device is not None and device.type == "cuda":
                max_bytes = torch.cuda.get_device_properties(device).total_memory // 4
        self.max_bytes = max_bytes
        self.entries: Dict[tuple, dict] = {}
        self.bytes = 0

    def get(self, key: tuple):
        return self.entries.get(key)

    def put(self, key: tuple, entry: dict, nbytes: int):
        while self.bytes + nbytes > self.max_bytes and self.entries:
            oldest = next(iter(self.entries))
            self.bytes -= self.entries.pop(oldest).get("nbytes", 0)
        entry["nbytes"] = nbytes
        self.entries[key] = entry
        self.bytes += nbytes


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
                    remap = np.empty(len(d), dtype=np.int32)
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
        self.dicts: Dict[str, np.ndarray] = {}
        self.force_wide_mul = False

    # ------------------------------------------------------------------
    def execute(self, plan: P.PlanNode) -> Page:
        assert isinstance(plan, P.Output)
        if isinstance(plan.source, P.TableWriter):
            raise ExecutionError("writes are not in this slice of the port")
        scans: Dict[int, dict] = {}
        dicts: Dict[str, np.ndarray] = {}
        counts: Dict[int, int] = {}
        self._load_scans(plan, scans, dicts, counts)
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
            t0 = time.perf_counter()
            ctx = _TraceCtx(self, scans, counts)
            out_lanes, sel = self._run(plan, ctx)
            wides = ctx.lowering.overflow_flags
            fired = (
                int(torch.stack([f.reshape(()) for f in wides]).sum())
                if wides else 0
            )
            self._record_kernel(
                "eager-%d" % attempt, time.perf_counter() - t0, False,
                mode="eager",
            )
            if not self._retry_needed(ctx, fired):
                break
        else:
            raise ExecutionError("the executor's retry ladder did not settle")
        if hints is not None:
            hints[id(plan)] = (
                self.force_wide_mul, plan, frozenset(self.force_expansion),
                frozenset(self.force_no_direct),
            )
            for k in list(hints)[:-512]:
                hints.pop(k, None)
        idx = torch.nonzero(sel).flatten()
        host_lanes = {
            s: (D.to_numpy(out_lanes[s][0][idx]), D.to_numpy(out_lanes[s][1][idx]))
            for s in plan.symbols
        }
        return self._materialize_host(plan, host_lanes)

    def _retry_needed(self, ctx: "_TraceCtx", wide_fired: int) -> bool:
        """Read the run's runtime checks; arm the next rung of the retry
        ladder and return True when the run must be repeated."""
        fell_back = False
        for join_node, dup in ctx.dup_checks:
            if int(dup) > 0:
                if (join_node.direct_domain is not None
                        and id(join_node) not in self.force_no_direct):
                    # direct-table domain/dup proof failed: retry on the
                    # sorted unique kernel first
                    self.force_no_direct.add(id(join_node))
                else:
                    # duplicate build keys: the many-to-many expansion
                    self.force_expansion.add(id(join_node))
                fell_back = True
        for cv in ctx.collision_checks:
            if int(cv) > 0:
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
        for sv in ctx.sum_overflow:
            if int(sv) > 0:
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
                return
        conn = self.catalogs.get(node.catalog)
        cols = [c for _, c in node.assignments]
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

    def _device_lanes(self, node: P.TableScan, arrays, count):
        """Upload one scan's host arrays to device lanes (page-locked
        copies on CUDA), reusing device tensors cached by an earlier
        query of the same versioned scan."""
        cache: Optional[DeviceScanCache] = self.config.get("scan_cache")
        key = self._scan_keys.get(id(node))
        entry = cache.get(key) if (cache is not None and key) else None
        sym_to_col = dict(node.assignments)
        dev = self.device
        lanes = {}
        for sym, (arr, valid) in arrays.items():
            col = sym_to_col.get(sym, sym)
            if entry is not None and col in entry["dev"]:
                lanes[sym] = entry["dev"][col]
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


class _TraceCtx:
    """One run of the plan's operators (the JAX package's trace)."""

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

    def visit(self, node: P.PlanNode) -> Batch:
        m = getattr(self, f"_visit_{type(node).__name__.lower()}", None)
        if m is None:
            raise ExecutionError(
                f"{type(node).__name__} is not in this slice of the port"
            )
        return m(node)

    # -- leaves ---------------------------------------------------------
    def _visit_tablescan(self, node: P.TableScan) -> Batch:
        count = self.counts[id(node)]
        lanes = self.ex._device_lanes(node, self.scans[id(node)], count)
        sel = torch.ones(count, dtype=torch.bool, device=self.ex.device)
        return Batch(dict(lanes), sel)

    def _visit_values(self, node: P.Values) -> Batch:
        n = len(node.rows)
        dev = self.ex.device
        lanes = {}
        tmap = dict(node.types_)
        for sym, d in getattr(node, "dicts", ()):
            self.ex.dicts[sym] = np.array(list(d), dtype=object)
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

    # -- aggregation ------------------------------------------------------
    def _visit_aggregate(self, node: P.Aggregate) -> Batch:
        """SINGLE-step aggregation (PARTIAL/FINAL belong to the
        distributed paths, not in this slice)."""
        if node.step != "single":
            raise ExecutionError(
                f"{node.step} aggregation is not in this slice of the port"
            )
        from ..ops import megakernel

        fused = megakernel.try_fused(self, node)
        if fused is not None:
            return fused
        b = self.visit(node.source)
        types = node.source.output_types()
        b, aggs = self._agg_dict_setup(node, b)
        specs = [a.to_spec() for a in aggs]

        def reduce_rows(lanes, gid, sel, cap, seg=None):
            return agg_ops.accumulate(
                specs, lanes, gid, sel, cap, step="single",
                overflow_flags=self.sum_overflow,
                wide_flags=self.lowering.overflow_flags,
                force_wide=self.lowering.force_wide_mul,
                seg=seg,
            )

        if not node.keys:
            gid = torch.zeros(b.sel.shape[0], dtype=torch.int64, device=b.sel.device)
            lanes = agg_ops.finalize(specs, reduce_rows(b.lanes, gid, b.sel, 1))
            present = torch.ones(1, dtype=torch.bool, device=b.sel.device)
            return self._finish_aggregate(node, [], lanes, present, 1)
        key_lanes = [b.lanes[k] for k in node.keys]
        domains = self._direct_domains(node.keys, types)
        if domains is not None:
            gid, cap = agg_ops.direct_group_ids(key_lanes, domains)
            accs = reduce_rows(b.lanes, gid, b.sel, cap)
            present = agg_ops._seg_count(b.sel, gid, cap) > 0
            keys_out = agg_ops.group_keys_output(key_lanes, gid, b.sel, cap)
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
        out = agg_ops.finalize(specs, accs)
        return self._finish_aggregate(node, keys_out, out, present, cap)

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
        min/max over varchar compare lexicographic ranks of the codes,
        and the sorted dictionary is registered for the output."""
        lanes = None
        aggs = []
        for a in node.aggs:
            it = a.input_type
            if a.kind in ("min", "max") and it is not None and it.is_dictionary:
                d = self.ex.dicts.get(a.arg)
                if d is not None and len(d) > 0:
                    order = np.argsort(np.array([str(x) for x in d]))
                    rank = np.empty(len(d), dtype=np.int32)
                    rank[order] = np.arange(len(d), dtype=np.int32)
                    v, ok = b.lanes[a.arg]
                    rk = torch.as_tensor(rank, device=v.device)[
                        torch.clamp(v.to(torch.int64), 0, len(d) - 1)
                    ]
                    rsym = a.arg + "$rank"
                    if lanes is None:
                        lanes = dict(b.lanes)
                    lanes[rsym] = (torch.where(v >= 0, rk, -1).to(v.dtype), ok)
                    self.ex.dicts[a.output] = d[order]
                    a = dataclasses.replace(a, arg=rsym)
                else:
                    self.ex.dicts[a.output] = (
                        d if d is not None else np.array([], dtype=object)
                    )
            elif a.output_type.is_dictionary and a.arg in self.ex.dicts:
                # value-carrying aggregates (arbitrary) keep the input's
                # dictionary
                self.ex.dicts[a.output] = self.ex.dicts[a.arg]
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
            dsrc = join_ops.build_direct(bkey, right.sel, lo, hi - lo + 1)
            self.dup_checks.append((node, dsrc.violations))
            row, matched = join_ops.probe_direct(dsrc, pkey, left.sel)
        else:
            src = join_ops.build_unique(bkey, right.sel)
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
        src = join_ops.build_multi(bkey, right.sel)
        counts, lo = join_ops.probe_counts(src, pkey, left.sel)
        if node.kind not in ("inner", "left"):
            raise ExecutionError(
                f"join kind {node.kind} not supported by the expansion "
                "kernel (right/full rewrite to left at planning)"
            )
        outer = node.kind == "left"
        probe_cap = left.sel.shape[0]
        capacity = int((torch.clamp(counts, min=1) if outer else counts).sum())
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
        build = join_ops.build_multi(fkeys[0], filt.sel)
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
        build = join_ops.build_multi(bkey, filt.sel)
        counts, lo = join_ops.probe_counts(build, pkey, src.sel)
        n_src = src.sel.shape[0]
        capacity = int(counts.sum())
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
                dd = np.asarray(d, dtype=str)
                order = np.argsort(dd, kind="stable")
                sd = dd[order]
                dense = np.zeros(len(d), dtype=np.int64)
                if len(d) > 1:
                    dense[1:] = np.cumsum(sd[1:] != sd[:-1])
                ranks = np.empty(len(d), dtype=np.int64)
                ranks[order] = dense
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
