"""Dynamic filtering: build-side domains prune probe-side scans.

Reference parity: server/DynamicFilterService.java:105 (domain summary as a
TupleDomain union), worker-side collection from the join build
(DynamicFilterSourceOperator + JoinDomainBuilder), local application for
broadcast joins (LocalDynamicFiltersCollector), and pushdown into the scan
via the DynamicFilter SPI so the connector prunes rows/splits.

TPU-first placement: in this engine a fragment's build side arrives as
whole exchange pages *before* the probe fragment's XLA program runs, so
domains are computed host-side from the received build pages and applied to
probe scan arrays during load — rows are pruned before they ever occupy
padded device tiles, shrinking both HBM footprint and kernel shapes.

Safety: domains are only derived for INNER equi-joins (probe side may drop
non-matching rows) and for semi-joins whose mark is consumed as a positive
filter directly above; pushdown only descends row-preserving edges
(Filter/Project/inner-probe/Aggregate-group-key/semi-join-source).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..expr import ir
from ..page import Page
from ..plan import nodes as P
from .scan import table_scans

MAX_DISCRETE_VALUES = 100_000


@dataclasses.dataclass
class Domain:
    """Value domain of one build key (spi/predicate/Domain analog)."""

    lo: Optional[float] = None
    hi: Optional[float] = None
    values: Optional[np.ndarray] = None  # discrete int64 set (sorted)
    strings: Optional[Set[str]] = None  # for dictionary columns

    def keep_mask(self, vals: np.ndarray, dictionary=None) -> np.ndarray:
        if self.strings is not None:
            if dictionary is None:
                return np.ones(len(vals), bool)
            ok_code = np.array(
                [str(s) in self.strings for s in dictionary], dtype=bool
            )
            safe = np.clip(vals, 0, max(len(dictionary) - 1, 0))
            return np.where(vals >= 0, ok_code[safe], False)
        keep = np.ones(len(vals), bool)
        if self.lo is not None:
            keep &= vals >= self.lo
        if self.hi is not None:
            keep &= vals <= self.hi
        if self.values is not None:
            keep &= np.isin(vals.astype(np.int64), self.values)
        return keep


def _domain_from_pages(pages: List[Page], symbol: str) -> Optional[Domain]:
    vals_parts, str_set = [], set()
    is_dict = False
    for p in pages:
        if p.count == 0:
            continue
        col = p.by_name(symbol)
        v = np.asarray(col.values)[: p.count]
        if col.validity is not None:
            v = v[np.asarray(col.validity)[: p.count]]
        if col.dictionary is not None:
            is_dict = True
            codes = v[v >= 0]
            str_set.update(str(col.dictionary[c]) for c in np.unique(codes))
        else:
            vals_parts.append(v)
    if is_dict:
        return Domain(strings=str_set)
    if not vals_parts:
        return Domain(lo=1, hi=0)  # empty build side: prune everything
    vals = np.concatenate(vals_parts)
    if vals.dtype.kind not in ("i", "u", "f", "b"):
        return None
    if vals.dtype.kind == "f":
        # NaN build keys never equal any probe key: exclude them from the
        # domain (all-NaN build means nothing can match)
        vals = vals[~np.isnan(vals)]
        if len(vals) == 0:
            return Domain(lo=1, hi=0)
    d = Domain(lo=vals.min(), hi=vals.max())
    if vals.dtype.kind in ("i", "u") and len(vals) <= MAX_DISCRETE_VALUES:
        d.values = np.unique(vals.astype(np.int64))
    return d


def _positive_filter_marks(predicate: ir.Expr) -> Set[str]:
    """Mark symbols required true by a filter predicate (conjuncts that are
    bare ColumnRefs)."""
    out: Set[str] = set()

    def conjuncts(e: ir.Expr):
        if isinstance(e, ir.Logical) and e.op == "and":
            for t in e.terms:
                conjuncts(t)
        else:
            if isinstance(e, ir.ColumnRef):
                out.add(e.name)

    conjuncts(predicate)
    return out


def collect_dynamic_filters(
    plan: P.PlanNode, remote_pages: Dict[int, List[Page]]
) -> Dict[Tuple[int, str], List[Domain]]:
    """Walk a fragment plan; returns {(scan_preorder_index, scan_symbol):
    [domains]} for probe keys whose build side is a RemoteSource with
    fetched pages."""
    scan_index = {id(n): i for i, n in enumerate(table_scans(plan))}

    out: Dict[Tuple[int, str], List[Domain]] = {}

    def push_down(node: P.PlanNode, symbol: str, domain: Domain):
        """Descend row-preserving edges to the defining TableScan."""
        if isinstance(node, P.TableScan):
            if symbol in node.output_symbols():
                out.setdefault((scan_index[id(node)], symbol), []).append(
                    domain
                )
            return
        if isinstance(node, P.Filter):
            push_down(node.source, symbol, domain)
            return
        if isinstance(node, P.Project):
            for sym, e in node.assignments:
                if sym == symbol:
                    if isinstance(e, ir.ColumnRef):
                        push_down(node.source, e.name, domain)
                    return
            return
        if isinstance(node, P.Join):
            if node.kind == "inner" and symbol in node.left.output_symbols():
                push_down(node.left, symbol, domain)
            return
        if isinstance(node, P.SemiJoin):
            if symbol in node.source.output_symbols():
                push_down(node.source, symbol, domain)
            return
        if isinstance(node, P.Aggregate):
            if symbol in node.keys:
                push_down(node.source, symbol, domain)
            return
        # Sort/TopN/Limit/Window/SetOperation/...: stop (row sets or
        # ordering-sensitive below; pruning there could change results)

    def walk(node: P.PlanNode, positive_marks: Set[str]):
        if isinstance(node, P.Filter):
            walk(node.source,
                 positive_marks | _positive_filter_marks(node.predicate))
            return
        if isinstance(node, P.Join) and node.kind == "inner":
            if isinstance(node.right, P.RemoteSource):
                pages = remote_pages.get(node.right.fragment_id, [])
                for probe_sym, build_sym in node.criteria:
                    d = _domain_from_pages(pages, build_sym)
                    if d is not None:
                        push_down(node.left, probe_sym, d)
        if isinstance(node, P.SemiJoin) and node.output in positive_marks:
            if isinstance(node.filtering, P.RemoteSource):
                pages = remote_pages.get(node.filtering.fragment_id, [])
                for src_sym, filt_sym in zip(
                    node.source_keys, node.filtering_keys
                ):
                    d = _domain_from_pages(pages, filt_sym)
                    if d is not None:
                        push_down(node.source, src_sym, d)
        for s in node.sources:
            walk(s, set())

    walk(plan, set())
    return out
