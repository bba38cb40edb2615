"""Plan statistics + cost model for the iterative (Memo) optimizer.

Reference parity: sql/planner/cost/ — StatsCalculator (FilterStatsCalculator,
JoinStatsRule) and CostCalculatorUsingExchanges.java:61, reduced to the
decisions this engine's executors actually take: join order, build side,
and broadcast-vs-partitioned distribution.

TPU-first cost shape: compute is XLA sorts/gathers (volume-linear with a
log factor for sorts), the network term is mesh collectives — broadcast =
all_gather of the build side onto every device, partitioned = all_to_all
of both sides once — and the memory term is per-device HBM residency,
which is the binding constraint on a 16 GB chip.  Costs are unitless
"lane-bytes"; only comparisons matter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from .. import types as T
from ..catalog import Metadata
from ..expr import ir
from ..spi import TableStatistics
from . import nodes as P

# FilterStatsCalculator UNKNOWN_FILTER_COEFFICIENT
UNKNOWN_FILTER = 0.3

# cost weights (CostCalculatorUsingExchanges exchange_cost_multiplier
# analog): ICI collective bytes cost ~2x an HBM pass; per-device memory
# residency is discounted but must still break broadcast ties
W_CPU, W_NET, W_MEM = 1.0, 2.0, 0.25


@dataclasses.dataclass(frozen=True)
class Estimate:
    """Output-stats estimate of one plan node (PlanNodeStatsEstimate)."""

    rows: float
    width: float  # bytes per row across output symbols

    @property
    def bytes(self) -> float:
        return self.rows * self.width


@dataclasses.dataclass(frozen=True)
class Cost:
    """Cumulative cost (LocalCostEstimate + exchange terms)."""

    cpu: float = 0.0
    net: float = 0.0
    mem: float = 0.0

    def __add__(self, o: "Cost") -> "Cost":
        return Cost(self.cpu + o.cpu, self.net + o.net, self.mem + o.mem)

    @property
    def total(self) -> float:
        return W_CPU * self.cpu + W_NET * self.net + W_MEM * self.mem


def _width_of(node: P.PlanNode) -> float:
    syms = node.output_symbols()
    types = node.output_types()
    w = 0.0
    for s in syms:
        t = types.get(s)
        w += 16.0 if (t is not None and getattr(t, "wide", False)) else 8.0
    return max(w, 8.0)


class StatsProvider:
    """Per-node output estimates with column NDV tracking (the
    StatsCalculator role).  `resolver` maps GroupRef placeholders to a
    representative node during Memo exploration."""

    def __init__(self, metadata: Metadata, ndev: int = 1, resolver=None):
        self.metadata = metadata
        self.ndev = max(1, ndev)
        self.resolver = resolver
        # cache values hold a strong ref to the keyed node: id() keys of
        # collected temporaries would otherwise be reused by fresh nodes
        # and serve stale estimates
        self._cache: Dict[int, Tuple[P.PlanNode, Estimate]] = {}
        self._ndv_cache: Dict[Tuple[int, str], Tuple[P.PlanNode, float]] = {}

    # -- row estimates ------------------------------------------------
    def estimate(self, node: P.PlanNode) -> Estimate:
        key = id(node)
        if key not in self._cache:
            self._cache[key] = (node, self._estimate(node))
        return self._cache[key][1]

    def _resolve(self, node: P.PlanNode) -> P.PlanNode:
        if self.resolver is not None:
            return self.resolver(node)
        return node

    def _estimate(self, node: P.PlanNode) -> Estimate:
        node = self._resolve(node)
        width = _width_of(node)
        if isinstance(node, P.TableScan):
            st = self.metadata.table_statistics(node.catalog, node.table)
            return Estimate(float(st.row_count), width)
        if isinstance(node, P.Filter):
            base = self.estimate(node.source)
            sel = self._selectivity(node.predicate, node.source)
            return Estimate(base.rows * sel, width)
        if isinstance(node, P.Join):
            return self._join_estimate(node, width)
        if isinstance(node, P.SemiJoin):
            src = self.estimate(node.sources[0])
            return Estimate(src.rows, width)
        if isinstance(node, P.Aggregate):
            src = self.estimate(node.source)
            if not node.keys:
                return Estimate(1.0, width)
            g = 1.0
            for k in node.keys:
                g *= max(1.0, self.ndv(node.source, k))
            return Estimate(min(src.rows, g), width)
        if isinstance(node, (P.TopN, P.Limit)):
            cnt = float(getattr(node, "count", 1))
            src = self.estimate(node.sources[0])
            return Estimate(min(cnt, src.rows), width)
        if isinstance(node, P.Project):
            src = self.estimate(node.source)
            return Estimate(src.rows, width)
        if node.sources:
            rows = max(self.estimate(s).rows for s in node.sources)
            return Estimate(rows, width)
        return Estimate(1.0, width)

    def _join_estimate(self, node: P.Join, width: float) -> Estimate:
        l = self.estimate(node.left)
        r = self.estimate(node.right)
        if node.kind == "cross" or not node.criteria:
            return Estimate(l.rows * r.rows, width)
        # |L JOIN R| = |L|*|R| / max(ndv(keys)) per equi conjunct
        # (JoinStatsRule.java simplified to independent keys)
        rows = l.rows * r.rows
        for a, b in node.criteria:
            ndv = max(
                self.ndv(node.left, a), self.ndv(node.right, b), 1.0
            )
            rows /= ndv
        if node.kind == "left":
            rows = max(rows, l.rows)
        return Estimate(max(rows, 1.0), width)

    # -- NDV ------------------------------------------------------------
    def ndv(self, node: P.PlanNode, symbol: str) -> float:
        node = self._resolve(node)
        key = (id(node), symbol)
        if key not in self._ndv_cache:
            self._ndv_cache[key] = (node, self._ndv(node, symbol))
        return self._ndv_cache[key][1]

    def _ndv(self, node: P.PlanNode, symbol: str) -> float:
        node = self._resolve(node)
        if isinstance(node, P.TableScan):
            col = dict(node.assignments).get(symbol)
            st = self.metadata.table_statistics(node.catalog, node.table)
            cs = st.columns.get(col) if col else None
            if cs is not None and cs.distinct_count:
                return float(cs.distinct_count)
            return max(1.0, float(st.row_count))
        if isinstance(node, P.Project):
            for s, e in node.assignments:
                if s == symbol and isinstance(e, ir.ColumnRef):
                    return self._ndv(node.source, e.name)
            return max(1.0, self.estimate(node).rows)
        if node.sources:
            for s in node.sources:
                if symbol in s.output_symbols() or (
                    self.resolver is not None
                    and symbol in self._resolve(s).output_symbols()
                ):
                    return min(
                        self._ndv(s, symbol), max(1.0, self.estimate(node).rows)
                    )
        return max(1.0, self.estimate(node).rows)

    # -- selectivity -----------------------------------------------------
    def _selectivity(self, pred: ir.Expr, source: P.PlanNode) -> float:
        """Per-conjunct selectivity against scan-column statistics
        (FilterStatsCalculator); 0.3 (UNKNOWN_FILTER) per unrecognized
        conjunct; same-column range pairs combine jointly."""
        return conjunct_list_selectivity(
            _conjuncts(pred), _scan_below(self._resolve(source)), self.metadata
        )

    def _conjunct_selectivity(self, c: ir.Expr, source: P.PlanNode) -> float:
        source = self._resolve(source)
        return conjunct_selectivity(c, _scan_below(source), self.metadata)


class CostModel:
    """Per-node local cost; cumulative costs add over the tree
    (CostCalculatorUsingExchanges: local cost + exchange costs)."""

    def __init__(self, stats: StatsProvider):
        self.stats = stats
        self.ndev = stats.ndev

    def local_cost(self, node: P.PlanNode) -> Cost:
        st = self.stats
        if isinstance(node, P.TableScan):
            e = st.estimate(node)
            return Cost(cpu=e.bytes)
        if isinstance(node, (P.Filter, P.Project)):
            e = st.estimate(node.source)
            return Cost(cpu=e.bytes)
        if isinstance(node, P.Join):
            return self._join_cost(node)
        if isinstance(node, P.SemiJoin):
            src = st.estimate(node.sources[0])
            filt = st.estimate(node.sources[1])
            lg = math.log2(max(src.rows + filt.rows, 2.0))
            return Cost(
                cpu=(src.bytes + filt.bytes) * lg / self.ndev,
                net=filt.bytes,
                mem=filt.bytes,
            )
        if isinstance(node, P.Aggregate):
            e = st.estimate(node.source)
            lg = math.log2(max(e.rows, 2.0)) if node.keys else 1.0
            return Cost(cpu=e.bytes * lg / self.ndev)
        if isinstance(node, (P.Sort, P.TopN)):
            e = st.estimate(node.sources[0])
            return Cost(cpu=e.bytes * math.log2(max(e.rows, 2.0)) / self.ndev)
        if node.sources:
            return Cost(
                cpu=sum(st.estimate(s).bytes for s in node.sources)
            )
        return Cost()

    def _join_cost(self, node: P.Join) -> Cost:
        st = self.stats
        l = st.estimate(node.left)
        r = st.estimate(node.right)
        if node.kind == "cross" or not node.criteria:
            return Cost(cpu=l.bytes * max(r.rows, 1.0), mem=r.bytes)
        lg = math.log2(max(l.rows + r.rows, 2.0))
        # duplicate-key builds run the expansion kernel: extra passes
        # (probe_counts + slot expansion + verification) over the
        # unique-build sort-merge probe
        expand = 2.5 if getattr(node, "expansion", False) else 1.0
        lg *= expand
        dist = node.distribution
        if dist is None:
            # executors default to broadcast under the threshold
            dist = "broadcast"
        if dist == "broadcast":
            # build replicated to every device (all_gather): network and
            # memory scale with ndev; the probe never moves
            return Cost(
                cpu=(l.bytes + r.bytes * self.ndev) * lg / self.ndev,
                net=r.bytes * self.ndev,
                mem=r.bytes * self.ndev,
            )
        # partitioned: both sides cross the mesh once (all_to_all), each
        # device sorts/joins a 1/ndev hash range
        return Cost(
            cpu=(l.bytes + r.bytes) * lg / self.ndev,
            net=l.bytes + r.bytes,
            mem=r.bytes,
        )

    def cumulative(self, node: P.PlanNode) -> Cost:
        c = self.local_cost(node)
        for s in node.sources:
            c = c + self.cumulative(s)
        return c


def annotate(
    plan: P.PlanNode, metadata: Metadata, properties=None
) -> Dict[int, dict]:
    """EXPLAIN cost annotations: id(node) -> {rows, bytes, cpu, net, mem}
    for every node (PlanPrinter's 'Estimates:' lines)."""
    ndev = 1
    if properties is not None and properties.get("distributed"):
        ndev = properties.get("num_devices") or 8
    stats = StatsProvider(effective_metadata(metadata, properties), ndev)
    model = CostModel(stats)
    out: Dict[int, dict] = {}

    def walk(n: P.PlanNode):
        e = stats.estimate(n)
        c = model.local_cost(n)
        out[id(n)] = {
            "rows": e.rows,
            "bytes": e.bytes,
            "cpu": c.cpu,
            "net": c.net,
            "mem": c.mem,
        }
        for s in n.sources:
            walk(s)

    walk(plan)
    return out


# -- selectivity, shared with the greedy optimizer passes ----------------


def _const_float(v) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _const_value(c: Optional[ir.Constant]) -> Optional[float]:
    """Numeric view of a literal in the column's value space: decimals
    carry the *unscaled* int (0.05 -> Const(5:decimal(3,2))), so divide
    the scale back out before comparing against double/float stats."""
    if c is None or c.value is None:
        return None
    v = _const_float(c.value)
    if v is not None and isinstance(c.type, T.DecimalType) and c.type.scale:
        return v / (10.0 ** c.type.scale)
    return v


def _le_fraction(cs, v: float) -> Optional[float]:
    """P(col <= v) over non-null rows: histogram interpolation when
    ANALYZE collected one, else linear against [min, max]."""
    if cs.histogram:
        from ..stats.histogram import le_fraction

        f = le_fraction(cs.histogram, v)
        if f is not None:
            return f
    if cs.min_value is None or cs.max_value is None:
        return None
    lo, hi = float(cs.min_value), float(cs.max_value)
    span = max(hi - lo, 1e-9)
    return min(max((v - lo) / span, 0.0), 1.0)


def _range_fraction(cs, lo: Optional[float], hi: Optional[float]):
    hi_f = _le_fraction(cs, hi) if hi is not None else 1.0
    lo_f = _le_fraction(cs, lo) if lo is not None else 0.0
    if hi_f is None or lo_f is None:
        return None
    return min(1.0, max(0.0, hi_f - lo_f))


def _clamp_sel(s: float) -> float:
    return min(1.0, max(s, 1e-3))


def conjunct_selectivity(
    c: ir.Expr, scan: Optional[P.TableScan], metadata: Metadata
) -> float:
    """Selectivity of one conjunct against the statistics of the scan
    it filters (FilterStatsCalculator): histogram-interpolated range
    fractions for comparisons/BETWEEN, NDV arithmetic for = and IN;
    UNKNOWN_FILTER for anything unrecognized."""
    if scan is None:
        return UNKNOWN_FILTER
    if isinstance(c, ir.Not):
        return _clamp_sel(1.0 - conjunct_selectivity(c.term, scan, metadata))
    assigns = dict(scan.assignments)

    def col_stats(expr):
        if not isinstance(expr, ir.ColumnRef):
            return None
        col = assigns.get(expr.name)
        if col is None:
            return None
        st = metadata.table_statistics(scan.catalog, scan.table)
        return st.columns.get(col)

    if isinstance(c, ir.Between):
        cs = col_stats(c.value)
        lo = _const_value(c.low) if isinstance(c.low, ir.Constant) else None
        hi = _const_value(c.high) if isinstance(c.high, ir.Constant) else None
        if cs is None or lo is None or hi is None:
            return UNKNOWN_FILTER
        frac = _range_fraction(cs, lo, hi)
        if frac is None:
            return UNKNOWN_FILTER
        sel = frac * (1.0 - cs.null_fraction)
        return _clamp_sel(1.0 - sel if c.negate else sel)
    if isinstance(c, ir.In):
        cs = col_stats(c.value)
        if (
            cs is None
            or not cs.distinct_count
            or not c.items
            or not all(isinstance(i, ir.Constant) for i in c.items)
        ):
            return UNKNOWN_FILTER
        distinct = {i.value for i in c.items}
        sel = min(1.0, len(distinct) / max(float(cs.distinct_count), 1.0))
        sel *= 1.0 - cs.null_fraction
        return _clamp_sel(1.0 - sel if c.negate else sel)
    if not isinstance(c, ir.Comparison):
        return UNKNOWN_FILTER
    sym, const, op = _simple_comparison(c)
    if sym is None:
        return UNKNOWN_FILTER
    col = assigns.get(sym)
    if col is None:
        return UNKNOWN_FILTER
    st = metadata.table_statistics(scan.catalog, scan.table)
    cs = st.columns.get(col)
    if cs is None:
        return UNKNOWN_FILTER
    notnull = 1.0 - cs.null_fraction
    v = _const_value(const)
    if v is None:
        # non-numeric constant (varchar): only NDV arithmetic applies
        if op == "=" and cs.distinct_count:
            return _clamp_sel(notnull / float(cs.distinct_count))
        if op in ("<>", "!=") and cs.distinct_count:
            return _clamp_sel(notnull * (1.0 - 1.0 / float(cs.distinct_count)))
        return UNKNOWN_FILTER
    if op == "=":
        if cs.distinct_count:
            return _clamp_sel(notnull / max(float(cs.distinct_count), 1.0))
        return UNKNOWN_FILTER
    if op in ("<>", "!="):
        if cs.distinct_count:
            return _clamp_sel(
                notnull * (1.0 - 1.0 / max(float(cs.distinct_count), 1.0))
            )
        return UNKNOWN_FILTER
    frac = _le_fraction(cs, v)
    if frac is None:
        return UNKNOWN_FILTER
    if op in ("<", "<="):
        return _clamp_sel(frac * notnull)
    if op in (">", ">="):
        return _clamp_sel((1.0 - frac) * notnull)
    return UNKNOWN_FILTER


def _column_stats(scan: P.TableScan, metadata: Metadata, sym: str):
    col = dict(scan.assignments).get(sym)
    if col is None:
        return None
    return metadata.table_statistics(scan.catalog, scan.table).columns.get(col)


def conjunct_list_selectivity(
    conjs, scan: Optional[P.TableScan], metadata: Metadata
) -> float:
    """Product of per-conjunct selectivities (independence assumption) —
    except that opposing inequalities on ONE column collapse into a single
    histogram range fraction: `d >= a AND d < b` is P(a <= d < b), which
    for a year out of a seven-year span is ~0.14, not the ~0.32 the
    two marginals multiply out to."""
    bounds: Dict[str, list] = {}  # sym -> [lo, hi, terms]
    rest = []
    for c in conjs:
        sym = None
        if scan is not None and isinstance(c, ir.Comparison):
            sym, const, op = _simple_comparison(c)
            v = _const_value(const) if sym is not None else None
        if sym is None or v is None or op not in ("<", "<=", ">", ">="):
            rest.append(c)
            continue
        b = bounds.setdefault(sym, [None, None, []])
        if op in ("<", "<="):
            b[1] = v if b[1] is None else min(b[1], v)
        else:
            b[0] = v if b[0] is None else max(b[0], v)
        b[2].append(c)
    sel = 1.0
    for sym, (lo, hi, terms) in bounds.items():
        cs = _column_stats(scan, metadata, sym)
        frac = _range_fraction(cs, lo, hi) if cs is not None else None
        if lo is None or hi is None or frac is None:
            # one-sided or statless: the per-conjunct path handles it
            for t in terms:
                sel *= conjunct_selectivity(t, scan, metadata)
            continue
        sel *= _clamp_sel(frac * (1.0 - cs.null_fraction))
    for c in rest:
        sel *= conjunct_selectivity(c, scan, metadata)
    return max(sel, 1e-6)


def predicate_selectivity(
    pred: ir.Expr, scan: Optional[P.TableScan], metadata: Metadata
) -> float:
    """Selectivity of a whole predicate against its scan's statistics."""
    return conjunct_list_selectivity(_conjuncts(pred), scan, metadata)


class RowCountOnlyMetadata:
    """statistics_enabled=false: every consumer sees bare row counts
    (one wrapper at the single table_statistics choke point gates the
    Memo, the greedy passes, EXPLAIN estimates and FTE re-costing all
    at once)."""

    def __init__(self, metadata: Metadata):
        self._metadata = metadata

    def __getattr__(self, name):
        return getattr(self._metadata, name)

    def table_statistics(self, catalog: str, table: str) -> TableStatistics:
        st = self._metadata.table_statistics(catalog, table)
        return TableStatistics(st.row_count, {})


def effective_metadata(metadata: Metadata, properties=None) -> Metadata:
    if properties is not None and not properties.get("statistics_enabled"):
        return RowCountOnlyMetadata(metadata)
    return metadata


# -- small helpers shared with the memo ---------------------------------


def _conjuncts(e: ir.Expr):
    if isinstance(e, ir.Logical) and e.op == "and":
        out = []
        for t in e.terms:
            out.extend(_conjuncts(t))
        return out
    return [e]


def _scan_below(node: P.PlanNode) -> Optional[P.TableScan]:
    while True:
        if isinstance(node, P.TableScan):
            return node
        if isinstance(node, (P.Filter, P.Project)) and node.sources:
            node = node.sources[0]
            continue
        return None


def _simple_comparison(c: ir.Comparison):
    """(symbol, Constant, op) for col <op> const (either orientation)."""
    flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "="}
    a, b = c.left, c.right
    if isinstance(a, ir.ColumnRef) and isinstance(b, ir.Constant):
        return a.name, b, c.op
    if isinstance(b, ir.ColumnRef) and isinstance(a, ir.Constant):
        if c.op in flip:
            return b.name, a, flip[c.op]
    return None, None, None
