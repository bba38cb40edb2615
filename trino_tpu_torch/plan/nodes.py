"""Logical plan node algebra.

Reference parity: core/trino-main/.../sql/planner/plan/ (~60 node types:
TableScanNode, FilterNode, ProjectNode, AggregationNode, JoinNode,
SemiJoinNode, ExchangeNode, SortNode, TopNNode, LimitNode, OutputNode,
ValuesNode, EnforceSingleRowNode ...).

Expressions inside nodes are typed trino_tpu.expr.ir trees whose ColumnRefs
name *symbols* (SSA-ish unique column names, the reference's Symbol class).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .. import types as T
from ..expr import ir
from ..ops.sort import SortKey


class PlanNode:
    @property
    def sources(self) -> Tuple["PlanNode", ...]:
        return ()

    def output_symbols(self) -> List[str]:
        raise NotImplementedError

    def output_types(self) -> Dict[str, T.Type]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class TableScan(PlanNode):
    catalog: str
    table: str
    # symbol -> source column name
    assignments: Tuple[Tuple[str, str], ...]
    types: Tuple[Tuple[str, T.Type], ...]
    # advisory per-source-column domains derived from the query filter
    # (TupleDomain pushed into the connector — spi/predicate/TupleDomain
    # with both range and DISCRETE ValueSet forms, via
    # ConnectorMetadata/SplitManager constraint): entries are
    # (column, lo, hi) inclusive ranges or (column, lo, hi, values) where
    # `values` is a sorted tuple of the exact admissible values (IN-list
    # pushdown); None = unbounded.  Connectors may prune splits/row-groups;
    # the engine keeps the Filter, so pruning is safe-if-conservative.
    constraint: Tuple[Tuple, ...] = ()

    def output_symbols(self):
        return [s for s, _ in self.assignments]

    def output_types(self):
        return dict(self.types)


@dataclasses.dataclass(frozen=True)
class Values(PlanNode):
    """Literal rows (ValuesNode): symbols + per-row constant tuples.
    Varchar values are stored as dictionary codes with the dictionary in
    `dicts` (symbol -> tuple of strings)."""

    symbols: Tuple[str, ...]
    types_: Tuple[Tuple[str, T.Type], ...]
    rows: Tuple[Tuple[object, ...], ...]
    dicts: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()

    def output_symbols(self):
        return list(self.symbols)

    def output_types(self):
        return dict(self.types_)


@dataclasses.dataclass(frozen=True)
class MatchRecognize(PlanNode):
    """Row pattern recognition (PatternRecognitionNode + window/matcher).
    ONE ROW PER MATCH: output = partition keys + measures."""

    source: PlanNode
    partition_by: Tuple[str, ...]
    order_by: Tuple[SortKey, ...]
    pattern: object  # ast.PatternTerm tree (frozen dataclasses)
    defines: Tuple[Tuple[str, ir.Expr], ...]
    measures: Tuple[Tuple[str, ir.Expr, T.Type], ...]  # (symbol, expr, type)
    after_match: str = "past_last_row"
    # one: partition keys + measures per match; all: every matched input
    # row (all source columns) + measures evaluated at that row (RUNNING)
    rows_per_match: str = "one"

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        if self.rows_per_match == "all":
            return list(self.source.output_symbols()) + [
                s for s, _, _ in self.measures
            ]
        return list(self.partition_by) + [s for s, _, _ in self.measures]

    def output_types(self):
        src = self.source.output_types()
        if self.rows_per_match == "all":
            out = dict(src)
        else:
            out = {s: src[s] for s in self.partition_by}
        for s, _, t in self.measures:
            out[s] = t
        return out


@dataclasses.dataclass(frozen=True)
class Unnest(PlanNode):
    """UNNEST expansion (UnnestNode + operator/unnest/UnnestOperator):
    each input row replicates once per element of its array column; source
    columns carry over, the element column and optional ordinality column
    are appended."""

    source: PlanNode
    array_symbol: str
    element_symbol: str
    element_type: T.Type
    ordinality_symbol: Optional[str] = None
    # LEFT JOIN UNNEST: rows with empty/NULL arrays emit one NULL-element row
    outer: bool = False

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        out = [
            s for s in self.source.output_symbols() if s != self.array_symbol
        ]
        out.append(self.element_symbol)
        if self.ordinality_symbol:
            out.append(self.ordinality_symbol)
        return out

    def output_types(self):
        out = {
            s: t
            for s, t in self.source.output_types().items()
            if s != self.array_symbol
        }
        out[self.element_symbol] = self.element_type
        if self.ordinality_symbol:
            out[self.ordinality_symbol] = T.BIGINT
        return out


@dataclasses.dataclass(frozen=True)
class TableWriter(PlanNode):
    """INSERT/CTAS/DELETE write sink (TableWriterNode + TableFinishNode
    combined: the reference splits writing and commit/stats collection into
    two operators; this engine's sinks commit in finish() so one node
    reports the row count).  `overwrite` rewrites the table with the source
    rows (the DELETE-as-rewrite path); `report_deleted` makes the output row
    count = previous_count - written (DELETE's deleted-rows result)."""

    source: PlanNode
    catalog: str
    table: str
    columns: Tuple[str, ...]  # connector column name per source symbol
    overwrite: bool = False
    report_deleted: bool = False
    # CTAS: (column, Type) schema to create before writing
    create_schema: Optional[Tuple[Tuple[str, T.Type], ...]] = None
    if_not_exists: bool = False
    # UPDATE/MERGE: source marker column for the affected-row count;
    # count_mode "update" sums the marker, "merge" combines marker values
    # (1=updated, 2=inserted) with the before/after row-count delta
    count_symbol: Optional[str] = None
    count_mode: str = "update"

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return ["rows"]

    def output_types(self):
        return {"rows": T.BIGINT}


@dataclasses.dataclass(frozen=True)
class Sample(PlanNode):
    """TABLESAMPLE: keep ~fraction of rows (SampleNode; both BERNOULLI and
    SYSTEM execute as deterministic per-row bernoulli here)."""

    source: PlanNode
    fraction: float

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return self.source.output_symbols()

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass(frozen=True)
class Filter(PlanNode):
    source: PlanNode
    predicate: ir.Expr
    # stats-estimated output rows, set by the optimizer when the filter
    # is selective enough that the executor should COMPACT survivors into
    # a smaller static capacity (cumsum+gather) — every downstream
    # sort/gather then runs at the tightened width.  None = keep the
    # input capacity.  Exactness: the executor checks the true survivor
    # count against the compacted capacity and the retry ladder widens
    # on overflow.
    compact_rows: Optional[int] = None

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return self.source.output_symbols()

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass(frozen=True)
class Project(PlanNode):
    source: PlanNode
    assignments: Tuple[Tuple[str, ir.Expr], ...]

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return [s for s, _ in self.assignments]

    def output_types(self):
        return {s: e.type for s, e in self.assignments}


@dataclasses.dataclass(frozen=True)
class AggInfo:
    output: str
    kind: str  # sum|count|min_by|corr|... (see ops/aggregation.py families)
    arg: Optional[str]  # input symbol
    distinct: bool
    input_type: Optional[T.Type]
    output_type: T.Type
    arg2: Optional[str] = None  # second input (min_by/max_by/corr/regr_*)
    input2_type: Optional[T.Type] = None
    param: Optional[float] = None  # constant parameter (approx_percentile)

    def to_spec(self):
        from ..ops.aggregation import AggSpec

        return AggSpec(
            self.kind, self.arg, self.output, self.input_type,
            self.output_type, self.distinct, self.arg2, self.input2_type,
            self.param,
        )

    def accumulator_schema(self) -> List[Tuple[str, T.Type]]:
        """Intermediate (PARTIAL-step output) columns for this aggregate —
        the analog of the reference's serialized accumulator state shipped
        between PARTIAL and FINAL HashAggregationOperators.  Names come from
        the kernel's AggSpec.accumulator_names (the single source of truth
        for the accumulator layout); only the wire types are decided here."""
        from ..ops import aggregation as A

        names = self.to_spec().accumulator_names
        it = self.input_type
        if it is not None and it.name in ("double", "real"):
            sum_t = T.DOUBLE
        elif it is not None and it.is_decimal:
            sum_t = it
        else:
            sum_t = T.BIGINT
        moment = (
            self.kind in A.MOMENT_KINDS
            or self.kind in A.BINARY_MOMENT_KINDS
            or self.kind == "geometric_mean"
        )

        def type_for(name: str) -> T.Type:
            if (name.endswith("$count") or name.endswith("$valid")
                    or name.endswith("$has") or name.endswith("$n")):
                return T.BIGINT
            base_name = name.rsplit("$", 1)[-1]
            if base_name in ("c0", "c1", "c2", "c3"):
                # wide-decimal 32-bit chunk sums ship as plain int64
                # columns (never as two-limb lanes themselves)
                return T.BIGINT
            base = base_name
            if base.startswith("hll") or base.startswith("ph"):
                return T.BIGINT  # packed HLL registers / sample hashes
            if base.startswith("pv") or base in ("pmin", "pmax"):
                return it if it is not None else T.BIGINT  # sample values
            if moment:  # $sum/$sumsq/$sumlog/$sx... are float moments
                return T.DOUBLE
            if name.endswith("$key"):  # min_by/max_by ordering key
                return self.input2_type if self.input2_type else T.BIGINT
            if self.kind in ("min", "max", "arbitrary", "min_by", "max_by",
                             "approx_percentile"):
                return it if it is not None else T.BIGINT  # $val keeps input
            if self.kind in ("bool_and", "bool_or", "checksum") or (
                self.kind in A.BITWISE_KINDS
            ):
                return T.BIGINT
            return sum_t  # sum's $val / avg's $sum promote

        return [(n, type_for(n)) for n in names]

    @property
    def partializable(self) -> bool:
        from ..ops import aggregation as A

        return not self.distinct and self.kind not in A.NON_DECOMPOSABLE


@dataclasses.dataclass(frozen=True)
class GroupId(PlanNode):
    """GROUPING SETS expansion (GroupIdNode / GroupIdOperator analog):
    replicates every input row once per grouping set, masking grouping-key
    columns absent from that set to NULL, and emits a group-id column that
    the Aggregate above includes in its keys.  The reference remaps symbols
    per set; here validity masks do the same with static shapes (rows ×
    sets)."""

    source: PlanNode
    sets: Tuple[Tuple[str, ...], ...]  # grouping-key symbols per set
    gid_symbol: str

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return list(self.source.output_symbols()) + [self.gid_symbol]

    def output_types(self):
        out = dict(self.source.output_types())
        out[self.gid_symbol] = T.BIGINT
        return out


@dataclasses.dataclass(frozen=True)
class Aggregate(PlanNode):
    """AggregationNode. step follows the reference's PARTIAL/FINAL/SINGLE
    (plan/AggregationNode.java:346); the planner emits SINGLE and the
    fragmenter splits partial/final around exchanges
    (PushPartialAggregationThroughExchange analog)."""

    source: PlanNode
    keys: Tuple[str, ...]
    aggs: Tuple[AggInfo, ...]
    # single | partial | final | intermediate (AggregationNode.java:346-351;
    # intermediate merges partial states and re-emits accumulator columns —
    # the out-of-core/spill merge step)
    step: str = "single"

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        if self.step in ("partial", "intermediate"):
            out = list(self.keys)
            for a in self.aggs:
                out.extend(name for name, _ in a.accumulator_schema())
            return out
        return list(self.keys) + [a.output for a in self.aggs]

    def output_types(self):
        src = self.source.output_types()
        out = {k: src[k] for k in self.keys}
        if self.step in ("partial", "intermediate"):
            for a in self.aggs:
                out.update(dict(a.accumulator_schema()))
            return out
        for a in self.aggs:
            out[a.output] = a.output_type
        return out


@dataclasses.dataclass(frozen=True)
class Join(PlanNode):
    """JoinNode: equi-criteria + optional residual filter."""

    kind: str  # inner | left | cross (right/full planned to left+project)
    left: PlanNode
    right: PlanNode
    criteria: Tuple[Tuple[str, str], ...]  # (left_symbol, right_symbol)
    filter: Optional[ir.Expr] = None
    # build side may contain duplicate join keys -> expansion join kernel
    # (vectorized LookupJoinOperator page building); set by the optimizer
    # from connector uniqueness statistics
    expansion: bool = False
    # exchange placement for the distributed paths, chosen by the optimizer
    # from stats + session join_distribution_type (the
    # DetermineJoinDistributionType / AddExchanges.java:138 decision):
    # "broadcast" replicates the build side (all-gather), "partitioned"
    # hash-repartitions BOTH sides on the join keys (all-to-all); None means
    # executors use their own capacity heuristic
    distribution: Optional[str] = None
    # stats-estimated output rows for post-join compaction (see
    # Filter.compact_rows): selective inner joins tighten the surviving
    # rows into a smaller static capacity before downstream operators
    compact_rows: Optional[int] = None
    # (lo, hi) build-key value bounds for the direct-address (dense
    # domain) lookup table — set by the optimizer when the build key is
    # a stats-proven-unique narrow integer with a bounded domain; the
    # executor probes with ONE gather instead of sort-merge ranks and
    # self-verifies (ops/join.build_direct)
    direct_domain: Optional[Tuple[int, int]] = None

    @property
    def sources(self):
        return (self.left, self.right)

    def output_symbols(self):
        return self.left.output_symbols() + self.right.output_symbols()

    def output_types(self):
        out = dict(self.left.output_types())
        out.update(self.right.output_types())
        return out


@dataclasses.dataclass(frozen=True)
class SemiJoin(PlanNode):
    """SemiJoinNode: marks rows of source whose key(s) appear in the
    filtering source; output adds a boolean symbol.  Multi-key form covers
    decorrelated EXISTS (TransformCorrelatedExistsSubquery analog)."""

    source: PlanNode
    filtering: PlanNode
    source_keys: Tuple[str, ...]
    filtering_keys: Tuple[str, ...]
    output: str
    # residual predicate over (source row, filtering row) pairs — the
    # "mark join" form needed by EXISTS with non-equality correlation
    filter: Optional[ir.Expr] = None

    @property
    def sources(self):
        return (self.source, self.filtering)

    def output_symbols(self):
        return self.source.output_symbols() + [self.output]

    def output_types(self):
        out = dict(self.source.output_types())
        out[self.output] = T.BOOLEAN
        return out


@dataclasses.dataclass(frozen=True)
class ScalarJoin(PlanNode):
    """EnforceSingleRowNode + cross join of a 1-row subquery: attaches the
    subquery's single row's columns to every source row."""

    source: PlanNode
    subquery: PlanNode

    @property
    def sources(self):
        return (self.source, self.subquery)

    def output_symbols(self):
        return self.source.output_symbols() + self.subquery.output_symbols()

    def output_types(self):
        out = dict(self.source.output_types())
        out.update(self.subquery.output_types())
        return out


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """Per-function frame (reference WindowNode.Frame / spi FrameBound)."""

    unit: str = "range"  # rows | range
    start_kind: str = "unbounded_preceding"
    start_offset: int = 0
    end_kind: str = "current"
    end_offset: int = 0


@dataclasses.dataclass(frozen=True)
class WindowFunc:
    """One window function instance (WindowNode.Function analog)."""

    output: str
    kind: str  # row_number|rank|dense_rank|percent_rank|cume_dist|ntile|
    #            lag|lead|first_value|last_value|nth_value|
    #            sum|count|count_star|min|max|avg
    args: Tuple[str, ...]  # input symbols (value argument)
    constants: Tuple[object, ...]  # ntile buckets / lag offset+default / nth
    frame: WindowFrame
    input_type: Optional[T.Type]
    output_type: T.Type


@dataclasses.dataclass(frozen=True)
class Window(PlanNode):
    """WindowNode: adds one output column per function; rows preserved."""

    source: PlanNode
    partition_by: Tuple[str, ...]
    order_by: Tuple[SortKey, ...]
    functions: Tuple[WindowFunc, ...]

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return self.source.output_symbols() + [
            f.output for f in self.functions
        ]

    def output_types(self):
        out = dict(self.source.output_types())
        for f in self.functions:
            out[f.output] = f.output_type
        return out


@dataclasses.dataclass(frozen=True)
class Sort(PlanNode):
    source: PlanNode
    keys: Tuple[SortKey, ...]

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return self.source.output_symbols()

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass(frozen=True)
class TopN(PlanNode):
    source: PlanNode
    keys: Tuple[SortKey, ...]
    count: int

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return self.source.output_symbols()

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass(frozen=True)
class Limit(PlanNode):
    source: PlanNode
    count: int
    offset: int = 0  # skip the first `offset` selected rows (OFFSET n)

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return self.source.output_symbols()

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass(frozen=True)
class Distinct(PlanNode):
    """SELECT DISTINCT; lowered to grouped Aggregate with no aggregates."""

    source: PlanNode

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return self.source.output_symbols()

    def output_types(self):
        return self.source.output_types()


@dataclasses.dataclass(frozen=True)
class SetOperation(PlanNode):
    """Union/intersect/except (UnionNode & friends). Inputs are mapped to
    shared output symbols positionally."""

    kind: str  # union | intersect | except
    all: bool
    inputs: Tuple[PlanNode, ...]
    symbols: Tuple[str, ...]
    types_: Tuple[Tuple[str, T.Type], ...]

    @property
    def sources(self):
        return self.inputs

    def output_symbols(self):
        return list(self.symbols)

    def output_types(self):
        return dict(self.types_)


@dataclasses.dataclass(frozen=True)
class Output(PlanNode):
    """OutputNode: final column names for the client."""

    source: PlanNode
    names: Tuple[str, ...]
    symbols: Tuple[str, ...]

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return list(self.symbols)

    def output_types(self):
        src = self.source.output_types()
        return {s: src[s] for s in self.symbols}


@dataclasses.dataclass(frozen=True)
class RemoteSource(PlanNode):
    """RemoteSourceNode: reads the output of another fragment's tasks over
    the exchange (operator/ExchangeOperator.java:44 pulling via
    DirectExchangeClient.java:56)."""

    fragment_id: int
    symbols: Tuple[str, ...]
    types_: Tuple[Tuple[str, T.Type], ...]

    def output_symbols(self):
        return list(self.symbols)

    def output_types(self):
        return dict(self.types_)


@dataclasses.dataclass(frozen=True)
class Exchange(PlanNode):
    """ExchangeNode (distribution boundary; added by the optimizer's
    AddExchanges analog). partitioning: 'single' gathers everything,
    'hash' repartitions by keys, 'broadcast' replicates."""

    source: PlanNode
    partitioning: str  # single | hash | broadcast
    keys: Tuple[str, ...] = ()

    @property
    def sources(self):
        return (self.source,)

    def output_symbols(self):
        return self.source.output_symbols()

    def output_types(self):
        return self.source.output_types()


def visit_plan(node: PlanNode, fn, depth=0):
    fn(node, depth)
    for s in node.sources:
        visit_plan(s, fn, depth + 1)


def plan_to_string(
    node: PlanNode,
    stats: Optional[dict] = None,
    costs: Optional[dict] = None,
) -> str:
    """EXPLAIN-style textual plan (PlanPrinter analog).  With `stats`
    (id(node) -> {rows, wall_s} from EXPLAIN ANALYZE instrumentation) each
    line is annotated with output rows and exclusive wall time; with
    `costs` (id(node) -> {rows, cpu, net, mem} from plan.cost.annotate)
    each line carries the CBO's estimates (PlanPrinter 'Estimates:')."""
    lines: List[str] = []

    def fmt(n: PlanNode, d: int):
        pad = "  " * d
        name = type(n).__name__
        extra = ""
        if isinstance(n, TableScan):
            extra = f" {n.catalog}.{n.table} {[s for s, _ in n.assignments]}"
            if n.constraint:
                doms = []
                for e in n.constraint:
                    col, lo, hi = e[0], e[1], e[2]
                    if len(e) > 3:
                        doms.append(f"{col} IN {list(e[3])}")
                    else:
                        lo_s = "-inf" if lo is None else f"{lo:g}"
                        hi_s = "inf" if hi is None else f"{hi:g}"
                        doms.append(f"{col}:[{lo_s},{hi_s}]")
                extra += f" constraint({', '.join(doms)})"
        elif isinstance(n, Filter):
            extra = f" {n.predicate!r}"
        elif isinstance(n, Project):
            extra = f" {[s for s, _ in n.assignments]}"
        elif isinstance(n, Aggregate):
            extra = f" keys={list(n.keys)} aggs={[a.output for a in n.aggs]} step={n.step}"
        elif isinstance(n, Join):
            extra = f" {n.kind} on={list(n.criteria)}"
            if n.distribution:
                extra += f" dist={n.distribution}"
            if n.direct_domain:
                extra += f" direct=[{n.direct_domain[0]},{n.direct_domain[1]}]"
        elif isinstance(n, (TopN,)):
            extra = f" n={n.count} keys={[k.column for k in n.keys]}"
        elif isinstance(n, Limit):
            extra = f" n={n.count}"
        elif isinstance(n, Window):
            extra = (
                f" partition={list(n.partition_by)}"
                f" order={[k.column for k in n.order_by]}"
                f" fns={[f.output for f in n.functions]}"
            )
        elif isinstance(n, Exchange):
            extra = f" {n.partitioning} keys={list(n.keys)}"
        elif isinstance(n, RemoteSource):
            extra = f" fragment={n.fragment_id}"
        elif isinstance(n, Output):
            extra = f" {list(n.names)}"
        if costs is not None and id(n) in costs:
            c = costs[id(n)]
            extra += (
                f"  {{rows: {c['rows']:.0f}, bytes: {c.get('bytes', 0.0):.3g}, "
                f"cpu: {c['cpu']:.2g}, "
                f"net: {c['net']:.2g}, mem: {c['mem']:.2g}}}"
            )
        if stats is not None and id(n) in stats:
            st = stats[id(n)]
            child_wall = sum(
                stats[id(s)]["wall_s"] for s in n.sources if id(s) in stats
            )
            own = max(st["wall_s"] - child_wall, 0.0)
            extra += f"  [rows={st['rows']}, wall={own * 1000:.2f}ms]"
        lines.append(f"{pad}{name}{extra}")

    visit_plan(node, fmt)
    return "\n".join(lines)
