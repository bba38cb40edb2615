"""Untyped SQL AST.

Reference parity: core/trino-parser/src/main/java/io/trino/sql/tree/
(289 node classes).  This is the SELECT-core subset that covers TPC-H/
TPC-DS-style analytics: query specification, joins, subqueries, CTEs,
set operations, and the expression grammar.  Nodes are plain dataclasses;
the analyzer (analyzer.py) types them into trino_tpu.expr.ir.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class Node:
    pass


# --- expressions -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Identifier(Node):
    parts: Tuple[str, ...]  # possibly qualified: (table, column)

    def __repr__(self):
        return ".".join(self.parts)


@dataclasses.dataclass(frozen=True)
class Literal(Node):
    kind: str  # 'integer' | 'decimal' | 'string' | 'null' | 'boolean' | 'double'
    value: object

    def __repr__(self):
        return f"{self.value!r}"


@dataclasses.dataclass(frozen=True)
class TypedLiteral(Node):
    """DATE 'x', TIMESTAMP 'x', INTERVAL 'n' unit, DECIMAL 'x'."""

    kind: str
    value: str
    unit: Optional[str] = None  # interval unit


@dataclasses.dataclass(frozen=True)
class UnaryOp(Node):
    op: str  # '-' | '+'
    operand: Node


@dataclasses.dataclass(frozen=True)
class BinaryOp(Node):
    op: str  # + - * / % ||
    left: Node
    right: Node


@dataclasses.dataclass(frozen=True)
class ComparisonOp(Node):
    op: str  # = <> < <= > >=
    left: Node
    right: Node


@dataclasses.dataclass(frozen=True)
class LogicalOp(Node):
    op: str  # 'and' | 'or'
    terms: Tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class NotOp(Node):
    operand: Node


@dataclasses.dataclass(frozen=True)
class IsNullOp(Node):
    operand: Node
    negate: bool


@dataclasses.dataclass(frozen=True)
class BetweenOp(Node):
    value: Node
    low: Node
    high: Node
    negate: bool


@dataclasses.dataclass(frozen=True)
class InList(Node):
    value: Node
    items: Tuple[Node, ...]
    negate: bool


@dataclasses.dataclass(frozen=True)
class InSubquery(Node):
    value: Node
    query: "Query"
    negate: bool


@dataclasses.dataclass(frozen=True)
class Exists(Node):
    query: "Query"
    negate: bool


@dataclasses.dataclass(frozen=True)
class ScalarSubquery(Node):
    query: "Query"


@dataclasses.dataclass(frozen=True)
class LikeOp(Node):
    value: Node
    pattern: Node
    escape: Optional[Node]
    negate: bool


@dataclasses.dataclass(frozen=True)
class FrameBound(Node):
    kind: str  # unbounded_preceding|preceding|current|following|unbounded_following
    value: Optional[Node] = None  # offset expression for k PRECEDING/FOLLOWING


@dataclasses.dataclass(frozen=True)
class WindowFrame(Node):
    unit: str  # rows | range | groups
    start: FrameBound
    end: FrameBound


@dataclasses.dataclass(frozen=True)
class WindowSpec(Node):
    """OVER ( [PARTITION BY ...] [ORDER BY ...] [frame] )"""

    partition_by: Tuple[Node, ...]
    order_by: Tuple["SortItem", ...]
    frame: Optional[WindowFrame] = None


@dataclasses.dataclass(frozen=True)
class FunctionCall(Node):
    name: str
    args: Tuple[Node, ...]
    distinct: bool = False
    is_star: bool = False  # count(*)
    window: Optional[WindowSpec] = None  # OVER clause -> window function


@dataclasses.dataclass(frozen=True)
class CastOp(Node):
    operand: Node
    type_name: str
    safe: bool = False  # try_cast


@dataclasses.dataclass(frozen=True)
class ExtractOp(Node):
    field: str  # year|month|day|quarter
    operand: Node


@dataclasses.dataclass(frozen=True)
class WhenClause(Node):
    condition: Node
    result: Node


@dataclasses.dataclass(frozen=True)
class CaseExpr(Node):
    operand: Optional[Node]  # simple CASE if set
    whens: Tuple[WhenClause, ...]
    default: Optional[Node]


@dataclasses.dataclass(frozen=True)
class ArrayLiteral(Node):
    """ARRAY[e1, e2, ...]"""

    items: Tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class Lambda(Node):
    """x -> expr | (x, y) -> expr (higher-order function argument)."""

    params: Tuple[str, ...]
    body: Node


@dataclasses.dataclass(frozen=True)
class Resolved(Node):
    """Wrapper carrying an already-analyzed ir.Expr through AST analysis
    (used when inlining SQL function bodies: arguments are analyzed in the
    caller's scope first, then spliced into the body)."""

    expr: object


@dataclasses.dataclass(frozen=True)
class Star(Node):
    qualifier: Optional[str] = None  # t.* qualifier


# --- relations ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Table(Node):
    name: Tuple[str, ...]  # (catalog, schema, table) suffix-qualified
    alias: Optional[str] = None
    # TABLESAMPLE (method, percentage); engine treats both methods as
    # BERNOULLI row sampling
    sample: Optional[Tuple[str, float]] = None
    # time travel: FOR VERSION|TIMESTAMP AS OF <expr> -> ("version"|
    # "timestamp", expr); the analyzer resolves it to a pinned snapshot
    version: Optional[Tuple[str, "Node"]] = None


@dataclasses.dataclass(frozen=True)
class TableFunctionRelation(Node):
    """FROM TABLE(fn(arg, ...)) — polymorphic table function invocation
    (spi/function/table + operator/table/TableFunctionOperator)."""

    name: str
    # each arg: ("scalar", expr) | ("table", relation) |
    #           ("descriptor", (col, ...)); optional `name =>` prefixes
    # are resolved positionally
    args: Tuple[Tuple[str, object], ...]
    alias: Optional[str] = None
    columns: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class SubqueryRelation(Node):
    query: "Query"
    alias: Optional[str] = None
    columns: Optional[Tuple[str, ...]] = None  # ") AS t (a, b)" form


@dataclasses.dataclass(frozen=True)
class Join(Node):
    kind: str  # inner | left | right | full | cross
    left: Node
    right: Node
    condition: Optional[Node]  # ON expr (None for cross)
    using: Tuple[str, ...] = ()  # USING (a, b) join columns


@dataclasses.dataclass(frozen=True)
class PatternTerm(Node):
    """One pattern atom: variable or group, with a quantifier."""

    kind: str  # var | group | alt
    var: Optional[str] = None
    items: Tuple["PatternTerm", ...] = ()  # group: sequence; alt: branches
    quantifier: str = ""  # '' | '*' | '+' | '?'
    greedy: bool = True


@dataclasses.dataclass(frozen=True)
class MatchRecognize(Node):
    """t MATCH_RECOGNIZE (PARTITION BY .. ORDER BY .. MEASURES ..
    [ONE ROW PER MATCH] [AFTER MATCH SKIP ..] PATTERN (..) DEFINE ..)
    (SqlBase.g4 patternRecognition; window/matcher NFA in the reference)."""

    relation: Node
    partition_by: Tuple[Node, ...]
    order_by: Tuple["SortItem", ...]
    measures: Tuple[Tuple[Node, str], ...]  # (expr, name)
    pattern: PatternTerm  # top-level sequence
    defines: Tuple[Tuple[str, Node], ...]  # (variable, condition)
    after_match: str = "past_last_row"  # past_last_row | to_next_row
    alias: Optional[str] = None
    rows_per_match: str = "one"  # one | all


@dataclasses.dataclass(frozen=True)
class UnnestRelation(Node):
    """UNNEST(expr, ...) [WITH ORDINALITY] [AS alias (cols)]"""

    exprs: Tuple[Node, ...]
    alias: Optional[str] = None
    columns: Optional[Tuple[str, ...]] = None
    ordinality: bool = False


# --- query structure ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SortItem(Node):
    expr: Node
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = dialect default


@dataclasses.dataclass(frozen=True)
class Rollup(Node):
    """GROUP BY ROLLUP (a, b) — prefix grouping sets (SqlBase.g4 groupingElement)."""

    items: Tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class Cube(Node):
    """GROUP BY CUBE (a, b) — all-subset grouping sets."""

    items: Tuple[Node, ...]


@dataclasses.dataclass(frozen=True)
class GroupingSets(Node):
    """GROUP BY GROUPING SETS ((a, b), (a), ())."""

    sets: Tuple[Tuple[Node, ...], ...]


@dataclasses.dataclass(frozen=True)
class QuerySpec(Node):
    """SELECT ... FROM ... WHERE ... GROUP BY ... HAVING ..."""

    items: Tuple[Node, ...]  # SelectItem | Star
    relation: Optional[Node]
    where: Optional[Node]
    group_by: Tuple[Node, ...]
    having: Optional[Node]
    distinct: bool = False


@dataclasses.dataclass(frozen=True)
class SetOp(Node):
    kind: str  # union | intersect | except
    all: bool
    left: Node  # QuerySpec | SetOp
    right: Node


@dataclasses.dataclass(frozen=True)
class With(Node):
    name: str
    query: "Query"
    columns: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class Query(Node):
    """Full query: [WITH ...] body [ORDER BY ...] [LIMIT n]"""

    body: Node  # QuerySpec | SetOp
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    withs: Tuple[With, ...] = ()
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class ValuesRelation(Node):
    """VALUES (a, b), (c, d) as a query body / inline relation."""

    rows: Tuple[Tuple[Node, ...], ...]


@dataclasses.dataclass(frozen=True)
class CreateTable(Node):
    """CREATE TABLE [IF NOT EXISTS] t (col type, ...)"""

    table: Tuple[str, ...]
    columns: Tuple[Tuple[str, str], ...]  # (name, type text)
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateTableAs(Node):
    """CREATE TABLE [IF NOT EXISTS] t AS query"""

    table: Tuple[str, ...]
    query: Node
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class Insert(Node):
    """INSERT INTO t [(cols)] query"""

    table: Tuple[str, ...]
    columns: Tuple[str, ...]  # () = positional, all table columns
    query: Node


@dataclasses.dataclass(frozen=True)
class Update(Node):
    """UPDATE t SET c = expr, ... [WHERE pred]"""

    table: Tuple[str, ...]
    assignments: Tuple[Tuple[str, Node], ...]
    where: Optional[Node] = None


@dataclasses.dataclass(frozen=True)
class MergeWhen(Node):
    """One WHEN [NOT] MATCHED [AND cond] THEN action clause."""

    matched: bool
    condition: Optional[Node]  # extra AND condition
    action: str  # update | delete | insert
    assignments: Tuple[Tuple[str, Node], ...] = ()  # update
    insert_columns: Tuple[str, ...] = ()  # insert ((), positional)
    insert_values: Tuple[Node, ...] = ()  # insert


@dataclasses.dataclass(frozen=True)
class MergeInto(Node):
    """MERGE INTO target USING source ON cond WHEN ... (MergeWriterNode)."""

    table: Tuple[str, ...]
    target_alias: Optional[str]
    source: Node  # relation
    condition: Node
    whens: Tuple[MergeWhen, ...]


@dataclasses.dataclass(frozen=True)
class Delete(Node):
    """DELETE FROM t [WHERE pred]"""

    table: Tuple[str, ...]
    where: Optional[Node] = None


@dataclasses.dataclass(frozen=True)
class DropTable(Node):
    table: Tuple[str, ...]
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateView(Node):
    """CREATE [OR REPLACE] VIEW v AS query (StatementAnalyzer.java:1027
    visitCreateView analog).  `query_sql` keeps the original text for
    SHOW CREATE VIEW / information_schema, as ViewDefinition.java:28
    stores originalSql."""

    name: Tuple[str, ...]
    query: Node
    query_sql: str
    replace: bool = False


@dataclasses.dataclass(frozen=True)
class DropView(Node):
    name: Tuple[str, ...]
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class ShowCreateView(Node):
    name: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Parameter(Node):
    """Positional ? parameter in a prepared statement."""

    index: int  # 0-based


@dataclasses.dataclass(frozen=True)
class Prepare(Node):
    """PREPARE name FROM statement"""

    name: str
    statement: Node


@dataclasses.dataclass(frozen=True)
class ExecutePrepared(Node):
    """EXECUTE name [USING expr, ...]"""

    name: str
    args: Tuple[Node, ...] = ()


@dataclasses.dataclass(frozen=True)
class Deallocate(Node):
    """DEALLOCATE PREPARE name"""

    name: str


@dataclasses.dataclass(frozen=True)
class Describe(Node):
    """DESCRIBE INPUT name | DESCRIBE OUTPUT name"""

    kind: str  # input | output
    name: str


@dataclasses.dataclass(frozen=True)
class CreateFunction(Node):
    """CREATE [OR REPLACE] FUNCTION name (p type, ...) RETURNS type
    RETURN expr  (SQL routine; reference sql/routine/ + LanguageFunctionManager)"""

    name: str
    params: Tuple[Tuple[str, str], ...]  # (name, type text)
    return_type: str
    body: Node
    replace: bool = False


@dataclasses.dataclass(frozen=True)
class DropFunction(Node):
    name: str
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class ShowFunctions(Node):
    pass


@dataclasses.dataclass(frozen=True)
class ShowCatalogs(Node):
    pass


@dataclasses.dataclass(frozen=True)
class ShowSchemas(Node):
    catalog: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Use(Node):
    """USE catalog | USE catalog.schema"""

    name: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class TransactionControl(Node):
    """START TRANSACTION | COMMIT | ROLLBACK (autocommit engine: START
    and COMMIT are accepted no-ops, ROLLBACK errors — reference
    transaction/TransactionManager runs one transaction per query)."""

    kind: str  # start | commit | rollback


@dataclasses.dataclass(frozen=True)
class ShowStats(Node):
    """SHOW STATS FOR table"""

    table: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Analyze(Node):
    """ANALYZE table [(col, ...)] — collect table/column statistics."""

    table: Tuple[str, ...]
    columns: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ShowCreateTable(Node):
    table: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Explain(Node):
    query: Query
    analyze: bool = False
    plan_type: str = "logical"  # logical | distributed


@dataclasses.dataclass(frozen=True)
class ShowTables(Node):
    catalog: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ShowColumns(Node):
    table: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SetSession(Node):
    name: str = ""
    value: str = ""


@dataclasses.dataclass(frozen=True)
class ShowSession(Node):
    pass


def transform(node, fn):
    """Bottom-up structural rewrite over the AST (nodes + tuples); `fn`
    maps each rebuilt node to its replacement.  Used for prepared-statement
    parameter binding (the reference's ParameterRewriter)."""
    if isinstance(node, Node):
        kwargs = {}
        changed = False
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = transform(v, fn)
            if nv is not v:
                changed = True
            kwargs[f.name] = nv
        node2 = dataclasses.replace(node, **kwargs) if changed else node
        return fn(node2)
    if isinstance(node, tuple):
        out = tuple(transform(x, fn) for x in node)
        if len(out) == len(node) and all(a is b for a, b in zip(out, node)):
            return node
        return out
    return node


def substitute_parameters(node: Node, args) -> Node:
    """Bind ? parameters positionally with the given expression nodes."""

    def fn(n):
        if isinstance(n, Parameter):
            if n.index >= len(args):
                raise ValueError(
                    f"statement has parameter ?{n.index + 1} but only "
                    f"{len(args)} values were supplied"
                )
            return args[n.index]
        return n

    return transform(node, fn)


def count_parameters(node: Node) -> int:
    count = 0

    def fn(n):
        nonlocal count
        if isinstance(n, Parameter):
            count = max(count, n.index + 1)
        return n

    transform(node, fn)
    return count
