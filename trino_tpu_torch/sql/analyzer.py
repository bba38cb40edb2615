"""Analyzer + logical planner: AST -> typed logical plan.

Reference parity: sql/analyzer/StatementAnalyzer.java:423 (+ExpressionAnalyzer,
AggregationAnalyzer, Scope/Field) and sql/planner/LogicalPlanner.java:165
(QueryPlanner, RelationPlanner, SubqueryPlanner).  The reference splits
analysis (producing an Analysis side-table) from planning; here the two are
fused into one bottom-up pass producing plan nodes with typed expr IR —
the Analysis artifacts (resolved types, coercions, aggregate extraction)
are materialized directly in the plan.

Naming: every relation column gets a unique *symbol* (Symbol allocator
analog); scopes map (qualifier, name) -> (symbol, type).

Aggregation planning mirrors QueryPlanner.planGroupByAggregation: group-key
and aggregate-argument expressions are computed in a pre-projection, the
Aggregate node consumes symbols only, and post-aggregation expressions are
rewritten over key/agg output symbols (AggregationAnalyzer's validation
that select expressions are composed of grouping keys and aggregates).

Subqueries: uncorrelated IN -> SemiJoin; uncorrelated EXISTS / scalar ->
ScalarJoin (EnforceSingleRow analog).  Correlated subqueries decorrelate
into multi-key SemiJoins / grouped joins on the correlation keys (the
TransformCorrelated* rules' role — see _plan_exists / _plan_scalar_subquery
below).
"""
from __future__ import annotations

import dataclasses
import datetime
import random as _random
from typing import Dict, List, Optional, Sequence, Tuple

from .. import types as T
from ..catalog import Metadata
from ..expr import ir
from ..expr.functions import arith_result_type, days_from_civil
from ..ops.sort import SortKey
from ..plan import nodes as P
from . import ast

# canonical aggregate kinds (ops/aggregation.py families) + SQL aliases
AGG_ALIASES = {
    "stddev": "stddev_samp",
    "variance": "var_samp",
    "every": "bool_and",
    "any_value": "arbitrary",
}
ONE_ARG_AGGREGATES = {
    "sum", "count", "min", "max", "avg",
    "var_samp", "var_pop", "stddev_samp", "stddev_pop", "geometric_mean",
    "bool_and", "bool_or",
    "bitwise_and_agg", "bitwise_or_agg", "bitwise_xor_agg",
    "checksum", "arbitrary", "count_if", "approx_distinct",
    "array_agg",
}
TWO_ARG_AGGREGATES = {
    "min_by", "max_by", "map_agg", "listagg",
    "covar_pop", "covar_samp", "corr",
    "regr_slope", "regr_intercept",
    "approx_percentile",
}
AGGREGATES = (
    ONE_ARG_AGGREGATES | TWO_ARG_AGGREGATES | set(AGG_ALIASES)
)

WINDOW_ONLY_FUNCTIONS = {
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "ntile", "lag", "lead", "first_value", "last_value", "nth_value",
}

SCALAR_FUNCTIONS = {
    "abs", "sqrt", "round", "floor", "ceil", "ceiling", "year", "month",
    "day", "quarter", "length", "like",
}


class SemanticError(ValueError):
    pass


@dataclasses.dataclass
class Field:
    qualifier: Optional[str]
    name: str
    symbol: str
    type: T.Type


class Scope:
    def __init__(self, fields: List[Field]):
        self.fields = fields

    def resolve(self, parts: Tuple[str, ...]) -> Field:
        if len(parts) == 1:
            matches = [f for f in self.fields if f.name == parts[0]]
        else:
            q, n = parts[-2], parts[-1]
            matches = [
                f for f in self.fields if f.name == n and f.qualifier == q
            ]
        if not matches:
            raise SemanticError(f"column not found: {'.'.join(parts)}")
        if len(matches) > 1:
            raise SemanticError(f"ambiguous column: {'.'.join(parts)}")
        return matches[0]


class SymbolAllocator:
    def __init__(self):
        self._counts: Dict[str, int] = {}

    def new(self, base: str) -> str:
        base = base.lower()[:40] or "expr"
        n = self._counts.get(base, 0)
        self._counts[base] = n + 1
        return base if n == 0 else f"{base}_{n}"


@dataclasses.dataclass
class RelationPlan:
    root: P.PlanNode
    scope: Scope


class Analyzer:
    """One statement analysis+planning session (LogicalPlanner.plan)."""

    def __init__(self, metadata: Metadata, default_catalog: Optional[str],
                 sql_functions: Optional[Dict[str, "SqlFunction"]] = None):
        self.metadata = metadata
        self.default_catalog = default_catalog
        self.symbols = SymbolAllocator()
        self.ctes: Dict[str, ast.Query] = {}
        # CREATE FUNCTION registry (LanguageFunctionManager analog);
        # expanded inline at analysis like the reference inlines SQL
        # routines into the plan (sql/routine/SqlRoutineCompiler inlining)
        self.sql_functions = sql_functions or {}
        self._udf_stack: set = set()
        # correlated-subquery support: while planning a subquery, outer
        # scopes are visible for resolution; outer symbols actually used
        # are recorded per level (ApplyNode correlation list analog)
        self.outer_scopes: List[Scope] = []
        self.correlation_used: List[Dict[str, T.Type]] = []
        # window placeholder symbol -> output type ($w names are not
        # reachable from SQL identifiers, so visibility is harmless
        # across nested query specs)
        self.window_fields: Dict[str, T.Type] = {}
        # id(ast node) -> analyzed ir for window sub-expressions whose
        # aggregates were extracted during _plan_aggregation
        self.win_ir_cache: Dict[int, ir.Expr] = {}
        # stack of analyzed-but-unattached window state (nested specs)
        self._pending_windows: List[tuple] = []

    def _plan_subquery_correlated(self, q: ast.Query, outer: Scope):
        """Plan q with `outer` visible; returns (RelationPlan, names,
        {outer symbol -> type} actually referenced)."""
        self.outer_scopes.append(outer)
        self.correlation_used.append({})
        try:
            rp, names = self.plan_query(q)
            used = self.correlation_used[-1]
        finally:
            self.outer_scopes.pop()
            self.correlation_used.pop()
        return rp, names, used

    # ------------------------------------------------------------------
    def plan_statement(self, stmt: ast.Node) -> P.PlanNode:
        if isinstance(stmt, ast.Query):
            rp, names = self.plan_root_query(stmt)
            return P.Output(
                rp.root, tuple(names), tuple(f.symbol for f in rp.scope.fields)
            )
        if isinstance(stmt, ast.Insert):
            return self._plan_insert(stmt)
        if isinstance(stmt, ast.CreateTableAs):
            return self._plan_ctas(stmt)
        if isinstance(stmt, ast.Delete):
            return self._plan_delete(stmt)
        if isinstance(stmt, ast.Update):
            return self._plan_update(stmt)
        if isinstance(stmt, ast.MergeInto):
            return self._plan_merge(stmt)
        raise SemanticError(f"unsupported statement: {type(stmt).__name__}")

    # -- DML planning (QueryPlanner.planInsert / planDelete analogs) -----
    def _coerced_source(self, rp: RelationPlan, target_types) -> P.PlanNode:
        """Project the query output onto the target column types, inserting
        casts where the analyzer's types differ (implicit INSERT coercion)."""
        assigns = []
        changed = False
        for f, tt in zip(rp.scope.fields, target_types):
            ref: ir.Expr = ir.ColumnRef(f.type, f.symbol)
            if f.type != tt:
                try:
                    ok = f.type.name == "unknown" or T.common_super_type(
                        f.type, tt
                    ) is not None
                except TypeError:
                    ok = False
                if not ok:
                    raise SemanticError(
                        f"cannot insert {f.type} into column of type {tt}"
                    )
                ref = _fold(ir.Cast(tt, ref))
                changed = True
            assigns.append((self.symbols.new("ins"), ref))
        if not changed:
            return rp.root
        return P.Project(rp.root, tuple(assigns))

    def _plan_insert(self, stmt: ast.Insert) -> P.PlanNode:
        catalog, schema = self.metadata.resolve_table(
            stmt.table, self.default_catalog
        )
        if stmt.columns:
            known = {c.name for c in schema.columns}
            targets = []
            for c in stmt.columns:
                if c.lower() not in known:
                    raise SemanticError(
                        f"column {c} not in table {schema.name}"
                    )
                if c.lower() in targets:
                    raise SemanticError(f"duplicate insert column {c}")
                targets.append(c.lower())
        else:
            targets = [c.name for c in schema.columns]
        rp, _ = self.plan_query(stmt.query)
        if len(rp.scope.fields) != len(targets):
            raise SemanticError(
                f"INSERT has {len(rp.scope.fields)} expressions but "
                f"{len(targets)} target columns"
            )
        ttypes = [schema.column_type(c) for c in targets]
        src = self._coerced_source(rp, ttypes)
        writer = P.TableWriter(src, catalog, schema.name, tuple(targets))
        return P.Output(writer, ("rows",), ("rows",))

    def _plan_ctas(self, stmt: ast.CreateTableAs) -> P.PlanNode:
        catalog, table = self.metadata.resolve_new_table(
            stmt.table, self.default_catalog
        )
        if self.metadata.lookup_view(stmt.table, self.default_catalog):
            raise SemanticError(
                f"view with that name already exists: {table}"
            )
        rp, names = self.plan_query(stmt.query)
        seen = set()
        for n in names:
            if n.lower() in seen:
                raise SemanticError(f"duplicate output column name {n}")
            seen.add(n.lower())
        create_schema = tuple(
            (n.lower(), f.type if f.type.name != "unknown" else T.BIGINT)
            for n, f in zip(names, rp.scope.fields)
        )
        writer = P.TableWriter(
            rp.root, catalog, table, tuple(n for n, _ in create_schema),
            create_schema=create_schema,
            if_not_exists=stmt.if_not_exists,
        )
        return P.Output(writer, ("rows",), ("rows",))

    def _plan_update(self, stmt: ast.Update) -> P.PlanNode:
        """UPDATE as whole-table rewrite: each column becomes
        CASE WHEN pred THEN new_value ELSE old END, plus a marker column
        counting changed rows (the reference routes updates through
        MergeWriterNode; rewrite matches this engine's DELETE path)."""
        catalog, schema = self.metadata.resolve_table(
            stmt.table, self.default_catalog
        )
        known = {c.name for c in schema.columns}
        assigned = {}
        for col, expr in stmt.assignments:
            if col.lower() not in known:
                raise SemanticError(f"column {col} not in table {schema.name}")
            if col.lower() in assigned:
                raise SemanticError(f"column {col} assigned twice")
            assigned[col.lower()] = expr
        pred = stmt.where if stmt.where is not None else ast.Literal(
            "boolean", True
        )
        items = []
        for c in schema.columns:
            old = ast.Identifier((c.name,))
            if c.name in assigned:
                e = ast.CaseExpr(
                    None,
                    (ast.WhenClause(pred, assigned[c.name]),),
                    old,
                )
            else:
                e = old
            items.append(ast.SelectItem(e, c.name))
        items.append(
            ast.SelectItem(
                ast.CaseExpr(
                    None,
                    (ast.WhenClause(pred, ast.Literal("integer", 1)),),
                    ast.Literal("integer", 0),
                ),
                "__updated__",
            )
        )
        spec = ast.QuerySpec(
            items=tuple(items),
            relation=ast.Table(stmt.table),
            where=None,
            group_by=(),
            having=None,
        )
        rp, _ = self.plan_query(ast.Query(spec))
        ttypes = [schema.column_type(c.name) for c in schema.columns]
        ttypes.append(T.BIGINT)
        src = self._coerced_source(rp, ttypes)
        count_sym = src.output_symbols()[-1]
        writer = P.TableWriter(
            src, catalog, schema.name,
            tuple(c.name for c in schema.columns),
            overwrite=True, count_symbol=count_sym,
        )
        return P.Output(writer, ("rows",), ("rows",))

    def _plan_merge(self, stmt: ast.MergeInto) -> P.PlanNode:
        """MERGE as whole-table rewrite (the reference's MergeWriterNode
        machinery): kept target rows = target LEFT JOIN source with CASE
        per column (UPDATE) and a keep-predicate (DELETE), UNION ALL the
        NOT-MATCHED inserts from an anti-join; a marker column (1=updated,
        2=inserted) plus the before/after counts yields the affected-row
        count.  First-listed matched clause wins when both apply."""
        catalog, schema = self.metadata.resolve_table(
            stmt.table, self.default_catalog
        )
        talias = stmt.target_alias or schema.name
        upd = dele = ins = None
        order: Dict[str, int] = {}
        for i, w in enumerate(stmt.whens):
            if w.matched and w.action == "update":
                if upd:
                    raise SemanticError("multiple WHEN MATCHED UPDATE clauses")
                upd = w
                order["update"] = i
            elif w.matched and w.action == "delete":
                if dele:
                    raise SemanticError("multiple WHEN MATCHED DELETE clauses")
                dele = w
                order["delete"] = i
            elif not w.matched and w.action == "insert":
                if ins:
                    raise SemanticError("multiple WHEN NOT MATCHED clauses")
                ins = w
            else:
                raise SemanticError(
                    f"WHEN {'MATCHED' if w.matched else 'NOT MATCHED'} THEN "
                    f"{w.action.upper()} is not a valid MERGE clause"
                )
        salias = getattr(stmt.source, "alias", None)
        if salias is None and isinstance(stmt.source, ast.Table):
            salias = stmt.source.name[-1]
        if salias is None:
            raise SemanticError("MERGE source requires an alias")
        known = {c.name for c in schema.columns}
        if upd:
            for col, _ in upd.assignments:
                if col.lower() not in known:
                    raise SemanticError(
                        f"column {col} not in table {schema.name}"
                    )

        TRUE = ast.Literal("boolean", True)

        def and_(*terms):
            terms = [t for t in terms if t is not None]
            if not terms:
                return TRUE
            if len(terms) == 1:
                return terms[0]
            return ast.LogicalOp("and", tuple(terms))

        def not_true(e):
            # NOT (e IS TRUE): false only when e evaluates true
            return ast.LogicalOp(
                "or", (ast.NotOp(e), ast.IsNullOp(e, False))
            )

        marker_col = "__merge_matched__"
        matched = ast.IsNullOp(ast.Identifier((salias, marker_col)), True)
        upd_eff = del_eff = None
        if upd:
            upd_eff = and_(matched, upd.condition)
        if dele:
            del_eff = and_(matched, dele.condition)
        if upd and dele:  # first-listed clause wins
            if order["update"] < order["delete"]:
                guard = upd.condition
                del_eff = (
                    and_(del_eff, not_true(guard)) if guard is not None
                    else ast.Literal("boolean", False)
                )
            else:
                guard = dele.condition
                upd_eff = (
                    and_(upd_eff, not_true(guard)) if guard is not None
                    else ast.Literal("boolean", False)
                )

        wrapped_source = ast.SubqueryRelation(
            ast.Query(ast.QuerySpec(
                items=(ast.Star(),
                       ast.SelectItem(TRUE, marker_col)),
                relation=stmt.source,
                where=None, group_by=(), having=None,
            )),
            alias=salias,
        )
        assigned = {c.lower(): e for c, e in (upd.assignments if upd else ())}
        items = []
        for c in schema.columns:
            base: ast.Node = ast.Identifier((talias, c.name))
            if c.name in assigned and upd_eff is not None:
                base = ast.CaseExpr(
                    None,
                    (ast.WhenClause(upd_eff, assigned[c.name]),),
                    base,
                )
            items.append(ast.SelectItem(base, c.name))
        mark_a: ast.Node = ast.Literal("integer", 0)
        if upd_eff is not None:
            mark_a = ast.CaseExpr(
                None,
                (ast.WhenClause(upd_eff, ast.Literal("integer", 1)),),
                ast.Literal("integer", 0),
            )
        items.append(ast.SelectItem(mark_a, "__merge_marker__"))
        part_a = ast.QuerySpec(
            items=tuple(items),
            relation=ast.Join(
                "left",
                ast.Table(stmt.table, stmt.target_alias),
                wrapped_source,
                stmt.condition,
            ),
            where=not_true(del_eff) if del_eff is not None else None,
            group_by=(), having=None,
        )
        body: ast.Node = part_a
        if ins:
            ins_cols = (
                [c.lower() for c in ins.insert_columns]
                if ins.insert_columns
                else [c.name for c in schema.columns]
            )
            if len(ins_cols) != len(ins.insert_values):
                raise SemanticError(
                    "MERGE INSERT column/value count mismatch"
                )
            for c in ins_cols:
                if c not in known:
                    raise SemanticError(
                        f"column {c} not in table {schema.name}"
                    )
            by_col = dict(zip(ins_cols, ins.insert_values))
            b_items = []
            for c in schema.columns:
                b_items.append(ast.SelectItem(
                    by_col.get(c.name, ast.Literal("null", None)), c.name
                ))
            b_items.append(ast.SelectItem(
                ast.Literal("integer", 2), "__merge_marker__"
            ))
            anti = ast.Exists(
                ast.Query(ast.QuerySpec(
                    items=(ast.SelectItem(ast.Literal("integer", 1)),),
                    relation=ast.Table(stmt.table, stmt.target_alias),
                    where=stmt.condition,
                    group_by=(), having=None,
                )),
                negate=True,
            )
            part_b = ast.QuerySpec(
                items=tuple(b_items),
                relation=stmt.source,
                where=and_(anti, ins.condition),
                group_by=(), having=None,
            )
            body = ast.SetOp("union", True, part_a, part_b)
        rp, _ = self.plan_query(ast.Query(body))
        ttypes = [schema.column_type(c.name) for c in schema.columns]
        ttypes.append(T.BIGINT)
        src = self._coerced_source(rp, ttypes)
        marker_sym = src.output_symbols()[-1]
        writer = P.TableWriter(
            src, catalog, schema.name,
            tuple(c.name for c in schema.columns),
            overwrite=True, count_symbol=marker_sym, count_mode="merge",
        )
        return P.Output(writer, ("rows",), ("rows",))

    def _plan_delete(self, stmt: ast.Delete) -> P.PlanNode:
        catalog, schema = self.metadata.resolve_table(
            stmt.table, self.default_catalog
        )
        # DELETE rows WHERE pred == rewrite with rows where pred IS NOT TRUE
        # (the reference routes row-level deletes through MergeWriterNode;
        # the memory-style connectors here rewrite the table)
        if stmt.where is None:
            keep: Optional[ast.Node] = ast.Literal("boolean", False)
        else:
            keep = ast.LogicalOp(
                "or", (ast.NotOp(stmt.where), ast.IsNullOp(stmt.where, False))
            )
        spec = ast.QuerySpec(
            items=(ast.Star(),),
            relation=ast.Table(stmt.table),
            where=keep,
            group_by=(),
            having=None,
        )
        rp, _ = self.plan_query(ast.Query(spec))
        writer = P.TableWriter(
            rp.root, catalog, schema.name,
            tuple(c.name for c in schema.columns),
            overwrite=True, report_deleted=True,
        )
        return P.Output(writer, ("rows",), ("rows",))

    def plan_root_query(self, q: ast.Query) -> Tuple[RelationPlan, List[str]]:
        rp, names = self.plan_query(q)
        return rp, names

    # ------------------------------------------------------------------
    def plan_query(self, q: ast.Query) -> Tuple[RelationPlan, List[str]]:
        saved = dict(self.ctes)
        for w in q.withs:
            self.ctes[w.name.lower()] = w
        try:
            if isinstance(q.body, ast.QuerySpec):
                rp, names = self.plan_query_spec(
                    q.body, q.order_by, q.limit, q.offset
                )
            else:
                rp, names = self.plan_set_op(q.body)
                rp = self._apply_order_limit(
                    rp, names, q.order_by, q.limit, post_agg=None,
                    offset=q.offset,
                )
            return rp, names
        finally:
            self.ctes = saved

    def plan_values_relation(
        self, v: ast.ValuesRelation
    ) -> Tuple[RelationPlan, List[str]]:
        """VALUES rows -> P.Values (constant folding required; the reference
        additionally allows non-constant rows, out of scope here)."""
        arity = len(v.rows[0])
        for r in v.rows:
            if len(r) != arity:
                raise SemanticError("VALUES rows must all have the same arity")
        dummy = RelationPlan(P.Values((), (), ()), Scope([]))
        ea = ExprAnalyzer(self, dummy)
        cells: List[List[ir.Constant]] = []
        for r in v.rows:
            row = []
            for x in r:
                e = _fold(ea.analyze(x))
                if not isinstance(e, ir.Constant):
                    raise SemanticError("VALUES rows must be constant")
                row.append(e)
            cells.append(row)
        col_types: List[T.Type] = []
        for i in range(arity):
            t = cells[0][i].type
            for row in cells[1:]:
                t = T.common_super_type(t, row[i].type)
            col_types.append(t)
        symbols = tuple(self.symbols.new(f"_col{i}") for i in range(arity))
        dicts: List[Tuple[str, Tuple[str, ...]]] = []
        codes: List[Dict[str, int]] = [dict() for _ in range(arity)]
        out_rows = []
        for row in cells:
            vals = []
            for i, (c, t) in enumerate(zip(row, col_types)):
                if c.value is None:
                    vals.append(None)
                elif t.is_dictionary:
                    entry = (
                        tuple(c.value)
                        if getattr(t, "is_array", False)
                        else str(c.value)
                    )
                    code = codes[i].setdefault(entry, len(codes[i]))
                    vals.append(code)
                elif t.is_decimal:
                    cs = c.type.scale if c.type.is_decimal else 0
                    vals.append(int(c.value) * 10 ** (t.scale - cs)
                                if t.scale >= cs
                                else int(c.value) // 10 ** (cs - t.scale))
                elif t.name in ("double", "real"):
                    cv = c.value
                    if c.type.is_decimal:
                        cv = cv / 10 ** c.type.scale
                    vals.append(float(cv))
                else:
                    vals.append(c.value)
            out_rows.append(tuple(vals))
        for i, t in enumerate(col_types):
            if t.is_dictionary:
                dicts.append((symbols[i], tuple(codes[i])))
        node = P.Values(
            symbols,
            tuple(zip(symbols, col_types)),
            tuple(out_rows),
            tuple(dicts),
        )
        names = [f"_col{i}" for i in range(arity)]
        fields = [
            Field(None, n, s, t)
            for n, s, t in zip(names, symbols, col_types)
        ]
        return RelationPlan(node, Scope(fields)), names

    def plan_set_op(self, s: ast.Node) -> Tuple[RelationPlan, List[str]]:
        if isinstance(s, ast.QuerySpec):
            return self.plan_query_spec(s, (), None)
        if isinstance(s, ast.ValuesRelation):
            return self.plan_values_relation(s)
        if isinstance(s, ast.Query):
            # parenthesized branch with its own ORDER BY / LIMIT
            return self.plan_query(s)
        assert isinstance(s, ast.SetOp)
        lp, lnames = self.plan_set_op(s.left)
        rp, rnames = self.plan_set_op(s.right)
        lt = [f.type for f in lp.scope.fields]
        rt = [f.type for f in rp.scope.fields]
        if len(lt) != len(rt):
            raise SemanticError("set operation arity mismatch")
        out_types = [T.common_super_type(a, b) for a, b in zip(lt, rt)]
        syms = [self.symbols.new(n) for n in lnames]
        node = P.SetOperation(
            s.kind,
            s.all,
            (self._coerce_output(lp, out_types), self._coerce_output(rp, out_types)),
            tuple(syms),
            tuple(zip(syms, out_types)),
        )
        scope = Scope(
            [Field(None, n, sym, t) for n, sym, t in zip(lnames, syms, out_types)]
        )
        return RelationPlan(node, scope), lnames

    def _coerce_output(self, rp: RelationPlan, out_types) -> P.PlanNode:
        assigns = []
        changed = False
        for f, ot in zip(rp.scope.fields, out_types):
            e: ir.Expr = ir.ColumnRef(f.type, f.symbol)
            if f.type != ot:
                e = ir.Cast(ot, e)
                changed = True
            assigns.append((f.symbol, e))
        if not changed:
            return rp.root
        return P.Project(rp.root, tuple(assigns))

    # ------------------------------------------------------------------
    def plan_query_spec(
        self,
        spec: ast.QuerySpec,
        order_by: Tuple[ast.SortItem, ...],
        limit: Optional[int],
        offset: int = 0,
    ) -> Tuple[RelationPlan, List[str]]:
        # FROM
        if spec.relation is None:
            sym = self.symbols.new("dual")
            rel = RelationPlan(
                P.Values((sym,), ((sym, T.BIGINT),), ((0,),)), Scope([])
            )
        else:
            rel = self.plan_relation(spec.relation)

        # WHERE (conjuncts; IN/EXISTS subquery conjuncts become semi joins)
        if spec.where is not None:
            rel = self._plan_where(rel, spec.where)

        # expand stars
        items: List[ast.SelectItem] = []
        for it in spec.items:
            if isinstance(it, ast.Star):
                for f in rel.scope.fields:
                    if it.qualifier is None or f.qualifier == it.qualifier:
                        items.append(
                            ast.SelectItem(
                                ast.Identifier(
                                    (f.qualifier, f.name)
                                    if f.qualifier
                                    else (f.name,)
                                ),
                                None,
                            )
                        )
            else:
                items.append(it)

        # window calls are pulled out of the select items and planned as
        # WindowNodes after aggregation (QueryPlanner.planWindowFunctions)
        win_calls: List[Tuple[str, ast.FunctionCall]] = []
        if any(_contains_window(it.expr) for it in items):
            items = [
                ast.SelectItem(
                    self._rewrite_windows(it.expr, win_calls), it.alias
                )
                for it in items
            ]

        has_aggs = bool(spec.group_by) or any(
            _contains_aggregate(it.expr) for it in items
        ) or (spec.having is not None and _contains_aggregate(spec.having)) or any(
            _contains_aggregate(x)
            for _, c in win_calls
            for x in _window_subexprs(c)
        )

        ea = ExprAnalyzer(self, rel)
        if has_aggs:
            rel, post = self._plan_aggregation(rel, spec, items, ea, win_calls)
            proj_analyzer = post
        else:
            if spec.having is not None:
                raise SemanticError("HAVING without aggregation")
            proj_analyzer = ea
            if win_calls:
                self._analyze_windows(win_calls, ea.analyze)
        if win_calls:
            self._attach_windows(proj_analyzer)

        # SELECT projection
        names: List[str] = []
        assigns: List[Tuple[str, ir.Expr]] = []
        out_fields: List[Field] = []
        for i, it in enumerate(items):
            e = proj_analyzer.analyze(it.expr)
            name = it.alias or _derive_name(it.expr, i)
            sym = self.symbols.new(name)
            names.append(name)
            assigns.append((sym, e))
            out_fields.append(Field(None, name.lower(), sym, e.type))
        rel = RelationPlan(proj_analyzer.relation.root, proj_analyzer.relation.scope)
        proj = P.Project(rel.root, tuple(assigns))
        out = RelationPlan(proj, Scope(out_fields))

        if spec.distinct:
            out = RelationPlan(P.Distinct(out.root), out.scope)

        out = self._apply_order_limit(
            out, names, order_by, limit,
            post_agg=proj_analyzer if has_aggs else None,
            pre_projection=rel,
            select_assigns=assigns,
            offset=offset,
        )
        return out, names

    # ------------------------------------------------------------------
    def _plan_where(self, rel: RelationPlan, where: ast.Node) -> RelationPlan:
        conjuncts = _flatten_and(where)
        plain: List[ast.Node] = []
        for c in conjuncts:
            if isinstance(c, ast.InSubquery):
                rel = self._plan_semijoin(rel, c.value, c.query, c.negate)
            elif isinstance(c, ast.Exists):
                rel = self._plan_exists(rel, c.query, c.negate)
            elif isinstance(c, ast.NotOp) and isinstance(c.operand, ast.Exists):
                rel = self._plan_exists(rel, c.operand.query, not c.operand.negate)
            else:
                plain.append(c)
        if plain:
            ea = ExprAnalyzer(self, rel)
            pred = ea.analyze(_combine_and(plain))
            rel = ea.relation  # scalar joins may have extended the plan
            if pred.type != T.BOOLEAN:
                raise SemanticError("WHERE must be boolean")
            rel = RelationPlan(P.Filter(rel.root, pred), rel.scope)
        return rel

    def _plan_semijoin(
        self, rel: RelationPlan, value: ast.Node, query: ast.Query, negate: bool
    ) -> RelationPlan:
        ea = ExprAnalyzer(self, rel)
        v = ea.analyze(value)
        rel = ea.relation
        if not isinstance(v, ir.ColumnRef):
            # compute the key in a projection first
            sym = self.symbols.new("semikey")
            assigns = [
                (f.symbol, ir.ColumnRef(f.type, f.symbol))
                for f in rel.scope.fields
            ] + [(sym, v)]
            rel = RelationPlan(
                P.Project(rel.root, tuple(assigns)), rel.scope
            )
            v = ir.ColumnRef(v.type, sym)
        sub, sub_names = self.plan_query(query)
        if len(sub.scope.fields) != 1:
            raise SemanticError("IN subquery must return one column")
        out = self.symbols.new("semi")
        node = P.SemiJoin(
            rel.root, sub.root, (v.name,), (sub.scope.fields[0].symbol,), out
        )
        # filter on the mark (negated for NOT IN; NULL semantics simplified
        # to not-matched, exact NOT IN null semantics handled at kernel)
        mark = ir.ColumnRef(T.BOOLEAN, out)
        pred: ir.Expr = ir.Not(mark) if negate else mark
        return RelationPlan(P.Filter(node, pred), rel.scope)

    # -- decorrelation (TransformCorrelated* rules analog) --------------
    def _decorrelate(self, root: P.PlanNode, outer_syms: Dict[str, T.Type]):
        """Extract correlated equality conjuncts from the subplan.

        Returns (new_root, pairs, residuals) where pairs =
        [(outer_symbol, inner_symbol)], residuals are correlated
        non-equality conjuncts (kept verbatim, referencing outer + inner
        symbols — the mark-join filter), and new_root exposes every inner
        symbol at its top (pass-through projections added; Aggregates gain
        the inner symbols as group keys, turning a correlated scalar
        aggregate into a grouped one).
        """
        outer = set(outer_syms)

        def rec(node: P.PlanNode):
            if isinstance(node, P.Filter):
                src2, pairs, residuals = rec(node.source)
                rest: List[ir.Expr] = []
                my_pairs: List[Tuple[str, str]] = []
                my_res: List[ir.Expr] = []
                extra_proj: List[Tuple[str, ir.Expr]] = []
                for c in _flatten_ir_and(node.predicate):
                    refs = set(ir.referenced_columns(c)) & outer
                    if not refs:
                        rest.append(c)
                        continue
                    pair = _as_correlated_equality(c, outer)
                    if pair is None:
                        my_res.append(c)
                        continue
                    osym, inner = pair
                    if isinstance(inner, ir.ColumnRef):
                        my_pairs.append((osym, inner.name))
                    else:
                        isym = self.symbols.new("corrkey")
                        extra_proj.append((isym, inner))
                        my_pairs.append((osym, isym))
                src3 = src2
                if extra_proj:
                    passthrough = [
                        (s, ir.ColumnRef(t, s))
                        for s, t in src2.output_types().items()
                    ]
                    src3 = P.Project(src2, tuple(passthrough + extra_proj))
                out = P.Filter(src3, _combine_ir(rest)) if rest else src3
                return out, pairs + my_pairs, residuals + my_res
            if isinstance(node, P.Project):
                src2, pairs, residuals = rec(node.source)
                if not pairs and not residuals:
                    return dataclasses.replace(node, source=src2), pairs, residuals
                types = src2.output_types()
                have = {s for s, _ in node.assignments}
                need = [isym for _, isym in pairs]
                for r in residuals:
                    need.extend(
                        c for c in ir.referenced_columns(r)
                        if c not in outer and c in types
                    )
                extra = tuple(
                    (isym, ir.ColumnRef(types[isym], isym))
                    for isym in dict.fromkeys(need)
                    if isym not in have
                )
                return (
                    P.Project(src2, tuple(node.assignments) + extra),
                    pairs,
                    residuals,
                )
            if isinstance(node, P.Aggregate):
                src2, pairs, residuals = rec(node.source)
                if residuals:
                    raise SemanticError(
                        "non-equality correlation below an aggregate is not "
                        "decorrelatable"
                    )
                if not pairs:
                    return dataclasses.replace(node, source=src2), pairs, residuals
                new_keys = tuple(
                    dict.fromkeys(
                        list(node.keys) + [isym for _, isym in pairs]
                    )
                )
                return (
                    P.Aggregate(src2, new_keys, node.aggs, node.step),
                    pairs,
                    residuals,
                )
            if isinstance(node, (P.Limit, P.TopN, P.Sort, P.Distinct)):
                src2, pairs, residuals = rec(node.sources[0])
                if pairs or residuals:
                    raise SemanticError(
                        "correlation below ORDER BY/LIMIT/DISTINCT is not "
                        "decorrelatable"
                    )
                return node, pairs, residuals
            # joins/scans/semijoins: correlation must not appear below
            for s in node.sources:
                for t in _walk_plan_exprs(s):
                    if set(ir.referenced_columns(t)) & outer:
                        raise SemanticError(
                            "correlated reference in unsupported position"
                        )
            return node, [], []

        return rec(root)

    def _plan_exists(
        self, rel: RelationPlan, query: ast.Query, negate: bool
    ) -> RelationPlan:
        sub, _, corr = self._plan_subquery_correlated(query, rel.scope)
        if corr:
            new_root, pairs, residuals = self._decorrelate(sub.root, corr)
            if not pairs:
                raise SemanticError("correlated EXISTS without usable equality")
            out = self.symbols.new("semi")
            node = P.SemiJoin(
                rel.root,
                new_root,
                tuple(o for o, _ in pairs),
                tuple(i for _, i in pairs),
                out,
                filter=_combine_ir(residuals) if residuals else None,
            )
            mark = ir.ColumnRef(T.BOOLEAN, out)
            pred: ir.Expr = ir.Not(mark) if negate else mark
            return RelationPlan(P.Filter(node, pred), rel.scope)
        cnt = self.symbols.new("exists_count")
        agg = P.Aggregate(
            sub.root,
            (),
            (P.AggInfo(cnt, "count_star", None, False, None, T.BIGINT),),
        )
        flag_sym = self.symbols.new("exists")
        flag = P.Project(
            agg,
            (
                (
                    flag_sym,
                    ir.Comparison(
                        ">", ir.ColumnRef(T.BIGINT, cnt), ir.Constant(T.BIGINT, 0)
                    ),
                ),
            ),
        )
        node = P.ScalarJoin(rel.root, flag)
        mark = ir.ColumnRef(T.BOOLEAN, flag_sym)
        pred: ir.Expr = ir.Not(mark) if negate else mark
        return RelationPlan(P.Filter(node, pred), rel.scope)

    # ------------------------------------------------------------------
    def _plan_aggregation(self, rel, spec, items, ea: "ExprAnalyzer",
                          win_calls=()):
        # group keys: ordinals or expressions, possibly inside grouping
        # elements (ROLLUP/CUBE/GROUPING SETS -> cross-product of per-item
        # sets, StatementAnalyzer.analyzeGroupBy semantics)
        import itertools

        key_exprs: List[ir.Expr] = []

        def key_index(g: ast.Node) -> int:
            if isinstance(g, ast.Literal) and g.kind == "integer":
                idx = int(g.value) - 1
                if not (0 <= idx < len(items)):
                    raise SemanticError(
                        f"GROUP BY ordinal {g.value} out of range"
                    )
                e = ea.analyze(items[idx].expr)
            else:
                e = ea.analyze(g)
            for i, k in enumerate(key_exprs):
                if k == e:
                    return i
            key_exprs.append(e)
            return len(key_exprs) - 1

        set_lists: List[List[Tuple[int, ...]]] = []
        for g in spec.group_by:
            if isinstance(g, ast.Rollup):
                idxs = [key_index(x) for x in g.items]
                set_lists.append(
                    [tuple(idxs[:k]) for k in range(len(idxs), -1, -1)]
                )
            elif isinstance(g, ast.Cube):
                idxs = [key_index(x) for x in g.items]
                subs: List[Tuple[int, ...]] = []
                for r in range(len(idxs), -1, -1):
                    subs.extend(itertools.combinations(idxs, r))
                set_lists.append(subs)
            elif isinstance(g, ast.GroupingSets):
                set_lists.append(
                    [tuple(key_index(x) for x in s) for s in g.sets]
                )
            else:
                set_lists.append([(key_index(g),)])
        sets_idx: List[Tuple[int, ...]] = []
        for combo in itertools.product(*set_lists):
            merged: List[int] = []
            for part in combo:
                for i in part:
                    if i not in merged:
                        merged.append(i)
            sets_idx.append(tuple(merged))
        rel = ea.relation

        # pre-projection: pass-through + key symbols
        pre_assigns: List[Tuple[str, ir.Expr]] = [
            (f.symbol, ir.ColumnRef(f.type, f.symbol)) for f in rel.scope.fields
        ]
        key_syms: List[str] = []
        key_map: List[Tuple[ir.Expr, ir.ColumnRef]] = []
        for ke in key_exprs:
            if isinstance(ke, ir.ColumnRef):
                key_syms.append(ke.name)
                key_map.append((ke, ke))
            else:
                sym = self.symbols.new("groupkey")
                pre_assigns.append((sym, ke))
                ref = ir.ColumnRef(ke.type, sym)
                key_syms.append(sym)
                key_map.append((ke, ref))

        multi_sets = len(sets_idx) > 1
        gid_sym = gid_ref = sets_syms = None
        if multi_sets:
            sets_syms = tuple(
                tuple(key_syms[i] for i in st) for st in sets_idx
            )
            gid_sym = self.symbols.new("groupid")
            gid_ref = ir.ColumnRef(T.BIGINT, gid_sym)
        agg_collector = AggCollector(
            self, rel, key_map, pre_assigns,
            grouping_sets=sets_syms, gid_ref=gid_ref,
        )
        # window args/partition/order are evaluated over the aggregation
        # output: extract their aggregates first (before the Aggregate node
        # is frozen) and register placeholder types for the item analysis
        if win_calls:
            for _, call in win_calls:
                for x in _window_subexprs(call):
                    self.win_ir_cache[id(x)] = agg_collector.analyze_post(x)
            self._analyze_windows(win_calls, agg_collector.analyze_post)
        # analyze select + having with aggregate extraction
        post_exprs = {}
        for it in items:
            post_exprs[id(it)] = agg_collector.analyze_post(it.expr)
        having_pred = (
            agg_collector.analyze_post(spec.having)
            if spec.having is not None
            else None
        )
        rel = agg_collector.relation

        pre = P.Project(rel.root, tuple(agg_collector.pre_assigns))
        agg_src: P.PlanNode = pre
        agg_keys = tuple(key_syms)
        if multi_sets:
            agg_src = P.GroupId(pre, sets_syms, gid_sym)
            agg_keys = agg_keys + (gid_sym,)
        agg_node = P.Aggregate(agg_src, agg_keys, tuple(agg_collector.aggs))
        new_fields = [
            Field(None, s, s, t)
            for s, t in agg_node.output_types().items()
        ]
        root: P.PlanNode = agg_node
        for subplan in agg_collector.pending_scalar:
            root = P.ScalarJoin(root, subplan)
        rel2 = RelationPlan(root, Scope(new_fields))
        if having_pred is not None:
            rel2 = RelationPlan(P.Filter(rel2.root, having_pred), rel2.scope)
        post_analyzer = PostAggAnalyzer(
            self, rel2, agg_collector, post_exprs, dict((id(it), it) for it in items)
        )
        return rel2, post_analyzer

    # -- window planning (QueryPlanner.planWindowFunctions analog) -------
    def _rewrite_windows(self, e: ast.Node, out: List) -> ast.Node:
        """Replace windowed FunctionCalls with placeholder identifiers
        ($w symbols, unreachable from SQL text); collects (placeholder,
        call) pairs.  Does not descend into subqueries — their windows are
        planned when the subquery is planned."""
        if isinstance(e, ast.FunctionCall) and e.window is not None:
            ph = self.symbols.new("$w")
            out.append((ph, e))
            return ast.Identifier((ph,))
        if isinstance(e, ast.Query) or not isinstance(e, ast.Node):
            return e
        kwargs = {}
        changed = False
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, ast.Node):
                nv = self._rewrite_windows(v, out)
            elif isinstance(v, tuple):
                nv = tuple(self._rewrite_windows(x, out) for x in v)
                if all(a is b for a, b in zip(nv, v)):
                    nv = v
            else:
                nv = v
            if nv is not v:
                changed = True
            kwargs[f.name] = nv
        return dataclasses.replace(e, **kwargs) if changed else e

    def _analyze_windows(self, win_calls, analyze) -> None:
        """Phase 1 of window planning: analyze partition/order/arg
        expressions (via `analyze`, the agg-aware analyzer when grouping),
        build WindowFunc specs, and register placeholder output types so
        the select projection can reference them.  The built state is
        pushed for _attach_windows (a stack: subquery planning nests)."""

        def an(x: ast.Node) -> ir.Expr:
            cached = self.win_ir_cache.get(id(x))
            return cached if cached is not None else analyze(x)

        computed: List[Tuple[str, ir.Expr]] = []
        seen: Dict[ir.Expr, str] = {}

        def as_symbol(e: ir.Expr) -> str:
            if isinstance(e, ir.ColumnRef):
                return e.name
            if e in seen:
                return seen[e]
            sym = self.symbols.new("winarg")
            computed.append((sym, e))
            seen[e] = sym
            return sym

        groups: Dict[tuple, List[P.WindowFunc]] = {}
        for ph, call in win_calls:
            spec = call.window
            psyms = tuple(as_symbol(an(p)) for p in spec.partition_by)
            okeys = []
            for si in spec.order_by:
                sym = as_symbol(an(si.expr))
                asc = si.ascending
                nf = si.nulls_first if si.nulls_first is not None else (not asc)
                okeys.append(SortKey(sym, asc, nf))
            func = self._window_func(ph, call, an, as_symbol)
            groups.setdefault((psyms, tuple(okeys)), []).append(func)
            self.window_fields[ph] = func.output_type
        self._pending_windows.append((computed, groups))

    def _attach_windows(self, pa) -> None:
        """Phase 2: place the pre-projection + Window nodes on top of the
        (possibly aggregated) relation the projection analyzer sees."""
        computed, groups = self._pending_windows.pop()
        rel = pa.relation
        root = rel.root
        if computed:
            passthrough = [
                (s, ir.ColumnRef(t, s))
                for s, t in root.output_types().items()
            ]
            root = P.Project(root, tuple(passthrough + computed))
        for (psyms, okeys), funcs in groups.items():
            root = P.Window(root, psyms, okeys, tuple(funcs))
        pa.relation = RelationPlan(root, rel.scope)

    def _window_func(self, ph, call: ast.FunctionCall, an, as_symbol):
        kind = call.name
        if call.distinct:
            raise SemanticError("DISTINCT in window functions is not supported")
        frame = self._window_frame(call.window.frame)
        args: Tuple[str, ...] = ()
        constants: Tuple[object, ...] = ()
        in_t: Optional[T.Type] = None
        if kind in ("row_number", "rank", "dense_rank", "percent_rank",
                    "cume_dist"):
            if call.args:
                raise SemanticError(f"{kind}() takes no arguments")
            out_t = T.DOUBLE if kind in ("percent_rank", "cume_dist") else T.BIGINT
        elif kind == "ntile":
            if len(call.args) != 1:
                raise SemanticError("ntile(n) takes one argument")
            n = self._const_int(call.args[0], "ntile")
            if n < 1:
                raise SemanticError("ntile buckets must be positive")
            constants = (n,)
            out_t = T.BIGINT
        elif kind in ("lag", "lead"):
            if not call.args:
                raise SemanticError(f"{kind}() requires a value argument")
            v = an(call.args[0])
            args = (as_symbol(v),)
            in_t = out_t = v.type
            off = 1
            if len(call.args) > 1:
                off = self._const_int(call.args[1], kind)
            default = None
            if len(call.args) > 2:
                d = an(call.args[2])
                if not isinstance(d, ir.Constant):
                    raise SemanticError(f"{kind} default must be a constant")
                default = d.value
                if default is not None and in_t.is_dictionary:
                    raise SemanticError(
                        f"{kind} with a non-null varchar default is not "
                        "supported"
                    )
                if default is not None and in_t.is_decimal:
                    src_scale = d.type.scale if d.type.is_decimal else 0
                    default = default * 10 ** (in_t.scale - src_scale)
            constants = (off, default)
        elif kind in ("first_value", "last_value"):
            if len(call.args) != 1:
                raise SemanticError(f"{kind}(x) takes one argument")
            v = an(call.args[0])
            args = (as_symbol(v),)
            in_t = out_t = v.type
        elif kind == "nth_value":
            if len(call.args) != 2:
                raise SemanticError("nth_value(x, n) takes two arguments")
            v = an(call.args[0])
            args = (as_symbol(v),)
            n = self._const_int(call.args[1], "nth_value")
            if n < 1:
                raise SemanticError("nth_value offset must be positive")
            constants = (n,)
            in_t = out_t = v.type
        elif kind in AGGREGATES:
            if call.is_star:
                kind = "count_star"
                out_t = T.BIGINT
            else:
                v = an(call.args[0])
                args = (as_symbol(v),)
                in_t = v.type
                out_t = _agg_output_type(kind, in_t)
                if kind in ("min", "max") and in_t.is_dictionary:
                    raise SemanticError(
                        f"window {kind}(varchar) is not supported"
                    )
        else:
            raise SemanticError(f"unknown window function: {kind}")
        return P.WindowFunc(ph, kind, args, constants, frame, in_t, out_t)

    def _window_frame(self, f: Optional[ast.WindowFrame]) -> P.WindowFrame:
        if f is None:
            # SQL default: RANGE UNBOUNDED PRECEDING .. CURRENT ROW
            # (without ORDER BY all rows are peers, so this spans the
            # whole partition — compute_bounds' peer geometry covers both)
            return P.WindowFrame()
        if f.unit == "groups":
            raise SemanticError("GROUPS frames are not supported")

        def bound(b: ast.FrameBound, which: str) -> Tuple[str, int]:
            if b.kind in ("preceding", "following"):
                if f.unit == "range":
                    raise SemanticError(
                        "RANGE frames support only UNBOUNDED/CURRENT ROW "
                        "bounds"
                    )
                return b.kind, self._const_int(b.value, f"frame {which}")
            return b.kind, 0

        sk, so = bound(f.start, "start")
        ek, eo = bound(f.end, "end")
        if sk == "unbounded_following" or ek == "unbounded_preceding":
            raise SemanticError("invalid window frame bounds")
        return P.WindowFrame(f.unit, sk, so, ek, eo)

    @staticmethod
    def _const_int(e: ast.Node, what: str) -> int:
        if isinstance(e, ast.Literal) and e.kind == "integer":
            return int(e.value)
        raise SemanticError(f"{what} requires a constant integer")

    # ------------------------------------------------------------------
    def _apply_order_limit(
        self,
        out: RelationPlan,
        names: List[str],
        order_by,
        limit,
        post_agg=None,
        pre_projection: Optional[RelationPlan] = None,
        select_assigns=None,
        offset: int = 0,
    ) -> RelationPlan:
        if order_by:
            keys: List[SortKey] = []
            extra_assigns: List[Tuple[str, ir.Expr]] = []
            for si in order_by:
                sym = self._resolve_sort_expr(
                    si.expr, out, names, post_agg, pre_projection, extra_assigns
                )
                asc = si.ascending
                nf = si.nulls_first if si.nulls_first is not None else (not asc)
                keys.append(SortKey(sym, asc, nf))
            root = out.root
            if extra_assigns:
                # hidden sort columns: extend the projection feeding the sort
                assert isinstance(root, P.Project)
                root = P.Project(
                    root.source, tuple(list(root.assignments) + extra_assigns)
                )
            if limit is not None:
                # TopN keeps offset+limit, then Limit skips the offset
                node: P.PlanNode = P.TopN(
                    root, tuple(keys), limit + offset
                )
                if offset:
                    node = P.Limit(node, limit, offset)
            else:
                node = P.Sort(root, tuple(keys))
                if offset:
                    node = P.Limit(node, (1 << 62), offset)
            if extra_assigns:
                # project hidden columns away
                node = P.Project(
                    node,
                    tuple(
                        (f.symbol, ir.ColumnRef(f.type, f.symbol))
                        for f in out.scope.fields
                    ),
                )
            return RelationPlan(node, out.scope)
        if limit is not None:
            return RelationPlan(
                P.Limit(out.root, limit, offset), out.scope
            )
        if offset:
            return RelationPlan(
                P.Limit(out.root, (1 << 62), offset), out.scope
            )
        return out

    def _resolve_sort_expr(
        self, e, out: RelationPlan, names, post_agg, pre_projection, extra_assigns
    ) -> str:
        # ordinal
        if isinstance(e, ast.Literal) and e.kind == "integer":
            idx = int(e.value) - 1
            if not (0 <= idx < len(out.scope.fields)):
                raise SemanticError(f"ORDER BY ordinal {e.value} out of range")
            return out.scope.fields[idx].symbol
        # output alias / name
        if isinstance(e, ast.Identifier) and len(e.parts) == 1:
            matches = [
                f for f in out.scope.fields if f.name == e.parts[0].lower()
            ]
            if len(matches) == 1:
                return matches[0].symbol
        # expression over the underlying relation (hidden column)
        if post_agg is not None:
            expr = post_agg.analyze(e)
        elif pre_projection is not None:
            expr = ExprAnalyzer(self, pre_projection).analyze(e)
        else:
            raise SemanticError("cannot resolve ORDER BY expression")
        sym = self.symbols.new("sortkey")
        extra_assigns.append((sym, expr))
        return sym

    # ------------------------------------------------------------------
    def plan_relation(self, rel: ast.Node) -> RelationPlan:
        if isinstance(rel, ast.Table):
            return self._plan_table(rel)
        if isinstance(rel, ast.SubqueryRelation):
            rp, names = self.plan_query(rel.query)
            cols = rel.columns or names
            if len(cols) != len(rp.scope.fields):
                raise SemanticError("derived table column count mismatch")
            fields = [
                Field(rel.alias, c.lower(), f.symbol, f.type)
                for c, f in zip(cols, rp.scope.fields)
            ]
            return RelationPlan(rp.root, Scope(fields))
        if isinstance(rel, ast.Join):
            return self._plan_join(rel)
        if isinstance(rel, ast.MatchRecognize):
            return self._plan_match_recognize(rel)
        if isinstance(rel, ast.UnnestRelation):
            # standalone FROM UNNEST(constant-array): expand against dual
            sym = self.symbols.new("dual")
            dual = RelationPlan(
                P.Values((sym,), ((sym, T.BIGINT),), ((0,),)), Scope([])
            )
            return self._plan_unnest(dual, rel)
        if isinstance(rel, ast.TableFunctionRelation):
            return self._plan_table_function(rel)
        raise SemanticError(f"unsupported relation: {type(rel).__name__}")

    # -- table functions (spi/function/table + operator/table) ----------
    def _plan_table_function(
        self, rel: "ast.TableFunctionRelation"
    ) -> RelationPlan:
        """Built-in polymorphic table functions (sequence,
        exclude_columns) + the connector SPI seam
        (Connector.table_functions() — ConnectorTableFunction analog)."""
        name = rel.name
        if name == "sequence":
            return self._tf_sequence(rel)
        if name == "exclude_columns":
            return self._tf_exclude_columns(rel)
        # connector-provided table functions (searched over catalogs)
        for cat in self.metadata.catalogs.names():
            conn = self.metadata.catalogs.get(cat)
            tf = (conn.table_functions() or {}).get(name)
            if tf is None:
                continue
            scalars = [
                self._const_scalar(a, name)
                for kind, a in rel.args if kind == "scalar"
            ]
            schema, rows = tf(*scalars)
            syms, fields, types = [], [], []
            for col, t in schema:
                sym = self.symbols.new(col)
                syms.append(sym)
                types.append((sym, t))
                fields.append(Field(rel.alias, col, sym, t))
            return RelationPlan(
                P.Values(tuple(syms), tuple(types),
                         tuple(tuple(r) for r in rows)),
                Scope(fields),
            )
        raise SemanticError(f"unknown table function: {name}")

    def _const_scalar(self, e: ast.Node, what: str) -> object:
        v = self._analyze_standalone(e)
        if not isinstance(v, ir.Constant):
            raise SemanticError(
                f"table function {what} requires constant arguments"
            )
        return v.value

    def _analyze_standalone(self, e: ast.Node):
        dummy = RelationPlan(P.Values((), (), ()), Scope([]))
        return ExprAnalyzer(self, dummy).analyze(e)

    def _tf_sequence(self, rel) -> RelationPlan:
        """TABLE(sequence(start, stop [, step])) -> one bigint column
        `sequential_number` (io.trino.operator.table.Sequence)."""
        scalars = [a for kind, a in rel.args if kind == "scalar"]
        if len(scalars) not in (2, 3):
            raise SemanticError("sequence(start, stop [, step])")
        vals = [self._const_scalar(a, "sequence") for a in scalars]
        start, stop = int(vals[0]), int(vals[1])
        step = int(vals[2]) if len(vals) == 3 else 1
        if step == 0:
            raise SemanticError("sequence step cannot be zero")
        n = max(0, (stop - start) // step + 1)
        if n > 1_000_000:
            raise SemanticError("sequence result exceeds 1,000,000 rows")
        sym = self.symbols.new("sequential_number")
        col = rel.columns[0] if rel.columns else "sequential_number"
        return RelationPlan(
            P.Values(
                (sym,), ((sym, T.BIGINT),),
                tuple((start + i * step,) for i in range(n)),
            ),
            Scope([Field(rel.alias, col.lower(), sym, T.BIGINT)]),
        )

    def _tf_exclude_columns(self, rel) -> RelationPlan:
        """TABLE(exclude_columns(TABLE(t), DESCRIPTOR(a, b))) — passes the
        input through minus the descriptor columns
        (io.trino.operator.table.ExcludeColumns)."""
        tables = [a for kind, a in rel.args if kind == "table"]
        descs = [a for kind, a in rel.args if kind == "descriptor"]
        if len(tables) != 1 or len(descs) != 1:
            raise SemanticError(
                "exclude_columns(TABLE(t), DESCRIPTOR(col, ...))"
            )
        inp = self.plan_relation(tables[0])
        drop = {c.lower() for c in descs[0]}
        fields = [f for f in inp.scope.fields if f.name not in drop]
        if len(fields) == len(inp.scope.fields):
            missing = drop - {f.name for f in inp.scope.fields}
            if missing:
                raise SemanticError(
                    f"exclude_columns: unknown columns {sorted(missing)}"
                )
        if not fields:
            raise SemanticError("exclude_columns would drop every column")
        if rel.alias:
            fields = [
                Field(rel.alias, f.name, f.symbol, f.type) for f in fields
            ]
        return RelationPlan(inp.root, Scope(fields))

    def _plan_match_recognize(self, mr: ast.MatchRecognize) -> RelationPlan:
        """MATCH_RECOGNIZE -> P.MatchRecognize (PatternRecognitionNode):
        DEFINE/MEASURES analyzed with a navigation-aware resolver
        (PREV/NEXT/FIRST/LAST/CLASSIFIER/MATCH_NUMBER; A.col == LAST(A.col))."""
        inner = self.plan_relation(mr.relation)
        vars_: set = set()

        def collect(t):
            if t.kind == "var":
                vars_.add(t.var)
            for s in t.items:
                collect(s)

        collect(mr.pattern)
        mrea = MrExprAnalyzer(self, inner, vars_)
        part_syms = []
        for p in mr.partition_by:
            e = mrea.analyze(p)
            if not isinstance(e, ir.ColumnRef):
                raise SemanticError(
                    "MATCH_RECOGNIZE PARTITION BY must be input columns"
                )
            part_syms.append(e.name)
        order_keys = []
        for si in mr.order_by:
            e = mrea.analyze(si.expr)
            if not isinstance(e, ir.ColumnRef):
                raise SemanticError(
                    "MATCH_RECOGNIZE ORDER BY must be input columns"
                )
            nf = si.nulls_first
            order_keys.append(SortKey(
                e.name, si.ascending,
                (not si.ascending) if nf is None else nf,
            ))
        defines = []
        for var, cond in mr.defines:
            if var not in vars_:
                raise SemanticError(
                    f"DEFINE variable {var.upper()} not in PATTERN"
                )
            c = mrea.analyze(cond)
            defines.append((var, c))
        measures = []
        if mr.rows_per_match == "all":
            fields = list(inner.scope.fields)
        else:
            fields = [
                f for f in inner.scope.fields if f.symbol in part_syms
            ]
        for expr, name in mr.measures:
            e = mrea.analyze(expr)
            sym = self.symbols.new(name)
            measures.append((sym, e, e.type))
            fields.append(Field(mr.alias, name.lower(), sym, e.type))
        node = P.MatchRecognize(
            inner.root, tuple(part_syms), tuple(order_keys), mr.pattern,
            tuple(defines), tuple(measures), mr.after_match,
            mr.rows_per_match,
        )
        return RelationPlan(node, Scope(fields))

    def _plan_using_join(
        self, j: ast.Join, left: RelationPlan, right: RelationPlan, scope
    ) -> RelationPlan:
        """JOIN ... USING (cols): equi-join on same-named columns; each
        using column appears ONCE in the output, coalesced across sides
        (outer-join null-extension picks the present side), per the
        standard and StatementAnalyzer.analyzeJoinUsing."""
        pairs = []
        for c in j.using:
            lc = c.lower()
            lf = [f for f in left.scope.fields if f.name == lc]
            rf = [f for f in right.scope.fields if f.name == lc]
            if len(lf) != 1 or len(rf) != 1:
                raise SemanticError(
                    f"USING column {c} must appear exactly once on each side"
                )
            _check_comparable(lf[0].type, rf[0].type)
            pairs.append((lf[0], rf[0]))
        criteria = [(lf.symbol, rf.symbol) for lf, rf in pairs]
        planned = self._build_join(
            j.kind, left, right, criteria, None, scope
        )
        # coalesce each using pair into one output field, drop the pair
        used = {lf.symbol for lf, _ in pairs} | {rf.symbol for _, rf in pairs}
        assigns = []
        fields = []
        for lf, rf in pairs:
            # after RIGHT/FULL rewrites the scope may remap symbols; find
            # the current symbols by field identity
            cur_l = next(
                f for f in planned.scope.fields
                if f.name == lf.name and f.qualifier == lf.qualifier
            )
            cur_r = next(
                f for f in planned.scope.fields
                if f.name == rf.name and f.qualifier == rf.qualifier
                and f is not cur_l
            )
            t = T.common_super_type(cur_l.type, cur_r.type)
            lref = ir.ColumnRef(cur_l.type, cur_l.symbol)
            rref = ir.ColumnRef(cur_r.type, cur_r.symbol)
            e: ir.Expr = ir.Case(
                t,
                (ir.WhenClause(ir.IsNull(lref, negate=True), lref),),
                rref,
            )
            sym = self.symbols.new(lf.name)
            assigns.append((sym, e))
            fields.append(Field(None, lf.name, sym, t))
            used.add(cur_l.symbol)
            used.add(cur_r.symbol)
        for f in planned.scope.fields:
            if f.symbol in used:
                continue
            assigns.append((f.symbol, ir.ColumnRef(f.type, f.symbol)))
            fields.append(f)
        node = P.Project(planned.root, tuple(assigns))
        return RelationPlan(node, Scope(fields))

    def _plan_unnest(
        self, left: RelationPlan, u: ast.UnnestRelation, outer: bool = False
    ) -> RelationPlan:
        """CROSS JOIN UNNEST(arr): one output row per array element, left
        columns replicated (UnnestNode + UnnestOperator; the reference also
        zips multiple arrays/maps — single-array form here)."""
        if len(u.exprs) != 1:
            raise SemanticError("UNNEST supports a single array argument")
        ea = ExprAnalyzer(self, left)
        arr = ea.analyze(u.exprs[0])
        left = ea.relation
        if not getattr(arr.type, "is_array", False):
            raise SemanticError("UNNEST argument must be an array")
        if isinstance(arr, ir.ColumnRef):
            arr_sym = arr.name
            root = left.root
        else:
            arr_sym = self.symbols.new("unnestarr")
            passthrough = [
                (f.symbol, ir.ColumnRef(f.type, f.symbol))
                for f in left.scope.fields
            ]
            root = P.Project(left.root, tuple(passthrough + [(arr_sym, arr)]))
        elem_t = arr.type.element
        elem_sym = self.symbols.new("unnest")
        ord_sym = self.symbols.new("ordinality") if u.ordinality else None
        node = P.Unnest(root, arr_sym, elem_sym, elem_t, ord_sym, outer)
        cols = list(u.columns) if u.columns else []
        elem_name = (cols[0] if cols else (u.alias or "unnest")).lower()
        fields = list(left.scope.fields)
        fields.append(Field(u.alias, elem_name, elem_sym, elem_t))
        if ord_sym is not None:
            ord_name = (cols[1] if len(cols) > 1 else "ordinality").lower()
            fields.append(Field(u.alias, ord_name, ord_sym, T.BIGINT))
        return RelationPlan(node, Scope(fields))

    def _plan_table(self, t: ast.Table) -> RelationPlan:
        name = t.name[-1].lower()
        if name in self.ctes and len(t.name) == 1:
            w = self.ctes[name]
            # avoid infinite recursion for self-referencing names
            saved = dict(self.ctes)
            del self.ctes[name]
            try:
                rp, names = self.plan_query(w.query)
            finally:
                self.ctes = saved
            cols = w.columns or names
            fields = [
                Field(t.alias or name, c.lower(), f.symbol, f.type)
                for c, f in zip(cols, rp.scope.fields)
            ]
            return RelationPlan(rp.root, Scope(fields))
        view = self.metadata.lookup_view(t.name, self.default_catalog)
        if view is not None:
            # view expansion (StatementAnalyzer.java visitTable view
            # branch): plan the stored query in place, renaming output
            # fields to the view's declared columns
            vkey = (view.catalog, view.name.lower())
            expanding = getattr(self, "_expanding_views", None)
            if expanding is None:
                expanding = self._expanding_views = set()
            if vkey in expanding:
                raise SemanticError(
                    f"view is recursive: {view.catalog}.{view.name}"
                )
            expanding.add(vkey)
            saved_catalog = self.default_catalog
            if view.context_catalog is not None:
                self.default_catalog = view.context_catalog
            try:
                rp, _names = self.plan_query(view.query)
            finally:
                self.default_catalog = saved_catalog
                expanding.discard(vkey)
            if len(view.columns) != len(rp.scope.fields):
                raise SemanticError(
                    f"view {view.name} is stale: column count changed"
                )
            # the declared types are part of the view's contract too
            # (VIEW_IS_STALE covers type drift, not just arity): a base
            # table whose column changed type under the view must fail
            # expansion, not silently return the new type
            for (cname, ctype), fld in zip(view.columns, rp.scope.fields):
                if ctype and str(fld.type) != ctype:
                    raise SemanticError(
                        f"view {view.name} is stale: column '{cname}' "
                        f"type changed ({ctype} -> {fld.type})"
                    )
            qual = t.alias or view.name
            fields = [
                Field(qual, c.lower(), f.symbol, f.type)
                for (c, _t), f in zip(view.columns, rp.scope.fields)
            ]
            return RelationPlan(rp.root, Scope(fields))
        catalog, schema = self.metadata.resolve_table(
            t.name, self.default_catalog
        )
        handle = schema.name
        if t.version is not None:
            # time travel: resolve FOR VERSION|TIMESTAMP AS OF to a
            # snapshot id and pin the scan by suffixing the handle —
            # "orders@3" — so splits, stats, caches and data_version all
            # key on the pinned snapshot with no extra plumbing
            kind, expr = t.version
            if isinstance(expr, (ast.Literal, ast.TypedLiteral)):
                value = expr.value
            else:
                raise SemanticError(
                    "FOR VERSION/TIMESTAMP AS OF expects a literal"
                )
            conn = self.metadata.catalogs.get(catalog)
            resolve = getattr(
                conn.metadata(), "resolve_snapshot", None
            )
            if resolve is None:
                raise SemanticError(
                    f"catalog {catalog} does not support time travel"
                )
            try:
                snap = resolve(schema.name, kind, value)
            except (ValueError, KeyError) as exc:
                raise SemanticError(str(exc)) from None
            handle = f"{schema.name}@{snap}"
        assigns = []
        types_ = []
        fields = []
        qual = t.alias or schema.name
        for c in schema.columns:
            sym = self.symbols.new(c.name)
            assigns.append((sym, c.name))
            types_.append((sym, c.type))
            fields.append(Field(qual, c.name.lower(), sym, c.type))
        node: P.PlanNode = P.TableScan(
            catalog, handle, tuple(assigns), tuple(types_)
        )
        if t.sample is not None:
            _, pct = t.sample
            if not (0.0 <= pct <= 100.0):
                raise SemanticError("TABLESAMPLE percentage must be in [0, 100]")
            node = P.Sample(node, pct / 100.0)
        return RelationPlan(node, Scope(fields))

    def _plan_join(self, j: ast.Join) -> RelationPlan:
        if isinstance(j.right, ast.UnnestRelation):
            if j.kind not in ("cross", "inner", "left"):
                raise SemanticError(f"{j.kind} JOIN UNNEST is not supported")
            if j.kind == "left" and j.condition is not None:
                c = j.condition
                if not (isinstance(c, ast.Literal) and c.value is True):
                    raise SemanticError(
                        "LEFT JOIN UNNEST supports ON TRUE only"
                    )
            left = self.plan_relation(j.left)
            return self._plan_unnest(left, j.right, outer=(j.kind == "left"))
        left = self.plan_relation(j.left)
        right = self.plan_relation(j.right)
        scope = Scope(left.scope.fields + right.scope.fields)
        if j.kind == "cross":
            node = P.Join("cross", left.root, right.root, ())
            return RelationPlan(node, scope)
        if j.using:
            return self._plan_using_join(j, left, right, scope)
        ea = ExprAnalyzer(self, RelationPlan(left.root, scope))
        cond = ea.analyze(j.condition)
        lsyms = {f.symbol for f in left.scope.fields}
        rsyms = {f.symbol for f in right.scope.fields}
        criteria, residual = _extract_equi_criteria(cond, lsyms, rsyms)
        if not criteria:
            raise SemanticError("join requires at least one equi condition")
        return self._build_join(
            j.kind, left, right, criteria, residual, scope
        )

    def _build_join(self, kind, left, right, criteria, residual, scope):
        if kind == "right":
            # RIGHT = LEFT with sides swapped; the scope keeps the written
            # column order (plan side order is independent of it)
            node: P.PlanNode = P.Join(
                "left", right.root, left.root,
                tuple((r, l) for l, r in criteria), residual,
            )
            return RelationPlan(node, scope)
        if kind == "full":
            # FULL = LEFT(L, R) union-all right-only rows null-extended on
            # the left side (the LookupOuterOperator unmatched-build pass,
            # expressed as an anti join + projection)
            if residual is not None:
                raise SemanticError(
                    "FULL JOIN supports equi conditions only"
                )
            lj = P.Join(
                "left", left.root, right.root, tuple(criteria), None
            )
            mark = self.symbols.new("fullmark")
            anti = P.Filter(
                P.SemiJoin(
                    right.root, left.root,
                    tuple(r for _, r in criteria),
                    tuple(l for l, _ in criteria),
                    mark,
                ),
                ir.Not(ir.ColumnRef(T.BOOLEAN, mark)),
            )
            lj_syms = lj.output_symbols()
            lj_types = lj.output_types()
            in_right = set(right.root.output_symbols())
            # fresh output symbols: reusing the left-join branch's names
            # would collide in the executor's dictionary registry
            assigns = tuple(
                (
                    self.symbols.new("fn"),
                    ir.ColumnRef(lj_types[s], s) if s in in_right
                    else ir.Constant(lj_types[s], None),
                )
                for s in lj_syms
            )
            proj = P.Project(anti, assigns)
            usyms = tuple(self.symbols.new("fo") for _ in lj_syms)
            union = P.SetOperation(
                "union", True, (lj, proj), usyms,
                tuple((u, lj_types[s]) for u, s in zip(usyms, lj_syms)),
            )
            remap = dict(zip(lj_syms, usyms))
            new_fields = [
                Field(f.qualifier, f.name, remap[f.symbol], f.type)
                for f in scope.fields
            ]
            return RelationPlan(union, Scope(new_fields))
        node = P.Join(kind, left.root, right.root, tuple(criteria), residual)
        return RelationPlan(node, scope)


# ----------------------------------------------------------------------
# expression analysis


def _flatten_ir_and(e: ir.Expr) -> List[ir.Expr]:
    if isinstance(e, ir.Logical) and e.op == "and":
        out: List[ir.Expr] = []
        for t in e.terms:
            out.extend(_flatten_ir_and(t))
        return out
    return [e]


def _combine_ir(terms: List[ir.Expr]) -> ir.Expr:
    return terms[0] if len(terms) == 1 else ir.Logical("and", tuple(terms))


def _as_correlated_equality(c: ir.Expr, outer: set):
    """Match `outer_col = inner_expr` (either orientation); returns
    (outer_symbol, inner_expr) or None."""
    if not (isinstance(c, ir.Comparison) and c.op == "="):
        return None
    lrefs = set(ir.referenced_columns(c.left))
    rrefs = set(ir.referenced_columns(c.right))
    if (
        isinstance(c.left, ir.ColumnRef)
        and c.left.name in outer
        and not (rrefs & outer)
    ):
        return c.left.name, c.right
    if (
        isinstance(c.right, ir.ColumnRef)
        and c.right.name in outer
        and not (lrefs & outer)
    ):
        return c.right.name, c.left
    return None


def _walk_plan_exprs(node: P.PlanNode):
    """All expressions inside a plan subtree (for correlation checks)."""
    if isinstance(node, P.Filter):
        yield node.predicate
    elif isinstance(node, P.Project):
        for _, e in node.assignments:
            yield e
    elif isinstance(node, P.Join) and node.filter is not None:
        yield node.filter
    for s in node.sources:
        yield from _walk_plan_exprs(s)


def _flatten_and(e: ast.Node) -> List[ast.Node]:
    if isinstance(e, ast.LogicalOp) and e.op == "and":
        out = []
        for t in e.terms:
            out.extend(_flatten_and(t))
        return out
    return [e]


def _combine_and(terms: List[ast.Node]) -> ast.Node:
    if len(terms) == 1:
        return terms[0]
    return ast.LogicalOp("and", tuple(terms))


def _derive_name(e: ast.Node, i: int) -> str:
    if isinstance(e, ast.Identifier):
        return e.parts[-1]
    if isinstance(e, ast.FunctionCall):
        return e.name
    return f"_col{i}"


def _ast_children(e: ast.Node):
    """Direct AST children, not descending into subqueries (their
    aggregates/windows belong to the inner query)."""
    if not dataclasses.is_dataclass(e):
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ast.Node) and not isinstance(v, ast.Query):
            yield v
        elif isinstance(v, tuple):
            for x in v:
                if isinstance(x, ast.Node) and not isinstance(x, ast.Query):
                    yield x


def _contains_aggregate(e: ast.Node) -> bool:
    if (
        isinstance(e, ast.FunctionCall)
        and e.name in AGGREGATES
        and e.window is None
    ):
        return True
    return any(_contains_aggregate(c) for c in _ast_children(e))


def _contains_window(e: ast.Node) -> bool:
    if isinstance(e, ast.FunctionCall) and e.window is not None:
        return True
    return any(_contains_window(c) for c in _ast_children(e))


def _window_subexprs(call: ast.FunctionCall):
    """Value/partition/order expressions of a windowed call (the parts
    evaluated against the window's input relation)."""
    if not call.is_star:
        yield from call.args
    yield from call.window.partition_by
    for si in call.window.order_by:
        yield si.expr


def _extract_equi_criteria(cond: ir.Expr, lsyms, rsyms):
    conj: List[ir.Expr] = []

    def flat(e):
        if isinstance(e, ir.Logical) and e.op == "and":
            for t in e.terms:
                flat(t)
        else:
            conj.append(e)

    flat(cond)
    criteria = []
    residual = []
    for c in conj:
        if isinstance(c, ir.Comparison) and c.op == "=":
            ls = set(ir.referenced_columns(c.left))
            rs = set(ir.referenced_columns(c.right))
            if (
                isinstance(c.left, ir.ColumnRef)
                and isinstance(c.right, ir.ColumnRef)
            ):
                if c.left.name in lsyms and c.right.name in rsyms:
                    criteria.append((c.left.name, c.right.name))
                    continue
                if c.left.name in rsyms and c.right.name in lsyms:
                    criteria.append((c.right.name, c.left.name))
                    continue
        residual.append(c)
    res = None
    if residual:
        res = residual[0] if len(residual) == 1 else ir.Logical(
            "and", tuple(residual)
        )
    return criteria, res


class ExprAnalyzer:
    """AST expression -> typed ir over the relation's symbols.

    Scalar subqueries extend self.relation via ScalarJoin (SubqueryPlanner).
    """

    def __init__(self, analyzer: Analyzer, relation: RelationPlan):
        self.a = analyzer
        self.relation = relation
        # symbols produced by scalar subqueries (allowed post-aggregation)
        self.scalar_syms: set = set()
        # lambda parameter types, bound while analyzing a lambda body
        self.lambda_bindings: Dict[str, T.Type] = {}

    # -- entry ----------------------------------------------------------
    def analyze(self, e: ast.Node) -> ir.Expr:
        out = self._an(e)
        return out

    def _resolve_column(self, parts) -> ir.Expr:
        key = tuple(p.lower() for p in parts)
        if len(key) == 1 and key[0] in self.a.window_fields:
            # placeholder for an extracted window function output
            return ir.ColumnRef(self.a.window_fields[key[0]], key[0])
        try:
            f = self.relation.scope.resolve(key)
        except SemanticError:
            # correlated reference into an enclosing query's scope
            for i in range(len(self.a.outer_scopes) - 1, -1, -1):
                try:
                    f = self.a.outer_scopes[i].resolve(key)
                except SemanticError:
                    continue
                for lvl in range(i, len(self.a.correlation_used)):
                    self.a.correlation_used[lvl][f.symbol] = f.type
                return ir.ColumnRef(f.type, f.symbol)
            raise
        return ir.ColumnRef(f.type, f.symbol)

    def _an(self, e: ast.Node) -> ir.Expr:
        if isinstance(e, ast.Resolved):
            return e.expr
        if isinstance(e, ast.Identifier):
            if (len(e.parts) == 1
                    and e.parts[0].lower() in self.lambda_bindings):
                name = e.parts[0].lower()
                return ir.ColumnRef(self.lambda_bindings[name], name)
            return self._resolve_column(e.parts)
        if isinstance(e, ast.ArrayLiteral):
            return self._array_literal(e)
        if isinstance(e, ast.Lambda):
            raise SemanticError(
                "lambda expressions are only valid as arguments of "
                "higher-order functions (transform, filter, reduce, ...)"
            )
        if isinstance(e, ast.Literal):
            return _literal(e)
        if isinstance(e, ast.TypedLiteral):
            return _typed_literal(e)
        if isinstance(e, ast.UnaryOp):
            v = self._an(e.operand)
            return _fold(ir.Call(v.type, "negate", (v,)))
        if isinstance(e, ast.BinaryOp):
            l, r = self._an(e.left), self._an(e.right)
            return _fold(_binary(e.op, l, r))
        if isinstance(e, ast.ComparisonOp):
            l, r = self._an(e.left), self._an(e.right)
            _check_comparable(l.type, r.type)
            return ir.Comparison(e.op, l, r)
        if isinstance(e, ast.LogicalOp):
            return ir.Logical(e.op, tuple(self._an(t) for t in e.terms))
        if isinstance(e, ast.NotOp):
            return ir.Not(self._an(e.operand))
        if isinstance(e, ast.IsNullOp):
            return ir.IsNull(self._an(e.operand), e.negate)
        if isinstance(e, ast.BetweenOp):
            return ir.Between(
                self._an(e.value), self._an(e.low), self._an(e.high), e.negate
            )
        if isinstance(e, ast.InList):
            return ir.In(
                self._an(e.value),
                tuple(self._an(i) for i in e.items),
                e.negate,
            )
        if isinstance(e, ast.LikeOp):
            v = self._an(e.value)
            pat = self._an(e.pattern)
            args = [v, pat]
            if e.escape is not None:
                args.append(self._an(e.escape))
            call = ir.Call(T.BOOLEAN, "like", tuple(args))
            return ir.Not(call) if e.negate else call
        if isinstance(e, ast.FunctionCall):
            return self._function(e)
        if isinstance(e, ast.CastOp):
            to = T.parse_type(e.type_name)
            return _fold(ir.Cast(to, self._an(e.operand)))
        if isinstance(e, ast.ExtractOp):
            v = self._an(e.operand)
            field = {
                "dow": "day_of_week",
                "doy": "day_of_year",
                "yow": "year_of_week",
            }.get(e.field, e.field)
            if field not in (
                "year", "month", "day", "quarter", "week",
                "day_of_week", "day_of_year", "day_of_month", "year_of_week",
            ):
                raise SemanticError(f"extract({e.field}) unsupported")
            return ir.Call(T.BIGINT, field, (v,))
        if isinstance(e, ast.CaseExpr):
            return self._case(e)
        if isinstance(e, ast.ScalarSubquery):
            return self._scalar_subquery(e.query)
        if isinstance(e, (ast.InSubquery, ast.Exists)):
            raise SemanticError(
                "IN/EXISTS subqueries are only supported as top-level WHERE conjuncts"
            )
        raise SemanticError(f"unsupported expression: {type(e).__name__}")

    def _case(self, e: ast.CaseExpr) -> ir.Expr:
        whens = []
        if e.operand is not None:
            op = self._an(e.operand)
            for w in e.whens:
                cond = ir.Comparison("=", op, self._an(w.condition))
                whens.append(ir.WhenClause(cond, self._an(w.result)))
        else:
            for w in e.whens:
                c = self._an(w.condition)
                if c.type != T.BOOLEAN:
                    raise SemanticError("CASE WHEN must be boolean")
                whens.append(ir.WhenClause(c, self._an(w.result)))
        default = self._an(e.default) if e.default is not None else None
        rts = [w.result.type for w in whens] + (
            [default.type] if default is not None else []
        )
        rt = rts[0]
        for t in rts[1:]:
            rt = T.common_super_type(rt, t)
        return ir.Case(rt, tuple(whens), default)

    def _function(self, e: ast.FunctionCall) -> ir.Expr:
        if e.window is not None:
            raise SemanticError(
                "window functions are only allowed in the SELECT list"
            )
        if e.name in WINDOW_ONLY_FUNCTIONS:
            raise SemanticError(f"{e.name}() requires an OVER clause")
        if e.name in AGGREGATES:
            raise SemanticError(
                f"aggregate {e.name}() not allowed here"
            )
        if e.name in ("year", "month", "day", "quarter"):
            return ir.Call(T.BIGINT, e.name, (self._an(e.args[0]),))
        if e.name in ("abs",):
            v = self._an(e.args[0])
            return ir.Call(v.type, "abs", (v,))
        if e.name == "sqrt":
            return ir.Call(T.DOUBLE, "sqrt", (self._an(e.args[0]),))
        if e.name in ("round", "floor", "ceil", "ceiling"):
            v = self._an(e.args[0])
            args = [v]
            rt = v.type
            if e.name == "round" and len(e.args) > 1:
                args.append(self._an(e.args[1]))
            if e.name in ("floor", "ceil", "ceiling") and v.type.is_decimal:
                rt = T.decimal(v.type.precision, 0)
            return ir.Call(rt, e.name, tuple(args))
        if e.name == "length":
            return ir.Call(T.BIGINT, "length", (self._an(e.args[0]),))
        if e.name in ("substring", "substr"):
            args = tuple(self._an(a) for a in e.args)
            if not args[0].type.is_dictionary:
                raise SemanticError("substring() requires a varchar argument")
            return ir.Call(T.VARCHAR, "substring", args)
        if e.name == "coalesce":
            args = tuple(self._an(a) for a in e.args)
            rt = args[0].type
            for a in args[1:]:
                rt = T.common_super_type(rt, a.type)
            # lower as CASE WHEN a IS NOT NULL THEN a ...
            whens = tuple(
                ir.WhenClause(ir.IsNull(a, negate=True), a) for a in args[:-1]
            )
            return ir.Case(rt, whens, args[-1])
        if e.name == "nullif":
            a, b = self._an(e.args[0]), self._an(e.args[1])
            # CASE WHEN a = b THEN null ELSE a
            whens = (
                ir.WhenClause(
                    ir.Comparison("=", a, b), ir.Constant(a.type, None)
                ),
            )
            return ir.Case(a.type, whens, a)
        if e.name == "if":
            c = self._an(e.args[0])
            t = self._an(e.args[1])
            f = self._an(e.args[2]) if len(e.args) > 2 else None
            rt = t.type if f is None else T.common_super_type(t.type, f.type)
            return ir.Case(rt, (ir.WhenClause(c, t),), f)
        if e.name in ("try", "try_cast"):
            # our kernels already mask error rows to NULL (divide-by-zero,
            # bad casts), matching TRY semantics without a control transfer
            return self._an(e.args[0])
        fdef = self.a.sql_functions.get(e.name)
        if fdef is not None and not e.is_star and e.window is None:
            return self._expand_sql_function(fdef, e)
        if e.name in ("transform", "filter", "any_match", "all_match",
                      "none_match", "reduce"):
            return self._lambda_call(e)
        if e.name == "sequence":
            return self._sequence(e)
        if e.name == "map":
            return self._map_constructor(e)
        if e.name in ("current_date", "current_timestamp", "now",
                      "localtimestamp"):
            # evaluated once per query at analysis (reference: constant per
            # query via Session start time); nondeterministic_origin keeps
            # the FunctionMetadata.isDeterministic bit visible after
            # folding so plan/result caches never reuse the frozen instant
            now = datetime.datetime.now(datetime.timezone.utc)
            if e.name == "current_date":
                d = now.date()
                return ir.Constant(
                    T.DATE, days_from_civil(d.year, d.month, d.day),
                    nondeterministic_origin=True,
                )
            us = int(now.timestamp() * 1_000_000)
            return ir.Constant(
                T.TIMESTAMP, us, nondeterministic_origin=True
            )
        if e.name in ("rand", "random"):
            # per-row pseudorandom double in [0, 1): the kernel is a pure
            # function of (row index, seed) so the traced program stays
            # deterministic per execution while each QUERY draws a fresh
            # analysis-time seed (never folded, never cached)
            if e.args:
                raise SemanticError(f"{e.name}() takes no arguments")
            seed = _random.getrandbits(63)
            return ir.Call(
                T.DOUBLE, "rand", (ir.Constant(T.BIGINT, seed),)
            )
        from ..expr.functions import SIGNATURES

        if e.name in SIGNATURES:
            args = tuple(self._an(a) for a in e.args)
            try:
                rt = SIGNATURES[e.name](args)
            except (ValueError, TypeError) as err:
                raise SemanticError(str(err)) from err
            return _fold(ir.Call(rt, e.name, args))
        raise SemanticError(f"unknown function: {e.name}")

    def _expand_sql_function(self, fdef: "SqlFunction",
                             e: ast.FunctionCall) -> ir.Expr:
        """Inline a CREATE FUNCTION body with arguments substituted for
        parameters, then analyze it (the reference compiles routine IR to
        bytecode; this engine inlines the expression so it fuses into the
        surrounding kernel)."""
        if fdef.name in self.a._udf_stack:
            raise SemanticError(
                f"recursive SQL function {fdef.name} is not supported"
            )
        if len(e.args) != len(fdef.params):
            raise SemanticError(
                f"{fdef.name}() takes {len(fdef.params)} argument(s)"
            )
        # arguments are analyzed in the caller's scope FIRST (so a nested
        # call of the same function in an argument is not mistaken for
        # recursion), then adopt the declared parameter types
        mapping = {}
        for (p, ptype), arg in zip(fdef.params, e.args):
            a = self._an(arg)
            pt = T.parse_type(ptype)
            if a.type != pt:
                a = _fold(ir.Cast(pt, a))
            mapping[p.lower()] = ast.Resolved(a)

        def subst(n):
            if (isinstance(n, ast.Identifier) and len(n.parts) == 1
                    and n.parts[0].lower() in mapping):
                return mapping[n.parts[0].lower()]
            return n

        body = ast.transform(fdef.body, subst)
        self.a._udf_stack.add(fdef.name)
        try:
            expr = self._an(body)
        finally:
            self.a._udf_stack.discard(fdef.name)
        rt = T.parse_type(fdef.return_type)
        if expr.type != rt:
            expr = _fold(ir.Cast(rt, expr))
        return expr

    def _array_literal(self, e: ast.ArrayLiteral) -> ir.Expr:
        """ARRAY[...] of constants -> ir.Constant with a tuple value
        (ArrayConstructor; non-constant elements are out of scope — array
        columns are dictionary-encoded, see types.ArrayType)."""
        items = tuple(_fold(self._an(x)) for x in e.items)
        if not items:
            return ir.Constant(T.array_of(T.UNKNOWN), ())
        if not all(isinstance(x, ir.Constant) for x in items):
            raise SemanticError(
                "ARRAY[...] elements must be constants in this engine"
            )
        et = items[0].type
        for x in items[1:]:
            et = T.common_super_type(et, x.type)
        if et.name == "unknown":
            et = T.BIGINT
        vals = tuple(_coerce_const_value(x, et) for x in items)
        return ir.Constant(T.array_of(et), vals)

    def _sequence(self, e: ast.FunctionCall) -> ir.Expr:
        args = [_fold(self._an(a)) for a in e.args]
        if not (2 <= len(args) <= 3) or not all(
            isinstance(a, ir.Constant) and a.value is not None for a in args
        ):
            raise SemanticError("sequence() requires constant bounds")
        start, stop = int(args[0].value), int(args[1].value)
        step = int(args[2].value) if len(args) > 2 else (
            1 if stop >= start else -1
        )
        if step == 0:
            raise SemanticError("sequence() step must not be zero")
        if len(range(start, stop + (1 if step > 0 else -1), step)) > 10000:
            raise SemanticError("sequence is too large (max 10000)")
        vals = tuple(range(start, stop + (1 if step > 0 else -1), step))
        return ir.Constant(T.array_of(T.BIGINT), vals)

    def _map_constructor(self, e: ast.FunctionCall) -> ir.Expr:
        """map(ARRAY[k...], ARRAY[v...]) over constants -> map Constant
        (MapConstructor; duplicate keys rejected like the reference)."""
        if len(e.args) == 0:
            return ir.Constant(T.map_of(T.UNKNOWN, T.UNKNOWN), ())
        if len(e.args) != 2:
            raise SemanticError("map(keys_array, values_array)")
        ka = _fold(self._an(e.args[0]))
        va = _fold(self._an(e.args[1]))
        for a in (ka, va):
            if not (isinstance(a, ir.Constant)
                    and getattr(a.type, "is_array", False)):
                raise SemanticError(
                    "map() requires constant array arguments in this engine"
                )
        if len(ka.value) != len(va.value):
            raise SemanticError("map() key and value arrays differ in length")
        if any(k is None for k in ka.value):
            raise SemanticError("map keys cannot be NULL")
        if len(set(ka.value)) != len(ka.value):
            raise SemanticError("duplicate map keys")
        entries = tuple(zip(ka.value, va.value))
        return ir.Constant(
            T.map_of(ka.type.element, va.type.element), entries
        )

    def _lambda_call(self, e: ast.FunctionCall) -> ir.Expr:
        """Higher-order functions: type the lambda body with its parameter
        bound to the element type (FunctionResolver's function-type
        inference for ArrayTransformFunction etc.)."""

        def analyze_lambda(lam: ast.Node, bindings: Dict[str, T.Type]):
            if not isinstance(lam, ast.Lambda):
                raise SemanticError(f"{e.name}() expects a lambda argument")
            if len(lam.params) != len(bindings):
                raise SemanticError(
                    f"lambda must take {len(bindings)} parameter(s)"
                )
            names = [p.lower() for p in lam.params]
            saved = dict(self.lambda_bindings)
            self.lambda_bindings.update(zip(names, bindings.values()))
            try:
                body = self._an(lam.body)
            finally:
                self.lambda_bindings = saved
            return ir.Lambda(body.type, tuple(names), body)

        arr = self._an(e.args[0])
        if not getattr(arr.type, "is_array", False):
            raise SemanticError(f"{e.name}() requires an array argument")
        et = arr.type.element
        if e.name == "reduce":
            if len(e.args) != 4:
                raise SemanticError(
                    "reduce(array, initial, (s, x) -> ..., s -> ...)"
                )
            init = _fold(self._an(e.args[1]))
            if not isinstance(init, ir.Constant):
                raise SemanticError("reduce() initial state must be constant")
            st = init.type if init.type.name != "unknown" else T.BIGINT
            step = analyze_lambda(e.args[2], {"s": st, "x": et})
            try:
                st2 = T.common_super_type(st, step.type)
            except TypeError:
                st2 = step.type
            if st2 != st:
                step = analyze_lambda(e.args[2], {"s": st2, "x": et})
            out = analyze_lambda(e.args[3], {"s": st2})
            return ir.Call(out.type, "reduce", (arr, init, step, out))
        if len(e.args) != 2:
            raise SemanticError(f"{e.name}(array, lambda)")
        lam = analyze_lambda(e.args[1], {"x": et})
        if e.name == "transform":
            rt: T.Type = T.array_of(lam.type)
        elif e.name == "filter":
            rt = arr.type
        else:
            rt = T.BOOLEAN
        return ir.Call(rt, e.name, (arr, lam))

    def _scalar_subquery(self, q: ast.Query) -> ir.Expr:
        sub, _, corr = self.a._plan_subquery_correlated(q, self.relation.scope)
        if len(sub.scope.fields) != 1:
            raise SemanticError("scalar subquery must return one column")
        f = sub.scope.fields[0]
        if corr:
            # correlated scalar aggregate -> grouped aggregate + LEFT join
            # (TransformCorrelatedScalarAggregationToJoin)
            new_root, pairs, residuals = self.a._decorrelate(sub.root, corr)
            if not pairs:
                raise SemanticError("correlated scalar subquery without equality")
            if residuals:
                raise SemanticError(
                    "non-equality correlation in scalar subquery unsupported"
                )
            node = P.Join(
                "left",
                self.relation.root,
                new_root,
                tuple(pairs),
                expansion=False,  # grouped by the correlation keys -> unique
            )
            self.relation = RelationPlan(node, self.relation.scope)
            self.scalar_syms.add(f.symbol)
            return ir.ColumnRef(f.type, f.symbol)
        node = P.ScalarJoin(self.relation.root, sub.root)
        self.relation = RelationPlan(node, self.relation.scope)
        self.scalar_syms.add(f.symbol)
        return ir.ColumnRef(f.type, f.symbol)


class AggCollector(ExprAnalyzer):
    """Post-aggregation expression analyzer: extracts aggregate calls into
    AggInfo entries (pre-projected args) and rewrites group-key expressions
    to key symbols (AggregationAnalyzer + QueryPlanner combined)."""

    def __init__(self, analyzer, relation, key_map, pre_assigns,
                 grouping_sets=None, gid_ref=None):
        super().__init__(analyzer, relation)
        self.key_map = key_map  # [(key ir expr, key symbol ref)]
        self.pre_relation = relation  # pre-aggregation scope for resolution
        self.pre_assigns = pre_assigns
        self.aggs: List[P.AggInfo] = []
        self._agg_cache: Dict[tuple, ir.ColumnRef] = {}
        # scalar subqueries in HAVING/post-agg expressions join ABOVE the
        # aggregation (the reference plans Apply above AggregationNode)
        self.pending_scalar: List[P.PlanNode] = []
        # GROUPING SETS context: per-set key-symbol tuples + the group-id
        # column, for grouping() rewriting (GroupingOperationRewriter analog)
        self.grouping_sets = grouping_sets
        self.gid_ref = gid_ref
        if gid_ref is not None:
            self.scalar_syms.add(gid_ref.name)

    def _scalar_subquery(self, q: ast.Query) -> ir.Expr:
        sub, _, corr = self.a._plan_subquery_correlated(q, self.relation.scope)
        if corr:
            raise SemanticError(
                "correlated scalar subquery in post-aggregation position "
                "is not supported"
            )
        if len(sub.scope.fields) != 1:
            raise SemanticError("scalar subquery must return one column")
        f = sub.scope.fields[0]
        self.pending_scalar.append(sub.root)
        self.scalar_syms.add(f.symbol)
        return ir.ColumnRef(f.type, f.symbol)

    def analyze_post(self, e: ast.Node) -> ir.Expr:
        out = self._post(e)
        self._validate(out)
        return out

    def _post(self, e: ast.Node) -> ir.Expr:
        if (
            isinstance(e, ast.FunctionCall)
            and e.name in AGGREGATES
            and e.window is None
        ):
            return self._aggregate_call(e)
        if (
            isinstance(e, ast.FunctionCall)
            and e.name == "grouping"
            and e.window is None
        ):
            return self._grouping_call(e)
        # try: whole expression equals a group key
        try:
            full = self._an(e)
        except SemanticError:
            full = None
        if full is not None:
            for ke, ref in self.key_map:
                if full == ke:
                    return ref
        # recurse structurally
        if isinstance(e, ast.BinaryOp):
            return _fold(_binary(e.op, self._post(e.left), self._post(e.right)))
        if isinstance(e, ast.UnaryOp):
            v = self._post(e.operand)
            return ir.Call(v.type, "negate", (v,))
        if isinstance(e, ast.ComparisonOp):
            return ir.Comparison(e.op, self._post(e.left), self._post(e.right))
        if isinstance(e, ast.LogicalOp):
            return ir.Logical(e.op, tuple(self._post(t) for t in e.terms))
        if isinstance(e, ast.NotOp):
            return ir.Not(self._post(e.operand))
        if isinstance(e, ast.CaseExpr):
            whens = []
            if e.operand is not None:
                op = self._post(e.operand)
                for w in e.whens:
                    whens.append(
                        ir.WhenClause(
                            ir.Comparison("=", op, self._post(w.condition)),
                            self._post(w.result),
                        )
                    )
            else:
                whens = [
                    ir.WhenClause(self._post(w.condition), self._post(w.result))
                    for w in e.whens
                ]
            default = self._post(e.default) if e.default is not None else None
            rts = [w.result.type for w in whens] + (
                [default.type] if default else []
            )
            rt = rts[0]
            for t in rts[1:]:
                rt = T.common_super_type(rt, t)
            return ir.Case(rt, tuple(whens), default)
        if isinstance(e, ast.CastOp):
            return _fold(ir.Cast(T.parse_type(e.type_name), self._post(e.operand)))
        if full is not None:
            return full
        return self._an(e)  # will raise a descriptive error

    def _grouping_call(self, e: ast.FunctionCall) -> ir.Expr:
        """grouping(a, b, ...) -> bitmask, bit i (MSB-first) set when the
        i-th argument is absent from the row's grouping set.  Lowered to a
        CASE over the group-id column, whose value is known per set at plan
        time (sql/planner/GroupingOperationRewriter analog)."""
        if e.is_star or not e.args:
            raise SemanticError("grouping() requires arguments")
        refs: List[ir.ColumnRef] = []
        for a in e.args:
            ae = self._an(a)
            for ke, ref in self.key_map:
                if ae == ke:
                    refs.append(ref)
                    break
            else:
                raise SemanticError(
                    "grouping() arguments must appear in GROUP BY"
                )
        if self.gid_ref is None or self.grouping_sets is None:
            return ir.Constant(T.BIGINT, 0)  # plain GROUP BY: all bits 0
        nbits = len(refs)
        masks = []
        for st in self.grouping_sets:
            m = 0
            for j, ref in enumerate(refs):
                if ref.name not in st:
                    m |= 1 << (nbits - 1 - j)
            masks.append(m)
        whens = tuple(
            ir.WhenClause(
                ir.Comparison("=", self.gid_ref, ir.Constant(T.BIGINT, g)),
                ir.Constant(T.BIGINT, m),
            )
            for g, m in enumerate(masks[:-1])
        )
        return ir.Case(T.BIGINT, whens, ir.Constant(T.BIGINT, masks[-1]))

    def _aggregate_call(self, e: ast.FunctionCall) -> ir.ColumnRef:
        kind = AGG_ALIASES.get(e.name, e.name)
        arg_sym = arg2_sym = None
        in_t = in2_t = None
        param = None

        def to_symbol(arg: ir.Expr, label: str) -> str:
            if isinstance(arg, ir.ColumnRef):
                return arg.name
            sym = self.a.symbols.new(label)
            self.pre_assigns.append((sym, arg))
            return sym

        if e.is_star:
            kind = "count_star"
            out_t = T.BIGINT
        elif kind in TWO_ARG_AGGREGATES:
            if len(e.args) != 2:
                raise SemanticError(f"{e.name} takes two arguments")
            arg = self._an(e.args[0])
            in_t = arg.type
            arg_sym = to_symbol(arg, f"{kind}arg")
            if kind == "approx_percentile":
                # second argument is the constant percentile fraction
                p = self._an(e.args[1])
                if not isinstance(p, ir.Constant) or p.value is None:
                    raise SemanticError(
                        "approx_percentile requires a constant percentile"
                    )
                param = float(p.value) / (
                    10 ** p.type.scale if p.type.is_decimal else 1
                )
                if not (0.0 <= param <= 1.0):
                    raise SemanticError("percentile must be in [0, 1]")
            elif kind == "listagg":
                # second argument is the constant separator string
                p = self._an(e.args[1])
                if not isinstance(p, ir.Constant) or not isinstance(
                    p.value, str
                ):
                    raise SemanticError(
                        "listagg requires a constant varchar separator"
                    )
                param = p.value
            else:
                arg2 = self._an(e.args[1])
                in2_t = arg2.type
                arg2_sym = to_symbol(arg2, f"{kind}arg2")
            out_t = _agg_output_type(kind, in_t, in2_t)
        else:
            # approx_distinct accepts an optional max-standard-error second
            # argument (ignored: this engine's implementation is exact)
            nargs = len(e.args)
            if kind == "approx_distinct" and nargs == 2:
                nargs = 1  # drop the max-standard-error argument
            if nargs != 1:
                raise SemanticError(f"{e.name} takes one argument")
            arg = self._an(e.args[0])  # pre-agg scope
            in_t = arg.type
            out_t = _agg_output_type(kind, in_t)
            arg_sym = to_symbol(arg, f"{kind}arg")
        cache_key = (kind, arg_sym, arg2_sym, param, e.distinct)
        if cache_key in self._agg_cache:
            return self._agg_cache[cache_key]
        out_sym = self.a.symbols.new(kind)
        self.aggs.append(
            P.AggInfo(out_sym, kind, arg_sym, e.distinct, in_t, out_t,
                      arg2_sym, in2_t, param)
        )
        ref = ir.ColumnRef(out_t, out_sym)
        self._agg_cache[cache_key] = ref
        return ref

    def _validate(self, e: ir.Expr):
        allowed = (
            {r.name for _, r in self.key_map}
            | {a.output for a in self.aggs}
            | self.scalar_syms
            | set(self.a.window_fields)
        )
        for n in ir.walk(e):
            if isinstance(n, ir.ColumnRef) and n.name not in allowed:
                raise SemanticError(
                    f"'{n.name}' must appear in GROUP BY or inside an aggregate"
                )


class PostAggAnalyzer:
    """Re-analyzes select/order expressions after aggregation planning,
    reusing the AggCollector's extraction results."""

    def __init__(self, analyzer, relation, collector: AggCollector, cache, items):
        self.a = analyzer
        self.relation = relation
        self.collector = collector
        self._cache = cache  # id(ast item) -> analyzed expr
        self._items = items

    def analyze(self, e: ast.Node) -> ir.Expr:
        for iid, expr in self._cache.items():
            if self._items.get(iid) is not None and self._items[iid].expr is e:
                return expr
        # order-by style expression referencing keys/aggs: resolve against
        # the pre-aggregation scope so group-key expressions match
        self.collector.relation = self.collector.pre_relation
        return self.collector.analyze_post(e)


# ----------------------------------------------------------------------
# literals, folding, typing helpers


def _coerce_const_value(c: "ir.Constant", t: T.Type):
    """Constant value -> IR convention of type t (decimal rescale etc.)."""
    if c.value is None:
        return None
    if t.is_decimal:
        cs = c.type.scale if c.type.is_decimal else 0
        if t.scale >= cs:
            return int(c.value) * 10 ** (t.scale - cs)
        return int(c.value) // 10 ** (cs - t.scale)
    if t.name in ("double", "real"):
        if c.type.is_decimal:
            return float(c.value) / 10 ** c.type.scale
        return float(c.value)
    return c.value


def _literal(e: ast.Literal) -> ir.Constant:
    if e.kind == "integer":
        return ir.Constant(T.BIGINT, int(e.value))
    if e.kind == "double":
        return ir.Constant(T.DOUBLE, float(e.value))
    if e.kind == "decimal":
        txt = str(e.value)
        if "." in txt:
            whole, frac = txt.split(".")
        else:
            whole, frac = txt, ""
        scale = len(frac)
        unscaled = int((whole + frac) or "0")
        precision = max(len((whole + frac).lstrip("0")), scale + 1)
        return ir.Constant(T.decimal(min(38, precision), scale), unscaled)
    if e.kind == "string":
        return ir.Constant(T.VARCHAR, e.value)
    if e.kind == "boolean":
        return ir.Constant(T.BOOLEAN, bool(e.value))
    if e.kind == "null":
        return ir.Constant(T.UNKNOWN, None)
    raise SemanticError(f"literal kind {e.kind}")


def _typed_literal(e: ast.TypedLiteral) -> ir.Constant:
    if e.kind == "date":
        y, m, d = map(int, e.value.split("-"))
        return ir.Constant(T.DATE, days_from_civil(y, m, d))
    if e.kind == "timestamp":
        # 'YYYY-MM-DD[ HH:MM:SS]' -> microseconds
        parts = e.value.split(" ")
        y, m, d = map(int, parts[0].split("-"))
        us = days_from_civil(y, m, d) * 86_400_000_000
        if len(parts) > 1:
            hh, mm, ss = (parts[1].split(":") + ["0", "0"])[:3]
            us += (int(hh) * 3600 + int(mm) * 60 + int(float(ss))) * 1_000_000
        return ir.Constant(T.TIMESTAMP, us)
    if e.kind == "interval":
        n = int(e.value)
        unit = e.unit.rstrip("s")
        # represented as a bigint day count (day) or month count (month/year)
        if unit == "day":
            return ir.Constant(_INTERVAL_DAY, n)
        if unit == "week":
            return ir.Constant(_INTERVAL_DAY, 7 * n)
        if unit == "month":
            return ir.Constant(_INTERVAL_MONTH, n)
        if unit == "year":
            return ir.Constant(_INTERVAL_MONTH, 12 * n)
        raise SemanticError(f"interval unit {e.unit}")
    raise SemanticError(f"typed literal {e.kind}")


_INTERVAL_DAY = T.FixedWidthType("interval_day", "int64")
_INTERVAL_MONTH = T.FixedWidthType("interval_month", "int64")


def _binary(op: str, l: ir.Expr, r: ir.Expr) -> ir.Expr:
    name = {
        "+": "add",
        "-": "subtract",
        "*": "multiply",
        "/": "divide",
        "%": "modulus",
        "||": "concat",
    }[op]
    if name == "concat":
        raise SemanticError("|| not supported yet")
    # date/interval arithmetic
    if l.type.name == "date" and r.type is _INTERVAL_DAY:
        return ir.Call(T.DATE, name, (l, ir.Constant(T.BIGINT, r.value if isinstance(r, ir.Constant) else None)))
    if l.type is _INTERVAL_DAY and r.type.name == "date" and name == "add":
        return ir.Call(T.DATE, name, (r, ir.Constant(T.BIGINT, l.value)))
    if l.type.name == "date" and r.type is _INTERVAL_MONTH:
        if not isinstance(l, ir.Constant) or not isinstance(r, ir.Constant):
            raise SemanticError(
                "date +/- interval month/year requires constant date for now"
            )
        return ir.Constant(T.DATE, _add_months(l.value, r.value if name == "add" else -r.value))
    rt = arith_result_type(name, l.type, r.type)
    return ir.Call(rt, name, (l, r))


def _add_months(epoch_days: int, months: int) -> int:
    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=epoch_days)
    y = d.year + (d.month - 1 + months) // 12
    m = (d.month - 1 + months) % 12 + 1
    import calendar

    day = min(d.day, calendar.monthrange(y, m)[1])
    return (datetime.date(y, m, day) - datetime.date(1970, 1, 1)).days


def _check_comparable(a: T.Type, b: T.Type):
    if a.name == "unknown" or b.name == "unknown":
        return
    try:
        T.common_super_type(a, b)
    except TypeError:
        raise SemanticError(f"cannot compare {a} and {b}")


def _agg_output_type(
    kind: str, in_t: T.Type, in2_t: Optional[T.Type] = None
) -> T.Type:
    if kind in ("count", "count_if", "approx_distinct"):
        if kind == "count_if" and in_t.name not in ("boolean", "unknown"):
            raise SemanticError("count_if requires a boolean argument")
        return T.BIGINT
    if kind == "approx_percentile":
        if not T.is_numeric(in_t) and in_t.name != "unknown":
            raise SemanticError("approx_percentile requires a numeric argument")
        return in_t
    if kind == "array_agg":
        return T.array_of(in_t)
    if kind == "map_agg":
        if in2_t is None:
            raise SemanticError("map_agg(key, value) takes two arguments")
        return T.map_of(in_t, in2_t)
    if kind == "listagg":
        return T.VARCHAR
    if kind in ("min", "max", "arbitrary"):
        return in_t
    if kind in ("min_by", "max_by"):
        if in2_t is not None and not in2_t.orderable:
            raise SemanticError(f"{kind} ordering key must be orderable")
        return in_t
    if kind == "sum":
        if in_t.is_decimal:
            # Trino: sum(decimal(p,s)) -> decimal(38,s) with an Int128
            # accumulator (DecimalSumAggregation); wide chunked sums in
            # ops/aggregation.py make this exact
            return T.decimal(38, in_t.scale)
        if in_t.name in ("double", "real"):
            return T.DOUBLE
        return T.BIGINT
    if kind == "avg":
        if in_t.is_decimal:
            # scale 6 keeps boundary comparisons (e.g. Q17's qty < 0.2*avg)
            # within rounding noise of exact decimal(38) math; integer
            # digits are preserved (Trino: avg(decimal(p,s)) keeps p)
            s = max(in_t.scale, 6)
            return T.decimal(
                min(38, max(in_t.precision - in_t.scale + s, 18)), s
            )
        return T.DOUBLE
    if kind in ("var_samp", "var_pop", "stddev_samp", "stddev_pop",
                "geometric_mean", "covar_pop", "covar_samp", "corr",
                "regr_slope", "regr_intercept"):
        for t in (in_t, in2_t):
            if t is not None and not T.is_numeric(t) and t.name != "unknown":
                raise SemanticError(f"{kind} requires numeric arguments")
        return T.DOUBLE
    if kind in ("bool_and", "bool_or"):
        if in_t.name not in ("boolean", "unknown"):
            raise SemanticError(f"{kind} requires a boolean argument")
        return T.BOOLEAN
    if kind in ("bitwise_and_agg", "bitwise_or_agg", "bitwise_xor_agg"):
        if not T.is_integral(in_t) and in_t.name != "unknown":
            raise SemanticError(f"{kind} requires an integral argument")
        return T.BIGINT
    if kind == "checksum":
        return T.BIGINT
    raise SemanticError(kind)


# constant folding -------------------------------------------------------


def _fold(e: ir.Expr) -> ir.Expr:
    """Evaluate constant-only arithmetic/cast at analysis time
    (IrExpressionInterpreter / constant folding analog)."""
    if isinstance(e, ir.Call):
        # the isDeterministic bit gates folding (the reference's
        # ExpressionInterpreter does the same): rand(seed) over constants
        # is still a fresh value per row
        if e.name in ir.NONDETERMINISTIC_FUNCTIONS:
            return e
        if not all(isinstance(a, ir.Constant) for a in e.args):
            return e
        if any(a.value is None for a in e.args):
            return ir.Constant(e.type, None)
        try:
            v = _eval_const(e.name, e.type, e.args)
        except (NotImplementedError, ValueError, OverflowError, ArithmeticError):
            # domain/overflow errors fall through to the runtime kernels,
            # which mask bad rows to NULL (TRY semantics)
            return e
        if isinstance(v, complex):
            return e
        return ir.Constant(e.type, v)
    if isinstance(e, ir.Cast) and isinstance(e.term, ir.Constant):
        c = e.term
        if c.value is None:
            return ir.Constant(e.type, None)
        if c.type.is_decimal and e.type.is_decimal:
            from ..expr.functions import decimal_rescale
            import numpy as np

            v = int(decimal_rescale(np.int64(c.value), c.type.scale, e.type.scale))
            return ir.Constant(e.type, v)
        if T.is_integral(c.type) and e.type.is_decimal:
            return ir.Constant(e.type, c.value * 10**e.type.scale)
        if c.type.is_decimal and e.type.name == "double":
            return ir.Constant(e.type, c.value / 10**c.type.scale)
    return e


def _eval_const(name: str, out_t: T.Type, args) -> object:
    from ..expr.functions import CONST_EVAL

    if name in CONST_EVAL:
        return CONST_EVAL[name](out_t, args)

    def scaled(a):
        return a.value, (a.type.scale if a.type.is_decimal else 0)

    if name in ("add", "subtract", "multiply", "divide", "negate", "modulus"):
        if out_t.is_decimal:
            (av, asc) = scaled(args[0])
            if name == "negate":
                return -av * 10 ** (out_t.scale - asc)
            (bv, bsc) = scaled(args[1])
            if name == "add" or name == "subtract":
                s = out_t.scale
                av *= 10 ** (s - asc)
                bv *= 10 ** (s - bsc)
                return av + bv if name == "add" else av - bv
            if name == "multiply":
                prod = av * bv  # scale asc+bsc
                from_scale, to_scale = asc + bsc, out_t.scale
                if to_scale >= from_scale:
                    return prod * 10 ** (to_scale - from_scale)
                div = 10 ** (from_scale - to_scale)
                sign = -1 if prod < 0 else 1
                return sign * ((abs(prod) + div // 2) // div)
            if name == "divide":
                shift = out_t.scale - asc + bsc
                num = av * 10**shift
                sign = -1 if (num < 0) != (bv < 0) else 1
                q, r = divmod(abs(num), abs(bv))
                return sign * (q + (1 if 2 * r >= abs(bv) else 0))
        if out_t.name in ("bigint", "integer", "date"):
            av = args[0].value
            if name == "negate":
                return -av
            bv = args[1].value
            return {
                "add": av + bv,
                "subtract": av - bv,
                "multiply": av * bv,
                "divide": av // bv if bv else None,
                "modulus": av % bv if bv else None,
            }[name]
        if out_t.name == "double":
            def dv(a):
                return (
                    a.value / 10**a.type.scale if a.type.is_decimal else float(a.value)
                )

            av = dv(args[0])
            if name == "negate":
                return -av
            bv = dv(args[1])
            return {
                "add": av + bv,
                "subtract": av - bv,
                "multiply": av * bv,
                "divide": av / bv if bv else None,
            }[name]
    raise NotImplementedError(name)


@dataclasses.dataclass(frozen=True)
class SqlFunction:
    """A CREATE FUNCTION definition (expression-bodied SQL routine)."""

    name: str
    params: Tuple[Tuple[str, str], ...]  # (name, type text)
    return_type: str
    body: ast.Node


class MrExprAnalyzer(ExprAnalyzer):
    """MATCH_RECOGNIZE expression analysis: pattern-variable-qualified
    references and navigation functions lower to __mr_*__ calls the
    matcher's evaluator resolves (ops/matcher.py)."""

    NAV = {"prev": "__mr_prev__", "next": "__mr_next__",
           "first": "__mr_first__", "last": "__mr_last__"}

    def __init__(self, analyzer, relation, pattern_vars):
        super().__init__(analyzer, relation)
        self.pattern_vars = pattern_vars

    def _var_ref(self, e: ast.Node):
        """(colref, var) for A.col / col inside navigation, else None."""
        if isinstance(e, ast.Identifier) and len(e.parts) == 2:
            v = e.parts[0].lower()
            if v in self.pattern_vars:
                col = super()._an(ast.Identifier((e.parts[1],)))
                return col, v
        return None

    def _an(self, e: ast.Node) -> ir.Expr:
        vr = self._var_ref(e)
        if vr is not None:  # bare A.col == LAST(A.col)
            col, v = vr
            return ir.Call(col.type, "__mr_last__",
                           (col, ir.Constant(T.VARCHAR, v)))
        if isinstance(e, ast.FunctionCall) and e.name in self.NAV:
            nav = self.NAV[e.name]
            if not e.args:
                raise SemanticError(f"{e.name}() requires an argument")
            if nav in ("__mr_prev__", "__mr_next__"):
                # PREV(A.price) navigates PHYSICAL rows (the variable
                # qualifier is irrelevant to PREV/NEXT in the reference too)
                qual = self._var_ref(e.args[0])
                arg = qual[0] if qual is not None else self._an(e.args[0])
                if not isinstance(arg, ir.ColumnRef):
                    raise SemanticError(
                        f"{e.name}() supports column references only"
                    )
                n = 1
                if len(e.args) > 1:
                    c = self._an(e.args[1])
                    if not isinstance(c, ir.Constant):
                        raise SemanticError(f"{e.name}() offset must be constant")
                    n = int(c.value)
                return ir.Call(arg.type, nav,
                               (arg, ir.Constant(T.BIGINT, n)))
            vr = self._var_ref(e.args[0])
            if vr is not None:
                col, v = vr
            else:
                col = self._an(e.args[0])
                v = ""
                if not isinstance(col, ir.ColumnRef):
                    raise SemanticError(
                        f"{e.name}() supports column references only"
                    )
            return ir.Call(col.type, nav, (col, ir.Constant(T.VARCHAR, v)))
        if isinstance(e, ast.FunctionCall) and e.name == "classifier":
            return ir.Call(T.VARCHAR, "__mr_classifier__", ())
        if isinstance(e, ast.FunctionCall) and e.name == "match_number":
            return ir.Call(T.BIGINT, "__mr_match_number__", ())
        return super()._an(e)
