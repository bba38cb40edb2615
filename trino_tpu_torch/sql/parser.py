"""SQL lexer + Pratt parser.

Reference parity: core/trino-grammar/src/main/antlr4/.../SqlBase.g4 (1419
lines) + SqlParser.java:51.  The reference uses ANTLR; this is a hand-rolled
recursive-descent/Pratt parser over the SELECT-core grammar (ast.py), which
covers the TPC-H/TPC-DS query shapes: joins, subqueries, CTEs, set ops,
CASE/CAST/EXTRACT/BETWEEN/IN/LIKE/EXISTS, date/interval literals.

Operator precedence (low to high), matching SqlBase.g4's expression rules:
  OR < AND < NOT < comparison|BETWEEN|IN|LIKE|IS < + - || < * / % < unary.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

from . import ast

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*\n?|/\*.*?\*/)
  | (?P<number>\d+(\.\d*)?([eE][+-]?\d+)?|\.\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|\|\||=>|->|[-+*/%(),.;=<>\[\]?|])
""",
    re.VERBOSE | re.DOTALL,
)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "create", "table", "insert", "into", "delete", "drop", "update",
    "as", "and", "or", "not", "in", "exists", "between", "like", "escape",
    "is", "null", "true", "false", "case", "when", "then", "else", "end",
    "cast", "try_cast", "extract", "join", "inner", "left", "right", "full",
    "outer", "cross", "on", "using", "union", "intersect", "except", "all",
    "distinct", "with", "asc", "desc", "nulls", "first", "last", "date",
    "timestamp", "interval", "year", "month", "day", "hour", "minute",
    "second", "quarter", "explain", "analyze", "show", "tables", "columns",
    "substring", "for", "fetch", "offset", "rows", "row", "only", "values",
    "set", "session", "over", "partition", "range", "groups", "unbounded",
    "preceding", "following", "current",
}


class Token:
    __slots__ = ("kind", "text", "pos")

    def __init__(self, kind: str, text: str, pos: int):
        self.kind = kind  # number|string|ident|qident|op|kw|eof
        self.text = text
        self.pos = pos

    def __repr__(self):
        return f"{self.kind}:{self.text}"


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise ParseError(f"unexpected character {sql[i]!r} at {i}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "ident" and text.lower() in KEYWORDS:
            out.append(Token("kw", text.lower(), m.start()))
        elif kind == "qident":
            out.append(Token("ident", text[1:-1].replace('""', '"'), m.start()))
        else:
            out.append(Token(kind, text, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


class ParseError(ValueError):
    pass


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0
        self._param_count = 0  # positional ? parameters seen so far

    # --- token helpers -------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.text in kws

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str):
        if not self.accept_kw(kw):
            raise ParseError(f"expected {kw.upper()} at {self.peek()!r}")

    def accept_soft(self, word: str) -> bool:
        """Accept a soft keyword (lexes as ident; e.g. IF in DDL)."""
        t = self.peek()
        if t.kind == "ident" and t.text.lower() == word:
            self.next()
            return True
        return False

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.text == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str):
        if not self.accept_op(op):
            raise ParseError(f"expected {op!r} at {self.peek()!r} in {self.sql[max(0,self.peek().pos-30):self.peek().pos+10]!r}")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            return self.next().text
        # soft keywords usable as identifiers
        if t.kind == "kw" and t.text in (
            "year", "month", "day", "date", "first", "last", "left", "right",
            "tables", "columns", "values", "row", "rows",
        ):
            return self.next().text
        raise ParseError(f"expected identifier at {t!r}")

    # --- entry ---------------------------------------------------------
    def parse_statement(self) -> ast.Node:
        if self.accept_kw("explain"):
            analyze = self.accept_kw("analyze")
            plan_type = "logical"
            if self.accept_op("("):
                while True:
                    if self.accept_soft("type"):
                        t = self.next()
                        if t.text.lower() not in ("logical", "distributed"):
                            raise ParseError(
                                "EXPLAIN (TYPE LOGICAL|DISTRIBUTED)"
                            )
                        plan_type = t.text.lower()
                    else:
                        raise ParseError(f"unknown EXPLAIN option {self.peek()!r}")
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            q = self.parse_query()
            self._finish()
            return ast.Explain(q, analyze, plan_type)
        if self.accept_kw("analyze"):
            name = self.qualified_name()
            columns = []
            if self.accept_op("("):
                while True:
                    columns.append(self.ident())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            self._finish()
            return ast.Analyze(name, tuple(columns))
        if self.accept_kw("show"):
            if self.accept_kw("tables"):
                self._finish()
                return ast.ShowTables()
            if self.accept_soft("functions"):
                self._finish()
                return ast.ShowFunctions()
            if self.accept_soft("catalogs"):
                self._finish()
                return ast.ShowCatalogs()
            if self.accept_soft("schemas"):
                cat = None
                if self.accept_kw("from") or self.accept_kw("in"):
                    cat = self.ident()
                self._finish()
                return ast.ShowSchemas(cat)
            if self.accept_soft("stats"):
                self.expect_kw("for")
                name = self.qualified_name()
                self._finish()
                return ast.ShowStats(name)
            if self.accept_kw("create"):
                if self.accept_soft("view"):
                    name = self.qualified_name()
                    self._finish()
                    return ast.ShowCreateView(name)
                self.expect_kw("table")
                name = self.qualified_name()
                self._finish()
                return ast.ShowCreateTable(name)
            if self.accept_kw("columns"):
                self.expect_kw("from")
                name = self.qualified_name()
                self._finish()
                return ast.ShowColumns(name)
            if self.accept_kw("session"):
                self._finish()
                return ast.ShowSession()
            raise ParseError("SHOW TABLES | SHOW COLUMNS FROM t | SHOW SESSION")
        if self.accept_kw("set"):
            self.expect_kw("session")
            name = self.ident()
            while self.accept_op("."):  # catalog.property form
                name += "." + self.ident()
            self.expect_op("=")
            t = self.next()
            if t.kind == "string":
                value = t.text[1:-1].replace("''", "'")
            elif t.kind in ("number", "ident", "kw"):
                value = t.text
            else:
                raise ParseError(f"bad SET SESSION value {t!r}")
            self._finish()
            return ast.SetSession(name, value)
        if self.accept_soft("use"):
            name = self.qualified_name()
            self._finish()
            return ast.Use(name)
        if self.accept_soft("start"):
            if not self.accept_soft("transaction"):
                raise ParseError("expected TRANSACTION after START")
            self._finish()
            return ast.TransactionControl("start")
        if self.accept_soft("commit"):
            self.accept_soft("work")
            self._finish()
            return ast.TransactionControl("commit")
        if self.accept_soft("rollback"):
            self.accept_soft("work")
            self._finish()
            return ast.TransactionControl("rollback")
        if self.accept_soft("prepare"):
            name = self.ident()
            self.expect_kw("from")
            stmt = self.parse_statement()
            return ast.Prepare(name, stmt)
        if self.accept_soft("execute"):
            name = self.ident()
            args: List[ast.Node] = []
            if self.accept_kw("using"):
                args.append(self.expr())
                while self.accept_op(","):
                    args.append(self.expr())
            self._finish()
            return ast.ExecutePrepared(name, tuple(args))
        if self.accept_soft("deallocate"):
            self.accept_soft("prepare")
            name = self.ident()
            self._finish()
            return ast.Deallocate(name)
        if self.accept_soft("describe"):
            if self.accept_soft("input"):
                name = self.ident()
                self._finish()
                return ast.Describe("input", name)
            if self.accept_soft("output"):
                name = self.ident()
                self._finish()
                return ast.Describe("output", name)
            name = self.qualified_name()
            self._finish()
            return ast.ShowColumns(name)
        if self.accept_kw("create"):
            replace = False
            if self.accept_kw("or"):
                if not self.accept_soft("replace"):
                    raise ParseError("expected REPLACE after CREATE OR")
                replace = True
            if self.accept_soft("function"):
                return self._create_function(replace)
            if self.accept_soft("view"):
                name = self.qualified_name()
                self.expect_kw("as")
                qpos = self.peek().pos
                q = self.parse_query()
                qtext = self.sql[qpos:].strip().rstrip(";").strip()
                self._finish()
                return ast.CreateView(name, q, qtext, replace)
            self.expect_kw("table")
            ine = False
            if self.accept_soft("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                ine = True
            name = self.qualified_name()
            if self.accept_kw("as"):
                q = self.parse_query()
                self._finish()
                return ast.CreateTableAs(name, q, ine)
            self.expect_op("(")
            cols = [self.column_def()]
            while self.accept_op(","):
                cols.append(self.column_def())
            self.expect_op(")")
            self._finish()
            return ast.CreateTable(name, tuple(cols), ine)
        if self.accept_kw("insert"):
            self.expect_kw("into")
            name = self.qualified_name()
            cols: List[str] = []
            # '(' starts either a column list or a parenthesized query
            if (self.peek().kind == "op" and self.peek().text == "("
                    and self.peek(1).kind == "ident"):
                self.expect_op("(")
                cols.append(self.ident())
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            q = self.parse_query()
            self._finish()
            return ast.Insert(name, tuple(cols), q)
        if self.accept_kw("delete"):
            self.expect_kw("from")
            name = self.qualified_name()
            where = self.expr() if self.accept_kw("where") else None
            self._finish()
            return ast.Delete(name, where)
        if self.accept_soft("merge"):
            self.expect_kw("into")
            name = self.qualified_name()
            talias = None
            if self.accept_kw("as"):
                talias = self.ident()
            elif self.peek().kind == "ident" and not self.at_kw("using"):
                talias = self.next().text
            self.expect_kw("using")
            source = self.relation_primary()
            self.expect_kw("on")
            cond = self.expr()
            whens = []
            while self.accept_kw("when"):
                negate = self.accept_kw("not")
                if not self.accept_soft("matched"):
                    raise ParseError("expected MATCHED in MERGE WHEN clause")
                extra = self.expr() if self.accept_kw("and") else None
                self.expect_kw("then")
                if self.accept_kw("update"):
                    self.expect_kw("set")
                    assigns = []
                    while True:
                        col = self.ident()
                        self.expect_op("=")
                        assigns.append((col, self.expr()))
                        if not self.accept_op(","):
                            break
                    whens.append(ast.MergeWhen(
                        not negate, extra, "update", tuple(assigns)
                    ))
                elif self.accept_kw("delete"):
                    whens.append(ast.MergeWhen(not negate, extra, "delete"))
                elif self.accept_kw("insert"):
                    cols = []
                    if self.accept_op("("):
                        cols.append(self.ident())
                        while self.accept_op(","):
                            cols.append(self.ident())
                        self.expect_op(")")
                    self.expect_kw("values")
                    self.expect_op("(")
                    vals = [self.expr()]
                    while self.accept_op(","):
                        vals.append(self.expr())
                    self.expect_op(")")
                    whens.append(ast.MergeWhen(
                        not negate, extra, "insert", (),
                        tuple(cols), tuple(vals),
                    ))
                else:
                    raise ParseError(
                        "MERGE THEN expects UPDATE SET / DELETE / INSERT"
                    )
            if not whens:
                raise ParseError("MERGE requires at least one WHEN clause")
            self._finish()
            return ast.MergeInto(name, talias, source, cond, tuple(whens))
        if self.accept_kw("update"):
            name = self.qualified_name()
            self.expect_kw("set")
            assigns = []
            while True:
                col = self.ident()
                self.expect_op("=")
                assigns.append((col, self.expr()))
                if not self.accept_op(","):
                    break
            where = self.expr() if self.accept_kw("where") else None
            self._finish()
            return ast.Update(name, tuple(assigns), where)
        if self.accept_kw("drop"):
            if self.accept_soft("function"):
                ie = False
                if self.accept_soft("if"):
                    self.expect_kw("exists")
                    ie = True
                name = self.ident()
                self._finish()
                return ast.DropFunction(name, ie)
            if self.accept_soft("view"):
                ie = False
                if self.accept_soft("if"):
                    self.expect_kw("exists")
                    ie = True
                name = self.qualified_name()
                self._finish()
                return ast.DropView(name, ie)
            self.expect_kw("table")
            ie = False
            if self.accept_soft("if"):
                self.expect_kw("exists")
                ie = True
            name = self.qualified_name()
            self._finish()
            return ast.DropTable(name, ie)
        q = self.parse_query()
        self._finish()
        return q

    def column_def(self) -> Tuple[str, str]:
        """column definition: name + SQL type text (types.parse_type forms)."""
        name = self.ident()
        return name, self.type_text()

    def type_text(self) -> str:
        t = self.next()
        if t.kind not in ("ident", "kw"):
            raise ParseError(f"expected a type name at {t!r}")
        type_text = t.text
        if self.accept_op("("):
            depth = 1
            type_text += "("
            while depth:
                tok = self.next()
                if tok.kind == "eof":
                    raise ParseError("unterminated type")
                if tok.kind == "op" and tok.text == "(":
                    depth += 1
                if tok.kind == "op" and tok.text == ")":
                    depth -= 1
                    if not depth:
                        break
                type_text += tok.text
            type_text += ")"
        return type_text

    def _create_function(self, replace: bool) -> ast.Node:
        """CREATE FUNCTION name (p type, ...) RETURNS type
        [DETERMINISTIC] RETURN expr  (SqlBase.g4 functionSpecification,
        expression-bodied SQL routines)."""
        name = self.ident()
        self.expect_op("(")
        params: List[Tuple[str, str]] = []
        if not self.accept_op(")"):
            params.append(self.column_def())
            while self.accept_op(","):
                params.append(self.column_def())
            self.expect_op(")")
        if not self.accept_soft("returns"):
            raise ParseError("expected RETURNS in CREATE FUNCTION")
        rtype = self.type_text()
        self.accept_soft("deterministic")
        if not self.accept_soft("return"):
            raise ParseError(
                "expected RETURN <expression> (only expression-bodied "
                "functions are supported)"
            )
        body = self.expr()
        self._finish()
        return ast.CreateFunction(name, tuple(params), rtype, body, replace)

    def _finish(self):
        self.accept_op(";")
        if self.peek().kind != "eof":
            raise ParseError(f"trailing input at {self.peek()!r}")

    # --- query ---------------------------------------------------------
    def parse_query(self) -> ast.Query:
        withs: List[ast.With] = []
        if self.accept_kw("with"):
            while True:
                name = self.ident()
                cols = None
                if self.accept_op("("):
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                withs.append(ast.With(name, q, tuple(cols) if cols else None))
                if not self.accept_op(","):
                    break
        body = self.parse_set_expr()
        order: List[ast.SortItem] = []
        limit = None
        if self.accept_kw("order"):
            self.expect_kw("by")
            order.append(self.sort_item())
            while self.accept_op(","):
                order.append(self.sort_item())
        offset = 0
        if self.accept_kw("offset"):
            offset = self._int_token(self.next(), "OFFSET")
            self.accept_kw("rows") or self.accept_kw("row")
        if self.accept_kw("limit"):
            t = self.next()
            if t.kind == "kw" and t.text == "all":
                limit = None
            else:
                limit = self._int_token(t, "LIMIT")
        elif self.accept_kw("fetch"):
            (self.accept_kw("first") or self.accept_kw("next")
             or self.accept_soft("next"))
            limit = self._int_token(self.next(), "FETCH")
            self.accept_kw("rows") or self.accept_kw("row")
            self.expect_kw("only")
        return ast.Query(body, tuple(order), limit, tuple(withs), offset)

    def sort_item(self) -> ast.SortItem:
        e = self.expr()
        asc = True
        if self.accept_kw("asc"):
            asc = True
        elif self.accept_kw("desc"):
            asc = False
        nf = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nf = True
            else:
                self.expect_kw("last")
                nf = False
        return ast.SortItem(e, asc, nf)

    def parse_set_expr(self) -> ast.Node:
        # INTERSECT binds tighter than UNION/EXCEPT (SqlBase.g4 precedence)
        left = self.parse_intersect_expr()
        while self.at_kw("union", "except"):
            kind = self.next().text
            all_ = self.accept_kw("all")
            self.accept_kw("distinct")
            right = self.parse_intersect_expr()
            left = ast.SetOp(kind, all_, left, right)
        return left

    def parse_intersect_expr(self) -> ast.Node:
        left = self.parse_query_primary()
        while self.at_kw("intersect"):
            self.next()
            all_ = self.accept_kw("all")
            self.accept_kw("distinct")
            right = self.parse_query_primary()
            left = ast.SetOp("intersect", all_, left, right)
        return left

    def parse_query_primary(self) -> ast.Node:
        if self.accept_op("("):
            # a parenthesized branch may carry its own ORDER BY / LIMIT
            q = self.parse_query()
            self.expect_op(")")
            if not q.withs and not q.order_by and q.limit is None:
                return q.body
            return q
        if self.at_kw("values"):
            self.next()
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return ast.ValuesRelation(tuple(rows))
        return self.parse_query_spec()

    def _values_row(self) -> tuple:
        self.expect_op("(")
        row = [self.expr()]
        while self.accept_op(","):
            row.append(self.expr())
        self.expect_op(")")
        return tuple(row)

    def _int_token(self, t: Token, clause: str) -> int:
        if t.kind != "number" or not t.text.isdigit():
            raise ParseError(f"{clause} expects an integer, got {t!r}")
        return int(t.text)

    def parse_query_spec(self) -> ast.QuerySpec:
        self.expect_kw("select")
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        items: List[ast.Node] = [self.select_item()]
        while self.accept_op(","):
            items.append(self.select_item())
        relation = None
        where = None
        group: List[ast.Node] = []
        having = None
        if self.accept_kw("from"):
            relation = self.parse_relation()
        if self.accept_kw("where"):
            where = self.expr()
        if self.accept_kw("group"):
            self.expect_kw("by")
            group.append(self.group_element())
            while self.accept_op(","):
                group.append(self.group_element())
        if self.accept_kw("having"):
            having = self.expr()
        return ast.QuerySpec(
            tuple(items), relation, where, tuple(group), having, distinct
        )

    def group_element(self) -> ast.Node:
        """groupingElement (SqlBase.g4): ROLLUP (...) | CUBE (...) |
        GROUPING SETS ((...), ...) | expression.  The construct words are
        soft keywords — only recognized in this position."""
        t = self.peek()
        if (t.kind == "ident" and t.text.lower() in ("rollup", "cube")
                and self.peek(1).kind == "op" and self.peek(1).text == "("):
            word = self.next().text.lower()
            self.expect_op("(")
            items = [self.expr()]
            while self.accept_op(","):
                items.append(self.expr())
            self.expect_op(")")
            node = ast.Rollup if word == "rollup" else ast.Cube
            return node(tuple(items))
        if (t.kind == "ident" and t.text.lower() == "grouping"
                and self.peek(1).kind == "ident"
                and self.peek(1).text.lower() == "sets"):
            self.next()
            self.next()
            self.expect_op("(")
            sets = [self._grouping_set()]
            while self.accept_op(","):
                sets.append(self._grouping_set())
            self.expect_op(")")
            return ast.GroupingSets(tuple(sets))
        return self.expr()

    def _grouping_set(self) -> tuple:
        if self.accept_op("("):
            if self.accept_op(")"):
                return ()  # the grand-total set
            items = [self.expr()]
            while self.accept_op(","):
                items.append(self.expr())
            self.expect_op(")")
            return tuple(items)
        return (self.expr(),)

    def select_item(self) -> ast.Node:
        if self.accept_op("*"):
            return ast.Star()
        # t.* form
        if (
            self.peek().kind == "ident"
            and self.peek(1).kind == "op"
            and self.peek(1).text == "."
            and self.peek(2).kind == "op"
            and self.peek(2).text == "*"
        ):
            q = self.next().text
            self.next()
            self.next()
            return ast.Star(q)
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.next().text
        return ast.SelectItem(e, alias)

    # --- relations -----------------------------------------------------
    def parse_relation(self) -> ast.Node:
        rel = self.join_chain()
        while self.accept_op(","):  # implicit cross join
            right = self.join_chain()
            rel = ast.Join("cross", rel, right, None)
        return rel

    def join_chain(self) -> ast.Node:
        rel = self.relation_primary()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.relation_primary()
                rel = ast.Join("cross", rel, right, None)
                continue
            kind = None
            if self.at_kw("join"):
                kind = "inner"
            elif self.at_kw("inner") and self.peek(1).text == "join":
                self.next()
                kind = "inner"
            elif self.at_kw("left", "right", "full"):
                k = self.peek().text
                nxt1 = self.peek(1)
                nxt2 = self.peek(2)
                if (nxt1.kind == "kw" and nxt1.text == "join") or (
                    nxt1.kind == "kw" and nxt1.text == "outer"
                    and nxt2.kind == "kw" and nxt2.text == "join"
                ):
                    self.next()
                    self.accept_kw("outer")
                    kind = k
            if kind is None:
                return rel
            self.expect_kw("join")
            right = self.relation_primary()
            if self.accept_kw("on"):
                rel = ast.Join(kind, rel, right, self.expr())
            elif self.accept_kw("using"):
                self.expect_op("(")
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                rel = ast.Join(kind, rel, right, None, tuple(cols))
            else:
                raise ParseError("JOIN requires ON or USING")

    def _match_recognize(self, rel: ast.Node) -> ast.Node:
        """MATCH_RECOGNIZE clause after a relation (row pattern recognition)."""
        self.expect_op("(")
        partition: List[ast.Node] = []
        order: List[ast.SortItem] = []
        measures: List[tuple] = []
        after = "past_last_row"
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.expr())
            while self.accept_op(","):
                partition.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order.append(self.sort_item())
            while self.accept_op(","):
                order.append(self.sort_item())
        if self.accept_soft("measures"):
            while True:
                e = self.expr()
                self.expect_kw("as")
                measures.append((e, self.ident()))
                if not self.accept_op(","):
                    break
        rows_per = "one"
        if self.accept_soft("one"):
            self.expect_kw("row")
            if not self.accept_soft("per"):
                raise ParseError("expected PER MATCH")
            if not self.accept_soft("match"):
                raise ParseError("expected MATCH")
        elif self.accept_kw("all"):
            self.expect_kw("rows")
            if not self.accept_soft("per"):
                raise ParseError("expected PER MATCH")
            if not self.accept_soft("match"):
                raise ParseError("expected MATCH")
            rows_per = "all"
        if self.accept_soft("after"):
            if not self.accept_soft("match"):
                raise ParseError("expected MATCH after AFTER")
            if not self.accept_soft("skip"):
                raise ParseError("expected SKIP")
            if self.accept_soft("past"):
                self.expect_kw("last")
                self.expect_kw("row")
                after = "past_last_row"
            elif self.accept_soft("to"):
                if not self.accept_soft("next"):
                    raise ParseError("expected NEXT ROW")
                self.expect_kw("row")
                after = "to_next_row"
            else:
                raise ParseError("AFTER MATCH SKIP PAST LAST ROW|TO NEXT ROW")
        if not self.accept_soft("pattern"):
            raise ParseError("MATCH_RECOGNIZE requires PATTERN (...)")
        self.expect_op("(")
        pattern = self._pattern_alt()
        self.expect_op(")")
        defines: List[tuple] = []
        if self.accept_soft("define"):
            while True:
                var = self.ident().lower()
                self.expect_kw("as")
                defines.append((var, self.expr()))
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.next().text
        return ast.MatchRecognize(
            rel, tuple(partition), tuple(order), tuple(measures),
            pattern, tuple(defines), after, alias, rows_per,
        )

    def _pattern_alt(self) -> ast.PatternTerm:
        branches = [self._pattern_seq()]
        while self.accept_op("|"):
            branches.append(self._pattern_seq())
        if len(branches) == 1:
            return branches[0]
        return ast.PatternTerm("alt", items=tuple(branches))

    def _pattern_seq(self) -> ast.PatternTerm:
        items: List[ast.PatternTerm] = []
        while True:
            t = self.peek()
            if t.kind == "op" and t.text == "(":
                self.next()
                inner = self._pattern_alt()
                self.expect_op(")")
                atom = ast.PatternTerm("group", items=(inner,))
            elif (
                t.kind in ("ident", "kw")
                and t.text.lower() == "permute"
                and self.peek(1).kind == "op"
                and self.peek(1).text == "("
            ):
                # PERMUTE(A, B, ...) = alternation of every ordering, in
                # lexicographic preference order (SqlBase.g4 patternPermute
                # -> the reference expands identically)
                self.next()
                self.next()
                vars_ = [self._pattern_alt()]
                while self.accept_op(","):
                    vars_.append(self._pattern_alt())
                self.expect_op(")")
                if len(vars_) > 6:
                    raise ParseError(
                        "PERMUTE supports at most 6 elements "
                        f"({len(vars_)} given: {len(vars_)}! orderings)"
                    )
                import itertools

                branches = tuple(
                    ast.PatternTerm("group", items=tuple(perm))
                    for perm in itertools.permutations(vars_)
                )
                atom = ast.PatternTerm(
                    "group",
                    items=(ast.PatternTerm("alt", items=branches),),
                )
            elif t.kind in ("ident", "kw") and t.text not in (")", "|"):
                if t.kind == "kw" and t.text in ("define",):
                    break
                atom = ast.PatternTerm("var", var=self.next().text.lower())
            else:
                break
            q = ""
            greedy = True
            nt = self.peek()
            if nt.kind == "op" and nt.text in ("*", "+", "?"):
                q = self.next().text
                if self.peek().kind == "op" and self.peek().text == "?":
                    self.next()
                    greedy = False
            atom = dataclasses.replace(atom, quantifier=q, greedy=greedy)
            items.append(atom)
        if len(items) == 1:
            return items[0]
        return ast.PatternTerm("group", items=tuple(items))

    def _table_function(self) -> ast.Node:
        """TABLE(fn(arg [, ...])) with scalar, TABLE(rel) and
        DESCRIPTOR(col, ...) arguments; `name =>` prefixes accepted."""
        self.next()  # TABLE
        self.expect_op("(")
        fn = self.ident().lower()
        self.expect_op("(")
        args = []
        if not (self.peek().kind == "op" and self.peek().text == ")"):
            while True:
                # optional named-argument prefix
                if (self.peek().kind == "ident"
                        and self.peek(1).kind == "op"
                        and self.peek(1).text == "=>"):
                    self.next()
                    self.next()
                t = self.peek()
                low = t.text.lower() if t.kind in ("ident", "kw") else ""
                if low == "table" and self.peek(1).text == "(":
                    self.next()
                    self.expect_op("(")
                    rel = self.parse_relation()
                    self.expect_op(")")
                    args.append(("table", rel))
                elif low == "descriptor" and self.peek(1).text == "(":
                    self.next()
                    self.expect_op("(")
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                    args.append(("descriptor", tuple(cols)))
                else:
                    args.append(("scalar", self.expr()))
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        self.expect_op(")")
        alias = None
        cols = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "ident":
            alias = self.next().text
        if alias is not None and self.accept_op("("):
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        return ast.TableFunctionRelation(
            fn, tuple(args), alias, tuple(cols) if cols else None
        )

    def _sample_clause(self):
        t2 = self.next()
        if t2.kind != "ident" or t2.text.lower() not in (
            "bernoulli", "system",
        ):
            raise ParseError("TABLESAMPLE BERNOULLI|SYSTEM (p)")
        method = t2.text.lower()
        self.expect_op("(")
        pct = self.next()
        if pct.kind != "number":
            raise ParseError("TABLESAMPLE percentage must be a number")
        self.expect_op(")")
        return (method, float(pct.text))

    def relation_primary(self) -> ast.Node:
        t = self.peek()
        if (t.kind in ("ident", "kw") and t.text.lower() == "table"
                and self.peek(1).kind == "op" and self.peek(1).text == "("):
            return self._table_function()
        if (t.kind == "ident" and t.text.lower() == "unnest"
                and self.peek(1).kind == "op" and self.peek(1).text == "("):
            self.next()
            self.next()
            exprs = [self.expr()]
            while self.accept_op(","):
                exprs.append(self.expr())
            self.expect_op(")")
            ordinality = False
            if self.accept_kw("with"):
                if not self.accept_soft("ordinality"):
                    raise ParseError("expected ORDINALITY after WITH")
                ordinality = True
            alias = None
            cols = None
            if self.accept_kw("as"):
                alias = self.ident()
            elif self.peek().kind == "ident":
                alias = self.next().text
            if alias is not None and self.accept_op("("):
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            return ast.UnnestRelation(
                tuple(exprs), alias, tuple(cols) if cols else None,
                ordinality,
            )
        if self.accept_op("("):
            # subquery or parenthesized join
            if self.at_kw("select", "with", "values"):
                q = self.parse_query()
                self.expect_op(")")
                alias = None
                cols = None
                if self.accept_kw("as"):
                    alias = self.ident()
                elif self.peek().kind == "ident":
                    alias = self.next().text
                if alias is not None and self.accept_op("("):
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                return ast.SubqueryRelation(q, alias, tuple(cols) if cols else None)
            rel = self.parse_relation()
            self.expect_op(")")
            return rel
        name = self.qualified_name()
        version = None
        if self.accept_kw("for"):
            # time travel: FOR VERSION AS OF n / FOR TIMESTAMP AS OF t
            if self.accept_soft("version"):
                kind = "version"
            elif self.accept_kw("timestamp"):
                kind = "timestamp"
            else:
                raise ParseError(
                    f"expected VERSION or TIMESTAMP after FOR "
                    f"at {self.peek()!r}"
                )
            self.expect_kw("as")
            if not self.accept_soft("of"):
                raise ParseError(
                    f"expected OF after {kind.upper()} AS "
                    f"at {self.peek()!r}"
                )
            version = (kind, self.expr())
        sample = None
        if self.accept_soft("tablesample"):
            sample = self._sample_clause()
        if (self.peek().kind == "ident"
                and self.peek().text.lower() == "match_recognize"):
            self.next()
            return self._match_recognize(
                ast.Table(name, None, sample, version)
            )
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif (self.peek().kind == "ident"
              and self.peek().text.lower() != "tablesample"):
            alias = self.next().text
        if sample is None and self.accept_soft("tablesample"):
            # grammar-conformant order: alias before TABLESAMPLE
            sample = self._sample_clause()
        return ast.Table(name, alias, sample, version)

    def qualified_name(self) -> Tuple[str, ...]:
        parts = [self.ident()]
        while (
            self.peek().kind == "op"
            and self.peek().text == "."
            and self.peek(1).kind in ("ident", "kw")
        ):
            self.next()
            parts.append(self.ident())
        return tuple(parts)

    # --- expressions (Pratt) -------------------------------------------
    def expr(self) -> ast.Node:
        return self.or_expr()

    def or_expr(self) -> ast.Node:
        terms = [self.and_expr()]
        while self.accept_kw("or"):
            terms.append(self.and_expr())
        return terms[0] if len(terms) == 1 else ast.LogicalOp("or", tuple(terms))

    def and_expr(self) -> ast.Node:
        terms = [self.not_expr()]
        while self.accept_kw("and"):
            terms.append(self.not_expr())
        return terms[0] if len(terms) == 1 else ast.LogicalOp("and", tuple(terms))

    def not_expr(self) -> ast.Node:
        if self.accept_kw("not"):
            return ast.NotOp(self.not_expr())
        return self.predicate()

    def predicate(self) -> ast.Node:
        left = self.additive()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("=", "<>", "!=", "<", "<=", ">", ">="):
                self.next()
                right = self.additive()
                left = ast.ComparisonOp(
                    "<>" if t.text == "!=" else t.text, left, right
                )
                continue
            negate = False
            save = self.i
            if self.accept_kw("not"):
                negate = True
            if self.accept_kw("between"):
                lo = self.additive()
                self.expect_kw("and")
                hi = self.additive()
                left = ast.BetweenOp(left, lo, hi, negate)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.parse_query()
                    self.expect_op(")")
                    left = ast.InSubquery(left, q, negate)
                else:
                    items = [self.expr()]
                    while self.accept_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    left = ast.InList(left, tuple(items), negate)
                continue
            if self.accept_kw("like"):
                pat = self.additive()
                esc = None
                if self.accept_kw("escape"):
                    esc = self.additive()
                left = ast.LikeOp(left, pat, esc, negate)
                continue
            if negate:
                self.i = save
                break
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                if self.accept_kw("null"):
                    left = ast.IsNullOp(left, neg)
                elif self.accept_kw("distinct"):
                    self.expect_kw("from")
                    right = self.additive()
                    cmp = ast.ComparisonOp("is_distinct", left, right)
                    left = ast.NotOp(cmp) if neg else cmp
                else:
                    raise ParseError(f"IS what? at {self.peek()!r}")
                continue
            break
        return left

    def additive(self) -> ast.Node:
        left = self.multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("+", "-", "||"):
                self.next()
                left = ast.BinaryOp(t.text, left, self.multiplicative())
            else:
                return left

    def multiplicative(self) -> ast.Node:
        left = self.unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ("*", "/", "%"):
                self.next()
                left = ast.BinaryOp(t.text, left, self.unary())
            else:
                return left

    def unary(self) -> ast.Node:
        if self.accept_op("-"):
            return ast.UnaryOp("-", self.unary())
        if self.accept_op("+"):
            return self.unary()
        return self.postfix()

    def postfix(self) -> ast.Node:
        e = self.primary()
        while self.accept_op("["):
            # subscript: a[i] == element_at(a, i) (SqlBase.g4 subscript)
            idx = self.expr()
            self.expect_op("]")
            e = ast.FunctionCall("element_at", (e, idx))
        return e

    def primary(self) -> ast.Node:
        t = self.peek()
        # lambda: x -> body | (x, y) -> body
        if (t.kind == "ident" and self.peek(1).kind == "op"
                and self.peek(1).text == "->"):
            name = self.next().text
            self.next()  # ->
            return ast.Lambda((name,), self.expr())
        if (t.kind == "op" and t.text == "("
                and self.peek(1).kind == "ident"
                and self.peek(2).kind == "op"
                and self.peek(2).text in (",", ")")):
            # possible multi-param lambda: scan for ') ->'
            save = self.i
            self.next()
            params = [self.peek().text]
            if self.peek().kind == "ident":
                self.next()
                while self.accept_op(","):
                    if self.peek().kind != "ident":
                        params = None
                        break
                    params.append(self.next().text)
                if (params is not None and self.accept_op(")")
                        and self.accept_op("->")):
                    return ast.Lambda(tuple(params), self.expr())
            self.i = save
        if t.kind == "ident" and t.text.lower() in (
            "current_date", "current_timestamp", "localtimestamp",
        ) and not (self.peek(1).kind == "op" and self.peek(1).text == "("):
            self.next()
            return ast.FunctionCall(t.text.lower(), ())
        if (t.kind == "ident" and t.text.lower() == "array"
                and self.peek(1).kind == "op" and self.peek(1).text == "["):
            self.next()
            self.next()
            items: List[ast.Node] = []
            if not self.accept_op("]"):
                items.append(self.expr())
                while self.accept_op(","):
                    items.append(self.expr())
                self.expect_op("]")
            return ast.ArrayLiteral(tuple(items))
        if t.kind == "op" and t.text == "?":
            self.next()
            p = ast.Parameter(self._param_count)
            self._param_count += 1
            return p
        if t.kind == "number":
            self.next()
            if "." in t.text or "e" in t.text.lower():
                if "e" in t.text.lower():
                    return ast.Literal("double", float(t.text))
                return ast.Literal("decimal", t.text)
            return ast.Literal("integer", int(t.text))
        if t.kind == "string":
            self.next()
            return ast.Literal("string", t.text[1:-1].replace("''", "'"))
        if t.kind == "op" and t.text == "(":
            self.next()
            if self.at_kw("select", "with"):
                q = self.parse_query()
                self.expect_op(")")
                return ast.ScalarSubquery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "kw":
            if self.accept_kw("null"):
                return ast.Literal("null", None)
            if self.accept_kw("true"):
                return ast.Literal("boolean", True)
            if self.accept_kw("false"):
                return ast.Literal("boolean", False)
            if self.accept_kw("exists"):
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                return ast.Exists(q, False)
            if self.accept_kw("cast") or (
                t.text == "try_cast" and self.accept_kw("try_cast")
            ):
                safe = t.text == "try_cast"
                self.expect_op("(")
                e = self.expr()
                self.expect_kw("as")
                tn = self.type_name()
                self.expect_op(")")
                return ast.CastOp(e, tn, safe)
            if self.accept_kw("extract"):
                self.expect_op("(")
                field = self.next().text.lower()
                self.expect_kw("from")
                e = self.expr()
                self.expect_op(")")
                return ast.ExtractOp(field, e)
            if self.accept_kw("case"):
                operand = None
                if not self.at_kw("when"):
                    operand = self.expr()
                whens = []
                while self.accept_kw("when"):
                    c = self.expr()
                    self.expect_kw("then")
                    r = self.expr()
                    whens.append(ast.WhenClause(c, r))
                default = None
                if self.accept_kw("else"):
                    default = self.expr()
                self.expect_kw("end")
                return ast.CaseExpr(operand, tuple(whens), default)
            if self.at_kw("date", "timestamp") and self.peek(1).kind == "string":
                kind = self.next().text
                v = self.next().text
                return ast.TypedLiteral(kind, v[1:-1])
            if (
                self.at_kw("date", "timestamp")
                and self.peek(1).kind == "op"
                and self.peek(1).text == "("
            ):
                # date('1994-01-01') function form -> typed literal / cast
                kind = self.next().text
                self.next()
                e = self.expr()
                self.expect_op(")")
                if isinstance(e, ast.Literal) and e.kind == "string":
                    return ast.TypedLiteral(kind, e.value)
                return ast.CastOp(e, kind)
            if self.accept_kw("interval"):
                sign = -1 if self.accept_op("-") else 1
                v = self.next()
                if v.kind not in ("string", "number"):
                    raise ParseError(f"INTERVAL expects a value, got {v!r}")
                txt = v.text[1:-1] if v.kind == "string" else v.text
                u = self.peek()
                units = ("year", "month", "day", "hour", "minute", "second")
                if not (u.kind == "kw" and u.text.rstrip("s") in units) and not (
                    u.kind == "ident" and u.text.lower().rstrip("s") in units
                ):
                    raise ParseError(f"INTERVAL expects a unit, got {u!r}")
                unit = self.next().text.lower()
                if sign < 0:
                    txt = "-" + txt
                return ast.TypedLiteral("interval", txt, unit)
            if self.accept_kw("substring"):
                self.expect_op("(")
                e = self.expr()
                if self.accept_kw("from"):
                    start = self.expr()
                    length = None
                    if self.accept_kw("for"):
                        length = self.expr()
                else:
                    self.expect_op(",")
                    start = self.expr()
                    length = None
                    if self.accept_op(","):
                        length = self.expr()
                self.expect_op(")")
                args = (e, start) + ((length,) if length is not None else ())
                return ast.FunctionCall("substring", args)
        # identifier or function call (soft keywords allowed via ident())
        try:
            name = self.ident()
        except ParseError:
            raise ParseError(f"unexpected token {t!r}")
        if self.peek().kind == "op" and self.peek().text == "(":
            self.next()
            distinct = False
            is_star = False
            args: List[ast.Node] = []
            if self.accept_op("*"):
                is_star = True
            elif not (self.peek().kind == "op" and self.peek().text == ")"):
                distinct = self.accept_kw("distinct")
                self.accept_kw("all")
                args.append(self.expr())
                while self.accept_op(","):
                    args.append(self.expr())
            self.expect_op(")")
            window = None
            if self.accept_kw("over"):
                window = self.window_spec()
            return ast.FunctionCall(
                name.lower(), tuple(args), distinct, is_star, window
            )
        parts = [name]
        while (
            self.peek().kind == "op"
            and self.peek().text == "."
            and self.peek(1).kind in ("ident", "kw")
        ):
            self.next()
            parts.append(self.ident())
        return ast.Identifier(tuple(parts))

    def window_spec(self) -> ast.WindowSpec:
        """OVER ( [PARTITION BY e,..] [ORDER BY s,..] [frame] )
        (SqlBase.g4 windowSpecification)."""
        self.expect_op("(")
        partition: List[ast.Node] = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.expr())
            while self.accept_op(","):
                partition.append(self.expr())
        order: List[ast.SortItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order.append(self.sort_item())
            while self.accept_op(","):
                order.append(self.sort_item())
        frame = None
        if self.at_kw("rows", "range", "groups"):
            unit = self.next().text
            if self.accept_kw("between"):
                start = self.frame_bound()
                self.expect_kw("and")
                end = self.frame_bound()
            else:
                start = self.frame_bound()
                end = ast.FrameBound("current")
            frame = ast.WindowFrame(unit, start, end)
        self.expect_op(")")
        return ast.WindowSpec(tuple(partition), tuple(order), frame)

    def frame_bound(self) -> ast.FrameBound:
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                return ast.FrameBound("unbounded_preceding")
            self.expect_kw("following")
            return ast.FrameBound("unbounded_following")
        if self.accept_kw("current"):
            self.expect_kw("row")
            return ast.FrameBound("current")
        v = self.expr()
        if self.accept_kw("preceding"):
            return ast.FrameBound("preceding", v)
        self.expect_kw("following")
        return ast.FrameBound("following", v)

    def type_name(self) -> str:
        base = self.next().text.lower()
        if self.accept_op("("):
            inner = [self.next().text]
            while self.accept_op(","):
                inner.append(self.next().text)
            self.expect_op(")")
            return f"{base}({','.join(inner)})"
        return base


def parse(sql: str) -> ast.Node:
    """Parse one SQL statement (SqlParser.createStatement analog)."""
    return Parser(sql).parse_statement()
