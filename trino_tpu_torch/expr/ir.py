"""Typed logical expression IR.

Reference parity: core/trino-main/src/main/java/io/trino/sql/ir/ (29 nodes:
Call, Comparison, Constant, Logical, Case, Cast, In, Between, IsNull, ...)
and the relational RowExpression IR (sql/relational/) that feeds bytecode
codegen (sql/gen/ExpressionCompiler.java:56).

Here the IR is the input to jax tracing (expr/lower.py) instead of bytecode
generation: an Expr tree lowers to a pure function over (values, validity)
array pairs, which XLA then fuses into the surrounding operator kernel.

Every node carries its result Type; the analyzer (sql/analyzer.py) produces
fully-typed trees, and lowering is type-directed (decimal rescaling, dict
code comparison, 3-valued logic).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from .. import types as T

# Functions whose value is not a pure function of their arguments (the
# reference's FunctionMetadata.isDeterministic bit).  One registry consulted
# by constant folding (sql/analyzer._fold), the plan-signature determinism
# analysis (cache/signature.py), and the optimizer: `now`-class functions
# fold to per-query Constants carrying nondeterministic_origin; `rand`-class
# functions stay as Calls and are never folded or result-cached.  `uuid` is
# registered for tagging even though this engine has no runtime kernel yet.
NONDETERMINISTIC_FUNCTIONS = frozenset({
    "now", "current_timestamp", "current_date", "localtimestamp",
    "rand", "random", "uuid",
})


class Expr:
    type: T.Type

    def children(self) -> Sequence["Expr"]:
        return ()


@dataclasses.dataclass(frozen=True)
class Constant(Expr):
    """Literal. value is a python scalar; for varchar it is the python str,
    for decimal it is the *unscaled* int, for date the epoch-day int.

    nondeterministic_origin marks constants produced by folding a
    nondeterministic function at analysis time (now()/current_timestamp
    evaluate once per query): the value is a legitimate constant for THIS
    query but must never be shared across queries, so plan/result caches
    refuse plans containing one."""

    type: T.Type
    value: Any  # None = NULL literal
    nondeterministic_origin: bool = False

    def __repr__(self):
        return f"Const({self.value}:{self.type})"


@dataclasses.dataclass(frozen=True)
class ColumnRef(Expr):
    """Reference to an input column by name (symbol)."""

    type: T.Type
    name: str

    def __repr__(self):
        return f"Col({self.name}:{self.type})"


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """Scalar function call (arithmetic, string fns, date fns, ...)."""

    type: T.Type
    name: str
    args: Tuple[Expr, ...]

    def children(self):
        return self.args

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class Comparison(Expr):
    """=, <>, <, <=, >, >=, IS DISTINCT FROM."""

    op: str
    left: Expr
    right: Expr
    type: T.Type = T.BOOLEAN

    def children(self):
        return (self.left, self.right)

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass(frozen=True)
class Logical(Expr):
    """AND / OR over 2+ terms with Kleene 3-valued semantics."""

    op: str  # 'and' | 'or'
    terms: Tuple[Expr, ...]
    type: T.Type = T.BOOLEAN

    def children(self):
        return self.terms


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    term: Expr
    type: T.Type = T.BOOLEAN

    def children(self):
        return (self.term,)


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    term: Expr
    negate: bool = False
    type: T.Type = T.BOOLEAN

    def children(self):
        return (self.term,)


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    value: Expr
    low: Expr
    high: Expr
    negate: bool = False
    type: T.Type = T.BOOLEAN

    def children(self):
        return (self.value, self.low, self.high)


@dataclasses.dataclass(frozen=True)
class In(Expr):
    value: Expr
    items: Tuple[Expr, ...]  # constants only for now (value list)
    negate: bool = False
    type: T.Type = T.BOOLEAN

    def children(self):
        return (self.value,) + self.items


@dataclasses.dataclass(frozen=True)
class WhenClause:
    condition: Expr
    result: Expr


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    """Searched CASE: WHEN cond THEN res ... ELSE default."""

    type: T.Type
    whens: Tuple[WhenClause, ...]
    default: Optional[Expr]

    def children(self):
        out = []
        for w in self.whens:
            out += [w.condition, w.result]
        if self.default is not None:
            out.append(self.default)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    type: T.Type
    term: Expr

    def children(self):
        return (self.term,)


@dataclasses.dataclass(frozen=True)
class Lambda(Expr):
    """Lambda argument of a higher-order function (sql/ir/Lambda).
    `type` is the body's result type; params resolve as ColumnRefs inside
    the body and are bound per element by the array-function evaluator."""

    type: T.Type
    params: Tuple[str, ...]
    body: Expr

    def children(self):
        return (self.body,)


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def is_deterministic(e: Expr) -> bool:
    """True when the expression is a pure function of its column inputs —
    no `rand()`-class Calls and no constants folded from `now()`-class
    functions.  The single flag the result cache, the plan cache, and
    constant folding all consult."""
    for n in walk(e):
        if isinstance(n, Call) and n.name in NONDETERMINISTIC_FUNCTIONS:
            return False
        if isinstance(n, Constant) and n.nondeterministic_origin:
            return False
    return True


def referenced_columns(e: Expr) -> list:
    seen = []
    for n in walk(e):
        if isinstance(n, ColumnRef) and n.name not in seen:
            seen.append(n.name)
    return seen


def replace_refs(e: Expr, mapping: dict) -> Expr:
    """Rewrite ColumnRefs by name (symbol substitution in plan rewrites)."""
    if isinstance(e, ColumnRef):
        return mapping.get(e.name, e)
    if isinstance(e, Call):
        return Call(e.type, e.name, tuple(replace_refs(a, mapping) for a in e.args))
    if isinstance(e, Comparison):
        return Comparison(
            e.op, replace_refs(e.left, mapping), replace_refs(e.right, mapping)
        )
    if isinstance(e, Logical):
        return Logical(e.op, tuple(replace_refs(t, mapping) for t in e.terms))
    if isinstance(e, Not):
        return Not(replace_refs(e.term, mapping))
    if isinstance(e, IsNull):
        return IsNull(replace_refs(e.term, mapping), e.negate)
    if isinstance(e, Between):
        return Between(
            replace_refs(e.value, mapping),
            replace_refs(e.low, mapping),
            replace_refs(e.high, mapping),
            e.negate,
        )
    if isinstance(e, In):
        return In(
            replace_refs(e.value, mapping),
            tuple(replace_refs(i, mapping) for i in e.items),
            e.negate,
        )
    if isinstance(e, Case):
        return Case(
            e.type,
            tuple(
                WhenClause(
                    replace_refs(w.condition, mapping), replace_refs(w.result, mapping)
                )
                for w in e.whens
            ),
            None if e.default is None else replace_refs(e.default, mapping),
        )
    if isinstance(e, Cast):
        return Cast(e.type, replace_refs(e.term, mapping))
    return e
