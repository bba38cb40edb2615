"""Canonical plan digests and fragment fingerprints.

Counterpart of trino_tpu/cache/signature.py (pure Python over the port's
copies of the plan and expression IR).  Two related but distinct
encodings of a plan tree feed the two cache tiers:

- ``plan_signature`` (result-cache key): a *canonical* digest that is
  invariant under output aliasing and symbol renaming, with literals
  parameterized out into a separate ``params`` tuple (the canonical plan
  hashing of Presto's fragment result cache, Sethi et al. ICDE'19).
  Join order, operator shapes, session-semantic plan attributes
  (distribution, expansion, direct domains) and the *shape* of
  constraints stay in the digest, so two plans share a digest only when
  they compute the same function of the same tables modulo literals.

- ``fragment_fingerprint`` (compile-cache key): an *exact* content hash
  (symbols, literals and output names included) that is stable across
  processes (unlike ``id(plan)`` or salted ``hash()``), so structurally
  identical fragments from different sessions map to the same encoded
  megakernel program (cache/compile_cache.py).

The JAX package's ``shape_bucket`` (the padded-shape component of its
jit keys) has no counterpart: the card runs every row count with one
encoded program, so no key of the port holds a padded shape.

Determinism analysis is a separate pass (`analyze_determinism`)
consulting `expr.ir.NONDETERMINISTIC_FUNCTIONS` and
`Constant.nondeterministic_origin`, so now()/rand()-class plans are
never result-cached.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterator, List, Optional, Tuple

from ..expr import ir
from ..plan import nodes as P

_SEP = "\x1f"


@dataclasses.dataclass(frozen=True)
class PlanSignature:
    digest: str  # canonical sha256 hex (alias/symbol/literal invariant)
    params: Tuple[str, ...]  # parameterized-out literals, in emission order
    tables: Tuple[Tuple[str, str], ...]  # (catalog, table) scanned, deduped
    deterministic: bool
    reason: Optional[str] = None  # why not deterministic / not cacheable


class _Emitter:
    """Token-stream serializer over the plan tree.  ``exact=False`` gives
    the canonical (result-cache) encoding; ``exact=True`` the fingerprint
    encoding.  Symbols are canonicalized to $k by first appearance; strings
    in protected positions (catalog/table/column/function/operator names)
    are emitted raw so real schema differences never alias."""

    def __init__(self, exact: bool):
        self.exact = exact
        self.tokens: List[str] = []
        self.params: List[str] = []
        self.tables: List[Tuple[str, str]] = []
        self._symmap: dict = {}

    # -- primitives ------------------------------------------------------
    def tok(self, *parts) -> None:
        self.tokens.append("|".join(str(p) for p in parts))

    def sym(self, s) -> str:
        if s is None:
            return "~"
        if self.exact:
            return str(s)
        v = self._symmap.get(s)
        if v is None:
            v = f"${len(self._symmap)}"
            self._symmap[s] = v
        return v

    def lit(self, value) -> str:
        """A literal value: inline when exact, parameterized otherwise."""
        if self.exact:
            return repr(value)
        self.params.append(repr(value))
        return "?"

    def ty(self, t) -> str:
        return "~" if t is None else str(t)

    def keys(self, syms) -> str:
        return ",".join(self.sym(s) for s in syms)

    def sortkeys(self, keys) -> str:
        return ",".join(
            f"{self.sym(k.column)}:{int(k.ascending)}:{int(k.nulls_first)}"
            for k in keys
        )

    # -- expressions -----------------------------------------------------
    def expr(self, e: Optional[ir.Expr]) -> None:
        if e is None:
            self.tok("e~")
            return
        if isinstance(e, ir.Constant):
            self.tok("lit", self.ty(e.type), self.lit(e.value),
                     int(e.nondeterministic_origin))
        elif isinstance(e, ir.ColumnRef):
            self.tok("col", self.sym(e.name), self.ty(e.type))
        elif isinstance(e, ir.Call):
            self.tok("call", e.name, self.ty(e.type), len(e.args))
            for a in e.args:
                self.expr(a)
        elif isinstance(e, ir.Comparison):
            self.tok("cmp", e.op)
            self.expr(e.left)
            self.expr(e.right)
        elif isinstance(e, ir.Logical):
            self.tok("logical", e.op, len(e.terms))
            for t in e.terms:
                self.expr(t)
        elif isinstance(e, ir.Not):
            self.tok("not")
            self.expr(e.term)
        elif isinstance(e, ir.IsNull):
            self.tok("isnull", int(e.negate))
            self.expr(e.term)
        elif isinstance(e, ir.Between):
            self.tok("between", int(e.negate))
            self.expr(e.value)
            self.expr(e.low)
            self.expr(e.high)
        elif isinstance(e, ir.In):
            self.tok("in", int(e.negate), len(e.items))
            self.expr(e.value)
            for i in e.items:
                self.expr(i)
        elif isinstance(e, ir.Case):
            self.tok("case", self.ty(e.type), len(e.whens))
            for w in e.whens:
                self.expr(w.condition)
                self.expr(w.result)
            self.expr(e.default)
        elif isinstance(e, ir.Cast):
            self.tok("cast", self.ty(e.type))
            self.expr(e.term)
        elif isinstance(e, ir.Lambda):
            # lambda params are user-chosen like aliases but scoping them
            # is not worth the complexity: emit raw (conservative — a
            # renamed lambda param changes the digest, never aliases).
            self.tok("lambda", self.ty(e.type), ",".join(e.params))
            self.expr(e.body)
        else:  # future Expr kinds: fall back to repr (exact, conservative)
            self.tok("expr", repr(e))

    # -- plan nodes ------------------------------------------------------
    def node(self, n: P.PlanNode) -> None:
        if isinstance(n, P.TableScan):
            tab = (n.catalog, n.table)
            if tab not in self.tables:
                self.tables.append(tab)
            self.tok(
                "scan", n.catalog, n.table,
                ",".join(f"{self.sym(s)}={c}" for s, c in n.assignments),
                ",".join(f"{self.sym(s)}:{self.ty(t)}" for s, t in n.types),
                # constraint values derive from the query's filter
                # literals: parameterize the whole tuple so literal-only
                # changes keep the digest
                self.lit(n.constraint) if n.constraint else "",
            )
        elif isinstance(n, P.Values):
            self.tok(
                "values", self.keys(n.symbols),
                ",".join(f"{self.sym(s)}:{self.ty(t)}" for s, t in n.types_),
                len(n.rows), self.lit((n.rows, n.dicts)),
            )
        elif isinstance(n, P.Filter):
            self.tok("filter", n.compact_rows)
            self.expr(n.predicate)
        elif isinstance(n, P.Project):
            self.tok("project", len(n.assignments))
            for s, e in n.assignments:
                self.tok("as", self.sym(s))
                self.expr(e)
        elif isinstance(n, P.GroupId):
            self.tok(
                "groupid", self.sym(n.gid_symbol),
                ";".join(self.keys(s) for s in n.sets),
            )
        elif isinstance(n, P.Aggregate):
            self.tok("agg", n.step, self.keys(n.keys), len(n.aggs))
            for a in n.aggs:
                self.tok(
                    "agginfo", self.sym(a.output), a.kind, self.sym(a.arg),
                    int(a.distinct), self.ty(a.input_type),
                    self.ty(a.output_type), self.sym(a.arg2),
                    self.ty(a.input2_type), repr(a.param),
                )
        elif isinstance(n, P.Join):
            self.tok(
                "join", n.kind,
                ",".join(f"{self.sym(a)}={self.sym(b)}"
                         for a, b in n.criteria),
                int(n.expansion), n.distribution, n.compact_rows,
                n.direct_domain,
            )
            self.expr(n.filter)
        elif isinstance(n, P.SemiJoin):
            self.tok(
                "semijoin", self.keys(n.source_keys),
                self.keys(n.filtering_keys), self.sym(n.output),
            )
            self.expr(n.filter)
        elif isinstance(n, P.ScalarJoin):
            self.tok("scalarjoin")
        elif isinstance(n, P.Window):
            self.tok(
                "window", self.keys(n.partition_by),
                self.sortkeys(n.order_by), len(n.functions),
            )
            for f in n.functions:
                fr = f.frame
                self.tok(
                    "winfn", self.sym(f.output), f.kind, self.keys(f.args),
                    repr(f.constants), fr.unit, fr.start_kind,
                    fr.start_offset, fr.end_kind, fr.end_offset,
                    self.ty(f.input_type), self.ty(f.output_type),
                )
        elif isinstance(n, P.Sort):
            self.tok("sort", self.sortkeys(n.keys))
        elif isinstance(n, P.TopN):
            self.tok("topn", n.count, self.sortkeys(n.keys))
        elif isinstance(n, P.Limit):
            self.tok("limit", n.count, n.offset)
        elif isinstance(n, P.Distinct):
            self.tok("distinct")
        elif isinstance(n, P.Sample):
            self.tok("sample", repr(n.fraction))
        elif isinstance(n, P.SetOperation):
            self.tok(
                "setop", n.kind, int(n.all), self.keys(n.symbols),
                ",".join(f"{self.sym(s)}:{self.ty(t)}" for s, t in n.types_),
            )
        elif isinstance(n, P.Unnest):
            self.tok(
                "unnest", self.sym(n.array_symbol),
                self.sym(n.element_symbol), self.ty(n.element_type),
                self.sym(n.ordinality_symbol), int(n.outer),
            )
        elif isinstance(n, P.MatchRecognize):
            self.tok(
                "match", self.keys(n.partition_by),
                self.sortkeys(n.order_by), repr(n.pattern), n.after_match,
                n.rows_per_match,
            )
            for name, e in n.defines:
                self.tok("define", name)
                self.expr(e)
            for s, e, t in n.measures:
                self.tok("measure", self.sym(s), self.ty(t))
                self.expr(e)
        elif isinstance(n, P.TableWriter):
            self.tok(
                "writer", n.catalog, n.table, ",".join(n.columns),
                int(n.overwrite), int(n.report_deleted),
                repr(n.create_schema), int(n.if_not_exists),
                self.sym(n.count_symbol), n.count_mode,
            )
        elif isinstance(n, P.Output):
            # client-facing names are excluded from the canonical digest
            # (alias invariance); the exact fingerprint keeps them
            if self.exact:
                self.tok("output", ",".join(n.names), self.keys(n.symbols))
            else:
                self.tok("output", self.keys(n.symbols))
        elif isinstance(n, P.Exchange):
            self.tok("exchange", n.partitioning, self.keys(n.keys))
        elif isinstance(n, P.RemoteSource):
            self.tok(
                "remote", n.fragment_id, self.keys(n.symbols),
                ",".join(f"{self.sym(s)}:{self.ty(t)}" for s, t in n.types_),
            )
        else:  # unknown node kind: exact repr keeps correctness (no
            # cross-plan aliasing), at the cost of canonicality
            self.tok("node", repr(n))
        for s in n.sources:
            self.node(s)


def iter_exprs(plan: P.PlanNode) -> Iterator[ir.Expr]:
    """Every ir.Expr reachable from any node field (predicates, projections,
    join filters, window/match definitions, ...)."""

    def from_val(v):
        if isinstance(v, P.PlanNode):
            return
        if isinstance(v, ir.Expr):
            yield v
        elif isinstance(v, tuple):
            for x in v:
                yield from from_val(x)
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                yield from from_val(getattr(v, f.name))

    stack = [plan]
    while stack:
        n = stack.pop()
        stack.extend(n.sources)
        for f in dataclasses.fields(n):
            yield from from_val(getattr(n, f.name))


def analyze_determinism(plan: P.PlanNode) -> Tuple[bool, Optional[str]]:
    """(deterministic, reason).  A plan is cacheable-deterministic when no
    expression calls a NONDETERMINISTIC_FUNCTIONS member and no constant was
    folded from one (now() & friends evaluate once per query)."""
    for e in iter_exprs(plan):
        for node in ir.walk(e):
            if (isinstance(node, ir.Call)
                    and node.name in ir.NONDETERMINISTIC_FUNCTIONS):
                return False, f"nondeterministic function {node.name}()"
            if isinstance(node, ir.Constant) and node.nondeterministic_origin:
                return False, "constant folded from a nondeterministic function"
    return True, None


def plan_signature(plan: P.PlanNode) -> PlanSignature:
    em = _Emitter(exact=False)
    em.node(plan)
    deterministic, reason = analyze_determinism(plan)
    digest = hashlib.sha256(_SEP.join(em.tokens).encode()).hexdigest()
    return PlanSignature(
        digest=digest,
        params=tuple(em.params),
        tables=tuple(em.tables),
        deterministic=deterministic,
        reason=reason,
    )


# id(plan) -> (plan, fingerprint): entries pin the plan object so the id
# stays valid while memoized; bounded by wholesale clear (plans are also
# pinned by the compile-cache entries that use them).
_FP_MEMO: dict = {}


def fragment_fingerprint(plan: P.PlanNode) -> str:
    """Exact, process-stable content hash of a plan/fragment tree — the
    compile-cache key component replacing id(plan)."""
    hit = _FP_MEMO.get(id(plan))
    if hit is not None and hit[0] is plan:
        return hit[1]
    em = _Emitter(exact=True)
    em.node(plan)
    fp = hashlib.sha256(_SEP.join(em.tokens).encode()).hexdigest()
    if len(_FP_MEMO) > 4096:
        _FP_MEMO.clear()
    _FP_MEMO[id(plan)] = (plan, fp)
    return fp
