"""Row pattern matching for MATCH_RECOGNIZE.

Counterpart of trino_tpu/ops/matcher.py (pure Python, unchanged): the
executor sorts on the device and hands this matcher one partition's
ordered columns at a time.  Reference parity: core/trino-main/.../operator/window/matcher/ (the NFA
Matcher over an IrRowPattern) + pattern semantics from
sql/analyzer/PatternRecognitionAnalysis.  Here a backtracking matcher runs
host-side per partition (the reference is also a row-at-a-time automaton);
DEFINE/MEASURES expressions are evaluated by the shared IR interpreter
(expr/arrays.eval_ir) with a navigation resolver for PREV/NEXT/FIRST/LAST/
CLASSIFIER/MATCH_NUMBER.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..expr import ir
from ..expr.arrays import eval_ir

NAV_FUNCS = (
    "__mr_prev__", "__mr_next__", "__mr_first__", "__mr_last__",
    "__mr_classifier__", "__mr_match_number__",
)


class MatchContext:
    """One partition's rows + the in-flight match state."""

    def __init__(self, columns: Dict[str, list], nrows: int):
        self.columns = columns
        self.nrows = nrows
        self.match_number = 0
        # current (possibly tentative) mapping: list of (row, var)
        self.bindings: List[Tuple[int, str]] = []
        self.current_row = 0

    # -- navigation ---------------------------------------------------
    def value(self, col: str, row: int):
        if 0 <= row < self.nrows:
            return self.columns[col][row]
        return None

    def rows_of(self, var: str) -> List[int]:
        if var == "":
            return [r for r, _ in self.bindings]
        return [r for r, v in self.bindings if v == var]

    def special(self, e: ir.Expr, env):
        """eval_ir `special` hook: claims navigation calls."""
        if not isinstance(e, ir.Call) or e.name not in NAV_FUNCS:
            return False, None
        if e.name == "__mr_classifier__":
            for r, v in reversed(self.bindings):
                if r == self.current_row:
                    return True, v.upper()
            return True, None
        if e.name == "__mr_match_number__":
            return True, self.match_number
        colref = e.args[0]
        assert isinstance(colref, ir.ColumnRef)
        if e.name in ("__mr_prev__", "__mr_next__"):
            n = int(e.args[1].value)
            off = -n if e.name == "__mr_prev__" else n
            return True, self.value(colref.name, self.current_row + off)
        var = str(e.args[1].value)
        rows = self.rows_of(var)
        if not rows:
            return True, None
        row = rows[0] if e.name == "__mr_first__" else rows[-1]
        return True, self.value(colref.name, row)

    def eval(self, expr: ir.Expr, row: int):
        self.current_row = row
        env = {c: vals[row] for c, vals in self.columns.items()}
        return eval_ir(expr, env, self.special)


def _match_term(term, pos: int, ctx: MatchContext, defines, out_len):
    """Backtracking generator of end positions; ctx.bindings holds the
    mapping for the branch currently being explored."""
    if term.kind == "var":
        reps = _quantifier_range(term.quantifier)
        yield from _match_var(term.var, reps, term.greedy, pos, ctx, defines)
        return
    if term.kind == "alt":
        for branch in term.items:
            yield from _match_term(branch, pos, ctx, defines, out_len)
        return
    # group: sequence with optional quantifier over the whole group
    reps = _quantifier_range(term.quantifier)
    yield from _match_group(term.items, reps, term.greedy, pos, ctx, defines)


def _quantifier_range(q: str) -> Tuple[int, Optional[int]]:
    return {"": (1, 1), "?": (0, 1), "*": (0, None), "+": (1, None)}[q]


def _match_var(var, reps, greedy, pos, ctx, defines):
    lo, hi = reps

    def extend(count, p):
        if count >= lo:
            if greedy:
                if hi is None or count < hi:
                    yield from try_one(count, p)
                yield p
            else:
                yield p
                if hi is None or count < hi:
                    yield from try_one(count, p)
        else:
            yield from try_one(count, p)

    def try_one(count, p):
        if p >= ctx.nrows:
            return
        cond = defines.get(var)
        ctx.bindings.append((p, var))
        ok = True
        if cond is not None:
            ok = ctx.eval(cond, p) is True
        if ok:
            yield from extend(count + 1, p + 1)
        ctx.bindings.pop()

    yield from extend(0, pos)


def _match_group(items, reps, greedy, pos, ctx, defines):
    lo, hi = reps

    def seq(idx, p):
        if idx == len(items):
            yield p
            return
        for end in _match_term(items[idx], p, ctx, defines, None):
            yield from seq(idx + 1, end)

    def extend(count, p):
        if count >= lo:
            if greedy:
                if hi is None or count < hi:
                    yield from try_one(count, p)
                yield p
            else:
                yield p
                if hi is None or count < hi:
                    yield from try_one(count, p)
        else:
            yield from try_one(count, p)

    def try_one(count, p):
        mark = len(ctx.bindings)
        for end in seq(0, p):
            if end == p and count >= lo:
                continue  # empty group iteration: no progress
            yield from extend(count + 1, end)
        del ctx.bindings[mark:]

    yield from extend(0, pos)


def find_matches(
    columns: Dict[str, list],
    nrows: int,
    pattern,
    defines: Dict[str, ir.Expr],
    measures: Sequence[Tuple[str, ir.Expr]],
    after_match: str = "past_last_row",
    all_rows: bool = False,
) -> List[dict]:
    """Run the automaton over one partition.

    ONE ROW PER MATCH (all_rows=False): one dict per match, measures
    evaluated FINAL on the last mapped row.  ALL ROWS PER MATCH: one dict
    per MAPPED ROW with measures evaluated at that row (RUNNING semantics)
    plus '__row__' = the partition-relative source row index."""
    ctx = MatchContext(columns, nrows)
    out: List[dict] = []
    start = 0
    while start < nrows:
        ctx.bindings = []
        matched_end = None
        for end in _match_term(pattern, start, ctx, defines, None):
            if end > start:  # ignore empty matches
                matched_end = end
                break
        if matched_end is None:
            start += 1
            continue
        ctx.match_number += 1
        if all_rows:
            match_rows = [r for r, _ in ctx.bindings]
            for r in match_rows:
                row = {"__row__": r}
                # RUNNING semantics: navigation sees the mapping up to r
                full = list(ctx.bindings)
                ctx.bindings = [b for b in full if b[0] <= r]
                for name, expr in measures:
                    row[name] = ctx.eval(expr, r)
                ctx.bindings = full
                out.append(row)
        else:
            last_row = ctx.bindings[-1][0] if ctx.bindings else start
            row = {}
            for name, expr in measures:
                row[name] = ctx.eval(expr, last_row)
            out.append(row)
        if after_match == "to_next_row":
            start = start + 1
        else:
            start = max(matched_end, start + 1)
    return out
