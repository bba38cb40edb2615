"""Expression IR -> PyTorch lowering.

Counterpart of trino_tpu/expr/lower.py.  A fully-typed Expr tree lowers
to a python function
    f(cols: dict[name -> Lane]) -> Lane
where Lane = (values: torch.Tensor, valid: torch.Tensor bool), evaluated
eagerly on the lanes' device.

Null semantics (three-valued logic) follow the reference's codegen
wasNull protocol: every lane carries a validity mask; AND/OR use Kleene
logic.  Dictionary-encoded varchar comparisons against constants are
resolved host-side: the constant is looked up in the column's
dictionary and the comparison becomes an int32 code comparison.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .. import types as T
from ..device import torch_dtype
from . import ir
from .functions import FUNCTIONS, align_numeric, decimal_rescale, dict_gather, round_half_away

Lane = Tuple[torch.Tensor, torch.Tensor]  # (values, valid)


def _const_lane(e: ir.Constant, n_ref: Lane) -> Lane:
    """Broadcast a constant against the shape of any reference lane."""
    shape = (n_ref[0].shape[0],)
    dev = n_ref[0].device
    if getattr(e.type, "wide", False):
        from ..ops.wide_decimal import from_python_int

        if e.value is None:
            return (
                torch.zeros(shape + (2,), dtype=torch.int64, device=dev),
                torch.zeros(shape, dtype=torch.bool, device=dev),
            )
        lo, hi = from_python_int(int(e.value))
        val = torch.stack(
            [torch.full(shape, lo, dtype=torch.int64, device=dev),
             torch.full(shape, hi, dtype=torch.int64, device=dev)],
            dim=-1,
        )
        return val, torch.ones(shape, dtype=torch.bool, device=dev)
    dt = torch_dtype(e.type.np_dtype)
    if e.value is None:
        return (
            torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=torch.bool, device=dev),
        )
    val = torch.full(shape, e.value, dtype=dt, device=dev)
    return val, torch.ones(shape, dtype=torch.bool, device=dev)


def _all_valid(v: torch.Tensor) -> torch.Tensor:
    return torch.ones(v.shape, dtype=torch.bool, device=v.device)


class ProjectionMemo:
    """Bounded LRU map of host dictionary projections (functions.memoized),
    kept by a session across its queries."""

    def __init__(self, max_entries: int = 64):
        from collections import OrderedDict

        self.max_entries = max_entries
        self.entries: "OrderedDict" = OrderedDict()

    def get(self, key):
        hit = self.entries.get(key)
        if hit is not None:
            self.entries.move_to_end(key)
        return hit

    def put(self, key, value) -> None:
        self.entries[key] = value
        self.entries.move_to_end(key)
        while len(self.entries) > self.max_entries:
            self.entries.popitem(last=False)


class LoweringContext:
    """Per-compilation context: column dictionaries for dict-code rewrites.

    dictionaries: column name -> np.ndarray of strings (host side).  Used to
    turn varchar-vs-constant predicates into int32 code predicates at trace
    time.
    """

    def __init__(self, dictionaries: Dict[str, np.ndarray] | None = None):
        # the executor's own map (not a copy, even while empty): an
        # operator registers its output's dictionary there after this
        # context is made (an array_agg below a projection of it)
        self.dictionaries = {} if dictionaries is None else dictionaries
        # dictionaries of *derived* string expressions (substring(col,..)
        # etc.), keyed by the (hashable, frozen) IR node that produced them
        self.expr_dicts: Dict[object, np.ndarray] = {}
        # decimal multiplies whose declared precision exceeds 18 digits run
        # the cheap int64 kernel first and flag potential overflow here
        # (traced scalars); the executor retries with the 128-bit kernel
        # only when a flag fires (DecimalOperators would use Int128 always;
        # real data almost never needs it and the wide kernel is costly)
        self.overflow_flags: list = []
        # set by the executor's retry ladder after a flagged overflow
        self.force_wide_mul: bool = False
        # the session's ProjectionMemo (None: every projection computed)
        self.memo = None

    def dict_for_expr(self, e) -> np.ndarray | None:
        """Dictionary of a varchar-typed expression: source column's, or a
        derived one registered by a string function."""
        from . import ir as _ir

        if isinstance(e, _ir.ColumnRef):
            return self.dictionaries.get(e.name)
        return self.expr_dicts.get(e)

    # -- host-side dictionary predicate evaluation ---------------------
    def _dict_of(self, col_or_expr):
        if isinstance(col_or_expr, str):
            d = self.dictionaries.get(col_or_expr)
        else:
            d = self.dict_for_expr(col_or_expr)
        if d is None:
            raise KeyError(f"no dictionary for {col_or_expr}")
        return d

    def dict_code_for(self, col, s: str) -> int:
        d = self._dict_of(col)
        idx = np.nonzero(d == s)[0]
        return int(idx[0]) if len(idx) else -2  # -2: never matches any code

    def dict_mask(self, col, pred: Callable[[str], bool]) -> np.ndarray:
        """Boolean lookup table over dictionary entries (for LIKE etc.)."""
        d = self._dict_of(col)
        return np.array([bool(pred(str(x))) for x in d], dtype=bool)


def compile_expr(
    e: ir.Expr, ctx: LoweringContext | None = None
) -> Callable[[Dict[str, Lane]], Lane]:
    """Compile an Expr into a lane function. Pure; jit-traceable."""
    ctx = ctx or LoweringContext()

    def ev(node: ir.Expr, cols: Dict[str, Lane]) -> Lane:
        if isinstance(node, ir.ColumnRef):
            return cols[node.name]
        if isinstance(node, ir.Constant):
            ref = next(iter(cols.values()))
            if node.type.is_dictionary:
                shape = ref[0].shape[:1]
                dev = ref[0].device
                if node.value is None:
                    ctx.expr_dicts[node] = np.array([], dtype=object)
                    return (
                        torch.full(shape, -1, dtype=torch.int32, device=dev),
                        torch.zeros(shape, dtype=torch.bool, device=dev),
                    )
                # safe 1-element object array (np.array([tuple]) would
                # build a 2-D array for array-typed constants)
                entry = np.empty(1, dtype=object)
                entry[0] = node.value
                ctx.expr_dicts[node] = entry
                return (
                    torch.zeros(shape, dtype=torch.int32, device=dev),
                    torch.ones(shape, dtype=torch.bool, device=dev),
                )
            return _const_lane(node, ref)
        if isinstance(node, ir.Call):
            return _lower_call(node, cols, ev, ctx)
        if isinstance(node, ir.Comparison):
            return _lower_comparison(node, cols, ev, ctx)
        if isinstance(node, ir.Logical):
            return _lower_logical(node, cols, ev)
        if isinstance(node, ir.Not):
            v, ok = ev(node.term, cols)
            return torch.logical_not(v), ok
        if isinstance(node, ir.IsNull):
            _, ok = ev(node.term, cols)
            res = ok if node.negate else torch.logical_not(ok)
            return res, _all_valid(res)
        if isinstance(node, ir.Between):
            v, vok = ev(node.value, cols)
            lo, lok = ev(node.low, cols)
            hi, hok = ev(node.high, cols)
            # align each bound against the ORIGINAL value lane independently
            v_lo, lo2 = align_numeric(node.value.type, v, node.low.type, lo)
            v_hi, hi2 = align_numeric(node.value.type, v, node.high.type, hi)
            res = torch.logical_and(
                _cmp("<=", lo2, v_lo), _cmp("<=", v_hi, hi2)
            )
            if node.negate:
                res = torch.logical_not(res)
            return res, vok & lok & hok
        if isinstance(node, ir.In):
            return _lower_in(node, cols, ev, ctx)
        if isinstance(node, ir.Case):
            return _lower_case(node, cols, ev, ctx)
        if isinstance(node, ir.Cast):
            return _lower_cast(node, cols, ev, ctx)
        raise NotImplementedError(type(node).__name__)

    return lambda cols: ev(e, cols)


# ----------------------------------------------------------------------
# helpers


def _lower_comparison(node: ir.Comparison, cols, ev, ctx: LoweringContext) -> Lane:
    lt, rt = node.left.type, node.right.type
    # dictionary-aware string comparison against constant
    if lt.is_dictionary and isinstance(node.right, ir.Constant):
        return _dict_const_cmp(node.left, node.op, node.right.value, cols, ev, ctx)
    if rt.is_dictionary and isinstance(node.left, ir.Constant):
        flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}
        op = flip.get(node.op, node.op)
        return _dict_const_cmp(node.right, op, node.left.value, cols, ev, ctx)
    if lt.is_dictionary and rt.is_dictionary:
        # codes are only comparable when both columns share one dictionary
        # (same scan); ordered comparison additionally needs a sorted dict.
        ln = node.left.name if isinstance(node.left, ir.ColumnRef) else None
        rn = node.right.name if isinstance(node.right, ir.ColumnRef) else None
        da, db = ctx.dictionaries.get(ln), ctx.dictionaries.get(rn)
        shared = da is not None and db is not None and np.array_equal(da, db)
        if not (shared and node.op in ("=", "<>", "!=", "is_distinct")):
            raise NotImplementedError(
                "varchar column-vs-column comparison requires a shared "
                f"dictionary and equality op (got {node.op})"
            )
    lv, lok = ev(node.left, cols)
    rv, rok = ev(node.right, cols)
    lv, rv = align_numeric(lt, lv, rt, rv)
    res = _cmp(node.op, lv, rv)
    if node.op == "is_distinct":
        both_null = torch.logical_not(lok) & torch.logical_not(rok)
        neq = torch.where(
            lok & rok, _cmp("is_distinct", lv, rv),
            torch.logical_not(both_null),
        )
        return neq, _all_valid(neq)
    return res, lok & rok


def _cmp(op: str, lv, rv):
    if lv.dim() == 2 or rv.dim() == 2:
        from ..ops import wide_decimal as wd

        wide_op = {"=": "==", "<>": "!=", "is_distinct": "!="}.get(op, op)
        return wd.compare(wd.promote(lv), wd.promote(rv), wide_op)
    if op == "=":
        return lv == rv
    if op in ("<>", "!="):
        return lv != rv
    if op == "<":
        return lv < rv
    if op == "<=":
        return lv <= rv
    if op == ">":
        return lv > rv
    if op == ">=":
        return lv >= rv
    if op == "is_distinct":
        return lv != rv
    raise NotImplementedError(op)


def _dict_const_cmp(col_expr, op, const_val, cols, ev, ctx: LoweringContext) -> Lane:
    """Lower dict-expr <op> string-constant via host dictionary lookup."""
    cv, cok = ev(col_expr, cols)
    if ctx.dict_for_expr(col_expr) is None:
        raise NotImplementedError("dict comparison requires a dictionary")
    if op in ("=", "<>", "!="):
        code = ctx.dict_code_for(col_expr, const_val)
        res = cv == code if op == "=" else cv != code
        return res, cok
    if op == "is_distinct":
        code = ctx.dict_code_for(col_expr, const_val)
        # null IS DISTINCT FROM 'x' -> true; result is never null
        res = torch.where(cok, cv != code, torch.ones_like(cok))
        return res, _all_valid(res)
    # ordered comparison on strings: precompute per-code truth table
    import operator as _op

    fns = {"<": _op.lt, "<=": _op.le, ">": _op.gt, ">=": _op.ge}
    table = ctx.dict_mask(col_expr, lambda s: fns[op](s, const_val))
    res = dict_gather(table, cv)
    return res, cok


def _lower_logical(node: ir.Logical, cols, ev) -> Lane:
    """Kleene AND/OR over n terms."""
    lanes = [ev(t, cols) for t in node.terms]
    v, ok = lanes[0]
    for v2, ok2 in lanes[1:]:
        if node.op == "and":
            # null AND false = false; null AND true = null
            res = (v | ~ok) & (v2 | ~ok2)
            resok = (ok & ok2) | (ok & torch.logical_not(v)) | (
                ok2 & torch.logical_not(v2)
            )
        else:
            res = (v & ok) | (v2 & ok2)
            resok = (ok & ok2) | (ok & v) | (ok2 & v2)
        v, ok = res, resok
    return v, ok


def _lower_in(node: ir.In, cols, ev, ctx: LoweringContext) -> Lane:
    vt = node.value.type
    if vt.is_dictionary:
        # evaluate first: derived-string functions register their
        # dictionaries during evaluation
        cv, cok = ev(node.value, cols)
        if ctx.dict_for_expr(node.value) is None:
            raise NotImplementedError("IN on varchar requires a dictionary")
        vals = {it.value for it in node.items if isinstance(it, ir.Constant)}
        table = ctx.dict_mask(node.value, lambda s: s in vals)
        res = dict_gather(table, cv)
        if node.negate:
            res = torch.logical_not(res)
        return res, cok
    v, vok = ev(node.value, cols)
    n = v.shape[0]
    res = torch.zeros(n, dtype=torch.bool, device=v.device)
    anynull = torch.zeros(n, dtype=torch.bool, device=v.device)
    for it in node.items:
        iv, iok = ev(it, cols)
        a, b = align_numeric(node.value.type, v, it.type, iv)
        res = res | (_cmp("=", a, b) & iok)
        anynull = anynull | torch.logical_not(iok)
    # x IN (...) is null if no match and some item was null
    ok = vok & (res | torch.logical_not(anynull))
    if node.negate:
        res = torch.logical_not(res)
    return res, ok


def _lower_case(node: ir.Case, cols, ev, ctx: LoweringContext) -> Lane:
    if node.type.is_dictionary:
        return _lower_case_dict(node, cols, ev, ctx)
    wide_out = getattr(node.type, "wide", False)

    def branch_value(e: ir.Expr, bv):
        """Coerce one branch lane to the CASE output representation."""
        if wide_out or bv.dim() == 2:
            from ..ops import wide_decimal as wd

            fs = e.type.scale if e.type.is_decimal else 0
            w = wd.decimal_rescale_wide(
                wd.promote(bv.to(torch.int64) if bv.dim() == 1 else bv),
                fs, node.type.scale,
            )
            return w if wide_out else wd.narrow(w)
        bv = bv.to(torch_dtype(node.type.np_dtype))
        if e.type.is_decimal and node.type.is_decimal:
            bv = decimal_rescale(bv, e.type.scale, node.type.scale)
        return bv

    # evaluate all branches, select backwards (XLA fuses the selects)
    if node.default is not None:
        v, ok = ev(node.default, cols)
        v = branch_value(node.default, v)
    else:
        ref = next(iter(cols.values()))
        n = ref[0].shape[0]
        dev = ref[0].device
        shape = (n, 2) if wide_out else (n,)
        dt = torch.int64 if wide_out else torch_dtype(node.type.np_dtype)
        v = torch.zeros(shape, dtype=dt, device=dev)
        ok = torch.zeros(n, dtype=torch.bool, device=dev)
    for w in reversed(node.whens):
        cv, cok = ev(w.condition, cols)
        rv, rok = ev(w.result, cols)
        rv = branch_value(w.result, rv)
        take = cok & cv
        v = torch.where(take[..., None] if v.dim() == 2 else take, rv, v)
        ok = torch.where(take, rok, ok)
    return v, ok


def _lower_case_dict(node: ir.Case, cols, ev, ctx: LoweringContext) -> Lane:
    """CASE producing varchar: union the branch dictionaries, remap each
    branch's codes into the union space, then select — the multi-branch
    generalisation of the DictionaryAwarePageProjection trick."""
    union_index: Dict[str, int] = {}
    union_vals: list = []

    def remap_codes(e: ir.Expr, lane: Lane):
        d = ctx.dict_for_expr(e)
        if d is None:
            raise NotImplementedError(
                "varchar CASE requires dictionary-encoded branches"
            )
        remap = np.empty(len(d), dtype=np.int32)
        for i, s in enumerate(d):
            s = str(s)
            if s not in union_index:
                union_index[s] = len(union_vals)
                union_vals.append(s)
            remap[i] = union_index[s]
        v, ok = lane
        codes = dict_gather(remap, v, -1).to(torch.int32)
        return codes, ok & (codes >= 0)

    if node.default is not None:
        v, ok = remap_codes(node.default, ev(node.default, cols))
    else:
        ref = next(iter(cols.values()))
        n = ref[0].shape[0]
        v = torch.full((n,), -1, dtype=torch.int32, device=ref[0].device)
        ok = torch.zeros(n, dtype=torch.bool, device=ref[0].device)
    for w in reversed(node.whens):
        cv, cok = ev(w.condition, cols)
        rv, rok = remap_codes(w.result, ev(w.result, cols))
        take = cok & cv
        v = torch.where(take, rv, v)
        ok = torch.where(take, rok, ok)
    ctx.expr_dicts[node] = np.array(union_vals, dtype=object)
    return v, ok


def _lower_cast(node: ir.Cast, cols, ev, ctx: LoweringContext) -> Lane:
    v, ok = ev(node.term, cols)
    ft, tt = node.term.type, node.type
    if ft == tt:
        return v, ok
    if ft.is_dictionary and tt.is_dictionary:
        # varchar(n) truncation: lengths are advisory; keep codes but
        # re-register the dictionary under the cast node for downstream
        # dictionary consumers (comparisons, derived string functions)
        d = ctx.dict_for_expr(node.term)
        if d is not None:
            ctx.expr_dicts[node] = d
        return v, ok
    if ft.is_dictionary:
        return _cast_varchar_parse(node, v, ok, ctx)
    wide_src = v.dim() == 2
    tdt = torch_dtype(tt.np_dtype) if not getattr(tt, "wide", False) else torch.int64
    wide_tgt = getattr(tt, "wide", False)
    if wide_src or wide_tgt:
        from ..ops import wide_decimal as wd

        if ft.is_decimal and tt.is_decimal:
            w = wd.decimal_rescale_wide(wd.promote(v), ft.scale, tt.scale)
            return (w if wide_tgt else wd.narrow(w)), ok
        if wide_src and tt.name == "double":
            return wd.to_double(v) / (10**ft.scale), ok
        if wide_src and T.is_integral(tt):
            w = wd.decimal_rescale_wide(v, ft.scale, 0)
            return wd.narrow(w).to(tdt), ok
        if T.is_integral(ft) and wide_tgt:
            return wd.rescale(wd.widen(v.to(torch.int64)), tt.scale), ok
        if ft.name in ("double", "real") and wide_tgt:
            # via float: beyond 2^53 the double itself has no more digits
            n = round_half_away(v * (10**tt.scale))
            return wd.widen(n.to(torch.int64)), ok
        raise NotImplementedError(f"cast {ft} -> {tt} (wide decimal)")
    if ft.is_decimal and tt.is_decimal:
        return decimal_rescale(v, ft.scale, tt.scale), ok
    if ft.is_decimal and tt.name == "double":
        return v.to(torch.float64) / (10**ft.scale), ok
    if ft.name in ("double", "real") and tt.is_decimal:
        return round_half_away(v * (10**tt.scale)).to(torch.int64), ok
    if ft.is_decimal and T.is_integral(tt):
        return decimal_rescale(v, ft.scale, 0).to(tdt), ok
    if T.is_integral(ft) and tt.is_decimal:
        return v.to(torch.int64) * (10**tt.scale), ok
    return v.to(tdt), ok


def _cast_varchar_parse(node: ir.Cast, v, ok, ctx: LoweringContext) -> Lane:
    """CAST(varchar AS numeric/date): parse each dictionary entry host-side,
    gather values + a validity table (bad parses -> NULL, TRY semantics)."""
    d = ctx.dict_for_expr(node.term)
    if d is None:
        raise NotImplementedError("varchar cast requires a dictionary input")
    tt = node.type
    vals = np.zeros(len(d), dtype=tt.np_dtype)
    valid = np.ones(len(d), dtype=bool)
    for i, s in enumerate(d):
        s = str(s).strip()
        try:
            if tt.name == "date":
                import datetime

                from .functions import days_from_civil

                dt = datetime.date.fromisoformat(s)
                vals[i] = days_from_civil(dt.year, dt.month, dt.day)
            elif tt.is_decimal:
                from decimal import Decimal

                vals[i] = int(Decimal(s).scaleb(tt.scale).to_integral_value())
            elif tt.name in ("double", "real"):
                vals[i] = float(s)
            elif tt.name == "boolean":
                low = s.lower()
                if low in ("true", "t", "1"):
                    vals[i] = True
                elif low in ("false", "f", "0"):
                    vals[i] = False
                else:
                    valid[i] = False
            else:
                vals[i] = int(s)
        except (ValueError, ArithmeticError):
            valid[i] = False
    res = dict_gather(vals, v, 0)
    okt = dict_gather(valid, v, False)
    return res, ok & okt


# functions whose FIRST argument is consumed through its dictionary
# (dict_for_expr); a constant string argument must still get a lane +
# single-entry dictionary
DICT_INPUT_FNS = frozenset({
    "split", "json_extract_scalar", "json_extract", "json_array_length",
    "json_size", "json_array_contains", "json_format",
    "url_extract_host", "url_extract_path", "url_extract_query",
    "url_extract_protocol", "url_extract_fragment", "url_extract_port",
    "url_extract_parameter", "url_encode", "url_decode",
    "md5", "sha1", "sha256", "sha512", "crc32",
    "to_base64", "from_base64", "to_hex", "levenshtein_distance",
})


def _lower_call(node: ir.Call, cols, ev, ctx: LoweringContext) -> Lane:
    fn = FUNCTIONS.get(node.name)
    if fn is None:
        raise NotImplementedError(
            f"function {node.name} is not in this slice of the port"
        )
    # string constants (LIKE patterns etc.) and lambdas are consumed
    # host-side from the node itself; they have no device lane — except a
    # constant FIRST argument of dictionary-transforming functions like
    # split(), which needs a real (single-entry-dictionary) lane
    lanes = []
    for i, a in enumerate(node.args):
        if isinstance(a, ir.Lambda):
            lanes.append(None)
        elif (isinstance(a, ir.Constant) and isinstance(a.value, str)
                and not (i == 0 and node.name in DICT_INPUT_FNS)):
            lanes.append(None)
        else:
            lanes.append(ev(a, cols))
    return fn(node, lanes, ctx)
