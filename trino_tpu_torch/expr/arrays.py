"""Array functions + lambda evaluation over dictionary-encoded arrays.

Counterpart of trino_tpu/expr/arrays.py (the same host code; only the
device gathers are PyTorch).  Reference parity: operator/scalar/ArrayFunctions + the lambda-taking
classes (ArrayTransformFunction, ArrayFilterFunction, ReduceFunction,
ArrayAnyMatchFunction ...), and scalar/UnnestOperator's value model.

Array columns are dictionary-encoded (types.ArrayType): int32 codes into a
host dictionary of distinct python tuples.  Every array function therefore
runs host-side once per DISTINCT array (the dictionary-projection trick the
string functions use), and the result reaches the device as either a
derived dictionary (array/varchar results) or a numeric table built once
per distinct array and gathered on the device by each row's code.  Both
are memoized per (expression, dictionary) in the session's projection
memo (functions.memoized), as the JAX package's traced fragments reuse
the work of their trace.
Lambdas are evaluated by a small IR interpreter over python element values
(kept in IR-constant conventions: decimal -> unscaled int, date -> epoch
days) — the host-side stand-in for the reference's bytecode-compiled
lambda bodies.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .. import types as T
from . import ir

# ---------------------------------------------------------------------
# IR interpreter (lambda bodies over python scalars)


class _EvalError(ValueError):
    pass


def eval_ir(e: ir.Expr, env: Dict[str, object], special=None):
    """Evaluate an IR expression over python values (env: param -> value).
    Values follow IR-constant conventions.  Returns None for NULL.
    `special(e, env)` may claim a node first (returns (True, value)); used
    by MATCH_RECOGNIZE navigation (ops/matcher.py)."""
    if special is not None:
        handled, v = special(e, env)
        if handled:
            return v
    if isinstance(e, ir.Constant):
        return e.value
    if isinstance(e, ir.ColumnRef):
        if e.name not in env:
            raise _EvalError(f"lambda body references unbound column {e.name}")
        return env[e.name]
    if isinstance(e, ir.Call):
        from ..sql.analyzer import _eval_const

        args = []
        for a in e.args:
            v = eval_ir(a, env, special)
            if v is None:
                return None  # scalar functions are null-propagating
            args.append(ir.Constant(a.type, v))
        try:
            return _eval_const(e.name, e.type, tuple(args))
        except NotImplementedError:
            raise _EvalError(f"{e.name}() is not supported inside lambdas")
    if isinstance(e, ir.Comparison):
        lv = eval_ir(e.left, env, special)
        rv = eval_ir(e.right, env, special)
        if e.op == "is_distinct":
            return _coerce(lv, e.left.type) != _coerce(rv, e.right.type)
        if lv is None or rv is None:
            return None
        a = _coerce(lv, e.left.type)
        b = _coerce(rv, e.right.type)
        return {
            "=": a == b, "<>": a != b, "!=": a != b,
            "<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
        }[e.op]
    if isinstance(e, ir.Logical):
        vals = [eval_ir(t, env, special) for t in e.terms]
        if e.op == "and":
            if any(v is False for v in vals):
                return False
            return None if any(v is None for v in vals) else True
        if any(v is True for v in vals):
            return True
        return None if any(v is None for v in vals) else False
    if isinstance(e, ir.Not):
        v = eval_ir(e.term, env, special)
        return None if v is None else (not v)
    if isinstance(e, ir.IsNull):
        v = eval_ir(e.term, env, special)
        return (v is not None) if e.negate else (v is None)
    if isinstance(e, ir.Between):
        v = eval_ir(e.value, env, special)
        lo = eval_ir(e.low, env, special)
        hi = eval_ir(e.high, env, special)
        if v is None or lo is None or hi is None:
            return None
        r = (
            _coerce(lo, e.low.type) <= _coerce(v, e.value.type)
            <= _coerce(hi, e.high.type)
        )
        return (not r) if e.negate else r
    if isinstance(e, ir.In):
        v = eval_ir(e.value, env, special)
        if v is None:
            return None
        vv = _coerce(v, e.value.type)
        hit = any(
            i.value is not None and _coerce(eval_ir(i, env, special), i.type) == vv
            for i in e.items
        )
        return (not hit) if e.negate else hit
    if isinstance(e, ir.Case):
        for w in e.whens:
            if eval_ir(w.condition, env, special) is True:
                return eval_ir(w.result, env, special)
        return eval_ir(e.default, env, special) if e.default is not None else None
    if isinstance(e, ir.Cast):
        v = eval_ir(e.term, env, special)
        if v is None:
            return None
        return _cast_value(v, e.term.type, e.type)
    raise _EvalError(f"unsupported expression in lambda: {type(e).__name__}")


def _coerce(v, t: T.Type):
    """Value -> comparable form (decimals to true numeric value)."""
    if v is None:
        return None
    if t.is_decimal and t.scale:
        return v / 10 ** t.scale
    return v


def _cast_value(v, ft: T.Type, tt: T.Type):
    if tt.is_decimal:
        base = _coerce(v, ft) if not isinstance(v, str) else float(v)
        return int(round(float(base) * 10 ** tt.scale))
    if tt.name in ("double", "real"):
        return float(_coerce(v, ft))
    if tt.name in ("bigint", "integer", "smallint", "tinyint"):
        return int(_coerce(v, ft))
    if tt.is_dictionary and not getattr(tt, "is_array", False):
        return str(v)
    if tt.name == "boolean":
        return bool(v)
    return v


# ---------------------------------------------------------------------
# per-distinct-array evaluation helpers


def _array_dict(ctx, e: ir.Expr) -> np.ndarray:
    d = ctx.dict_for_expr(e)
    if d is None:
        raise NotImplementedError(
            "array expression has no dictionary (only dictionary-encoded "
            "arrays are supported)"
        )
    return d


def _table_fn(node, lanes, ctx, fn, out_dtype, null_value=0):
    """Numeric-result array function: compute fn(entry) per dictionary
    entry, gather per row.  fn returns python value or None."""
    from .functions import dict_gather, memoized

    src = _array_dict(ctx, node.args[0])

    def compute():
        vals = np.zeros(len(src), dtype=out_dtype)
        valid = np.zeros(len(src), dtype=bool)
        for i, entry in enumerate(src):
            r = fn(entry)
            if r is not None:
                vals[i] = r
                valid[i] = True
        return vals, valid

    vals, valid = memoized(ctx, node, src, compute)
    cv, cok = lanes[0]
    out = dict_gather(vals, cv, 0)
    ok = cok & dict_gather(valid, cv, False)
    return out, ok


def _derived_fn(node, lanes, ctx, fn):
    """Dictionary-result array function (array->array, array->varchar):
    fn(entry) -> tuple | str | None; result is a derived dictionary."""
    from .functions import derived_remap, dict_gather

    src = _array_dict(ctx, node.args[0])
    remap = derived_remap(ctx, node, src, lambda d: [fn(entry) for entry in d])
    cv, cok = lanes[0]
    return dict_gather(remap, cv, -1), cok


# ---------------------------------------------------------------------
# function lowerings (ctx-aware; registered into functions.FUNCTIONS)


def _cardinality(node, lanes, ctx):
    # arrays: element count; maps: entry count (entries are (k, v) pairs)
    return _table_fn(node, lanes, ctx, lambda a: len(a), np.int64)


def _element_at(node, lanes, ctx):
    coll_t = node.args[0].type
    idx = node.args[1]
    if not isinstance(idx, ir.Constant):
        raise NotImplementedError("element_at index/key must be constant")
    if getattr(coll_t, "is_map", False):
        key = idx.value

        def pick(entry):
            for k, v in entry:
                if k == key:
                    return v
            return None

        et = coll_t.value
    else:
        i = int(idx.value)

        def pick(entry):
            n = len(entry)
            if i == 0 or abs(i) > n:
                return None
            return entry[i - 1] if i > 0 else entry[n + i]

        et = coll_t.element
    if et.is_dictionary or getattr(et, "is_array", False):
        return _derived_fn(node, lanes, ctx, pick)
    return _table_fn(node, lanes, ctx, pick, et.np_dtype)


def _contains(node, lanes, ctx):
    x = node.args[1]
    if not isinstance(x, ir.Constant):
        raise NotImplementedError("contains() value must be constant")
    xv = x.value

    def hit(entry):
        if xv is None:
            return None
        if any(v == xv for v in entry if v is not None):
            return True
        if any(v is None for v in entry):
            return None
        return False

    return _table_fn(node, lanes, ctx, hit, np.bool_)


def _array_extreme(node, lanes, ctx, agg):
    et = node.args[0].type.element

    def fn(entry):
        vals = [v for v in entry if v is not None]
        if not vals or len(vals) != len(entry):
            return None  # Trino: null element -> NULL result
        return agg(vals)

    if et.is_dictionary:
        return _derived_fn(node, lanes, ctx, fn)
    return _table_fn(node, lanes, ctx, fn, et.np_dtype)


def _array_min(node, lanes, ctx):
    return _array_extreme(node, lanes, ctx, min)


def _array_max(node, lanes, ctx):
    return _array_extreme(node, lanes, ctx, max)


def _array_join(node, lanes, ctx):
    delim = node.args[1]
    if not isinstance(delim, ir.Constant):
        raise NotImplementedError("array_join delimiter must be constant")
    d = str(delim.value)
    et = node.args[0].type.element
    from ..page import _element_decoder

    dec = _element_decoder(et)

    def fn(entry):
        return d.join(str(dec(v)) for v in entry if v is not None)

    return _derived_fn(node, lanes, ctx, fn)


def _array_distinct(node, lanes, ctx):
    def fn(entry):
        seen = []
        for v in entry:
            if v not in seen:
                seen.append(v)
        return tuple(seen)

    return _derived_fn(node, lanes, ctx, fn)


def _array_sort(node, lanes, ctx):
    def fn(entry):
        vals = [v for v in entry if v is not None]
        nulls = [None] * (len(entry) - len(vals))
        return tuple(sorted(vals) + nulls)  # nulls last (Trino)

    return _derived_fn(node, lanes, ctx, fn)


def _array_reverse(node, lanes, ctx):
    return _derived_fn(node, lanes, ctx, lambda e: tuple(reversed(e)))


def _slice(node, lanes, ctx):
    start_c, len_c = node.args[1], node.args[2]
    if not (isinstance(start_c, ir.Constant) and isinstance(len_c, ir.Constant)):
        raise NotImplementedError("slice() bounds must be constant")
    start, length = int(start_c.value), int(len_c.value)

    def fn(entry):
        if start == 0 or length < 0:
            return None
        if start > 0:
            s = start - 1
        else:
            s = len(entry) + start
            if s < 0:
                return ()
        return tuple(entry[s : s + length])

    return _derived_fn(node, lanes, ctx, fn)


def _array_position(node, lanes, ctx):
    x = node.args[1]
    if not isinstance(x, ir.Constant):
        raise NotImplementedError("array_position value must be constant")
    xv = x.value

    def fn(entry):
        if xv is None:
            return None
        for i, v in enumerate(entry):
            if v == xv:
                return i + 1
        return 0

    return _table_fn(node, lanes, ctx, fn, np.int64)


def _split(node, lanes, ctx):
    from .functions import derived_remap, dict_gather

    delim = node.args[1]
    if not isinstance(delim, ir.Constant):
        raise NotImplementedError("split() delimiter must be constant")
    d = str(delim.value)
    src = _array_dict(ctx, node.args[0])  # varchar dictionary
    remap = derived_remap(
        ctx, node, src, lambda dd: [tuple(str(s).split(d)) for s in dd]
    )
    cv, cok = lanes[0]
    return dict_gather(remap, cv, -1), cok


# -- lambda functions ---------------------------------------------------


def _lambda_of(node, i=1) -> ir.Lambda:
    lam = node.args[i]
    assert isinstance(lam, ir.Lambda), "expected a lambda argument"
    return lam


def _transform(node, lanes, ctx):
    lam = _lambda_of(node)
    p = lam.params[0]

    def fn(entry):
        return tuple(eval_ir(lam.body, {p: v}) for v in entry)

    return _derived_fn(node, lanes, ctx, fn)


def _filter(node, lanes, ctx):
    lam = _lambda_of(node)
    p = lam.params[0]

    def fn(entry):
        return tuple(v for v in entry if eval_ir(lam.body, {p: v}) is True)

    return _derived_fn(node, lanes, ctx, fn)


def _match(node, lanes, ctx, mode):
    lam = _lambda_of(node)
    p = lam.params[0]

    def fn(entry):
        results = [eval_ir(lam.body, {p: v}) for v in entry]
        if mode == "any":
            if any(r is True for r in results):
                return True
            return None if any(r is None for r in results) else False
        if mode == "all":
            if any(r is False for r in results):
                return False
            return None if any(r is None for r in results) else True
        # none
        if any(r is True for r in results):
            return False
        return None if any(r is None for r in results) else True

    return _table_fn(node, lanes, ctx, fn, np.bool_)


def _any_match(node, lanes, ctx):
    return _match(node, lanes, ctx, "any")


def _all_match(node, lanes, ctx):
    return _match(node, lanes, ctx, "all")


def _none_match(node, lanes, ctx):
    return _match(node, lanes, ctx, "none")


def _reduce(node, lanes, ctx):
    # reduce(arr, initial, (state, x) -> newstate, state -> result)
    init = node.args[1]
    if not isinstance(init, ir.Constant):
        raise NotImplementedError("reduce() initial state must be constant")
    step = _lambda_of(node, 2)
    out_lam = _lambda_of(node, 3)
    sp, xp = step.params
    op = out_lam.params[0]
    rt = node.type

    def fn(entry):
        state = init.value
        for v in entry:
            state = eval_ir(step.body, {sp: state, xp: v})
        return eval_ir(out_lam.body, {op: state})

    if rt.is_dictionary and not getattr(rt, "is_array", False):
        return _derived_fn(node, lanes, ctx, fn)
    return _table_fn(node, lanes, ctx, fn, rt.np_dtype)


# -- map functions ------------------------------------------------------


def _map_keys(node, lanes, ctx):
    return _derived_fn(node, lanes, ctx, lambda e: tuple(k for k, _ in e))


def _map_values(node, lanes, ctx):
    return _derived_fn(node, lanes, ctx, lambda e: tuple(v for _, v in e))


def _map_entry_count(node, lanes, ctx):
    return _table_fn(node, lanes, ctx, lambda e: len(e), np.int64)


def _map_concat(node, lanes, ctx):
    # map_concat(m1, m2): later keys win (reference MapConcatFunction)
    d2 = ctx.dict_for_expr(node.args[1])
    if d2 is None:
        raise NotImplementedError("map_concat requires dictionary maps")
    if len(d2) != 1:
        raise NotImplementedError(
            "map_concat second argument must be a constant map"
        )
    other = list(d2[0])

    def fn(entry):
        merged = {k: v for k, v in entry}
        for k, v in other:
            merged[k] = v
        return tuple(merged.items())

    return _derived_fn(node, lanes, ctx, fn)


ARRAY_FUNCTIONS = {
    "cardinality": _cardinality,
    "element_at": _element_at,
    "contains": _contains,
    "array_min": _array_min,
    "array_max": _array_max,
    "array_join": _array_join,
    "array_distinct": _array_distinct,
    "array_sort": _array_sort,
    "array_reverse": _array_reverse,
    "slice": _slice,
    "array_position": _array_position,
    "split": _split,
    "transform": _transform,
    "filter": _filter,
    "any_match": _any_match,
    "all_match": _all_match,
    "none_match": _none_match,
    "reduce": _reduce,
    "map_keys": _map_keys,
    "map_values": _map_values,
    "map_concat": _map_concat,
}
