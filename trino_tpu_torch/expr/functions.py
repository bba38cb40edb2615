"""Scalar function registry: name -> lowering to torch ops.

Counterpart of trino_tpu/expr/functions.py.  Each function lowers to
PyTorch ops on (values, valid) lanes, evaluated eagerly.  This slice of
the port carries the functions TPC-H Q1/Q6 reach and their neighbours:
decimal arithmetic and rescale, division with round-half-away, date
parts, LIKE/length/substring over dictionaries.  The analyzer-facing typing rules
(arith_result_type, SIGNATURES, CONST_EVAL) are copied verbatim; a
function typed there but not lowered here raises NotImplementedError at
execution (trino_tpu_torch/expr/lower.py).

Decimal arithmetic follows the reference's DecimalOperators scale rules
(add/sub: s=max(s1,s2); mul: s=s1+s2 capped at 6; div: s=max(6, s1)).
Integer division is explicit about rounding: torch's ``//`` floors,
like jnp's, and every round-half-away is computed in |.|-space.
"""
from __future__ import annotations

import re
from typing import Callable, Dict

import numpy as np
import torch

from .. import types as T
from ..device import torch_dtype
from . import ir

Lane = tuple


def _is_t(v) -> bool:
    return isinstance(v, torch.Tensor)


def decimal_rescale(v, fs: int, ts: int):
    """Change decimal scale with round-half-away-from-zero (Decimals.rescale).

    Uses |v|-space so negative values round symmetrically.  Accepts a
    tensor or a numpy/python integer (the analyzer's constant folder)."""
    if ts > fs:
        return v * (10 ** (ts - fs))
    if ts < fs:
        div = 10 ** (fs - ts)
        if _is_t(v):
            return torch.sign(v) * torch.div(
                torch.abs(v) + div // 2, div, rounding_mode="floor"
            )
        return np.sign(v) * ((np.abs(v) + div // 2) // div)
    return v


_rescale = decimal_rescale  # internal alias


def _promote(a: torch.Tensor, b: torch.Tensor):
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def align_numeric(ta: T.Type, va, tb: T.Type, vb):
    """Coerce two numeric lanes to a common device representation."""
    if va.dim() == 2 or vb.dim() == 2:
        from ..ops import wide_decimal as wd

        sa = ta.scale if ta.is_decimal else 0
        sb = tb.scale if tb.is_decimal else 0
        s = max(sa, sb)
        if ta.name in ("double", "real") or tb.name in ("double", "real"):
            fa = wd.to_double(va) / 10**sa if va.dim() == 2 else va
            fb = wd.to_double(vb) / 10**sb if vb.dim() == 2 else vb
            return fa.to(torch.float64), fb.to(torch.float64)
        wa = wd.decimal_rescale_wide(wd.promote(va.to(torch.int64) if va.dim() == 1 else va), sa, s)
        wb = wd.decimal_rescale_wide(wd.promote(vb.to(torch.int64) if vb.dim() == 1 else vb), sb, s)
        return wa, wb
    if ta.is_decimal or tb.is_decimal:
        sa = ta.scale if ta.is_decimal else 0
        sb = tb.scale if tb.is_decimal else 0
        s = max(sa, sb)
        va = decimal_rescale(va.to(torch.int64), sa, s)
        vb = decimal_rescale(vb.to(torch.int64), sb, s)
        return va, vb
    return _promote(va, vb)


def dict_gather(table: np.ndarray, codes: torch.Tensor, fill=False):
    """Apply a per-dictionary-entry table to a lane of codes;
    out-of-dictionary codes (negative sentinels) produce ``fill``."""
    tbl = torch.as_tensor(np.asarray(table), device=codes.device)
    if tbl.shape[0] == 0:
        return torch.full(codes.shape, fill, dtype=tbl.dtype, device=codes.device)
    safe = torch.clamp(codes.to(torch.int64), 0, tbl.shape[0] - 1)
    fill_t = torch.full((), fill, dtype=tbl.dtype, device=codes.device)
    return torch.where(codes >= 0, tbl[safe], fill_t)


def round_half_away(v: torch.Tensor) -> torch.Tensor:
    """Half-away-from-zero rounding for floats (torch.round is
    half-to-even)."""
    return torch.sign(v) * torch.floor(torch.abs(v) + 0.5)


def _np_dt(t: T.Type) -> torch.dtype:
    return torch_dtype(t.np_dtype)


def _div_round_away(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """round_half_away(num / den) for int64 lanes, den != 0."""
    sign = torch.sign(num) * torch.sign(den)
    anum, aden = torch.abs(num), torch.abs(den)
    q = torch.div(anum, aden, rounding_mode="floor")
    rem = anum - q * aden
    return sign * (q + (2 * rem >= aden).to(torch.int64))


def _add(node, lanes, ctx):
    (lv, lok), (rv, rok) = lanes
    lt, rt, ot = node.args[0].type, node.args[1].type, node.type
    if lv.dim() == 2 or rv.dim() == 2 or getattr(ot, "wide", False):
        from ..ops import wide_decimal as wd

        sl = lt.scale if lt.is_decimal else 0
        sr = rt.scale if rt.is_decimal else 0
        wl = wd.decimal_rescale_wide(wd.promote(lv), sl, ot.scale)
        wr = wd.decimal_rescale_wide(wd.promote(rv), sr, ot.scale)
        res = wd.add(wl, wr)
        return (res if getattr(ot, "wide", False) else wd.narrow(res)), lok & rok
    if ot.is_decimal:
        sl = lt.scale if lt.is_decimal else 0
        sr = rt.scale if rt.is_decimal else 0
        lv = _rescale(lv.to(torch.int64), sl, ot.scale)
        rv = _rescale(rv.to(torch.int64), sr, ot.scale)
        return lv + rv, lok & rok
    if lt.name == "date" or lt.name == "timestamp":
        return (lv + rv.to(lv.dtype)), lok & rok
    dt = _np_dt(ot)
    return lv.to(dt) + rv.to(dt), lok & rok


def _subtract(node, lanes, ctx):
    (lv, lok), (rv, rok) = lanes
    lt, rt, ot = node.args[0].type, node.args[1].type, node.type
    if lv.dim() == 2 or rv.dim() == 2 or getattr(ot, "wide", False):
        from ..ops import wide_decimal as wd

        sl = lt.scale if lt.is_decimal else 0
        sr = rt.scale if rt.is_decimal else 0
        wl = wd.decimal_rescale_wide(wd.promote(lv), sl, ot.scale)
        wr = wd.decimal_rescale_wide(wd.promote(rv), sr, ot.scale)
        res = wd.subtract(wl, wr)
        return (res if getattr(ot, "wide", False) else wd.narrow(res)), lok & rok
    if ot.is_decimal:
        sl = lt.scale if lt.is_decimal else 0
        sr = rt.scale if rt.is_decimal else 0
        lv = _rescale(lv.to(torch.int64), sl, ot.scale)
        rv = _rescale(rv.to(torch.int64), sr, ot.scale)
        return lv - rv, lok & rok
    if lt.name == "date" and rt.name == "date":
        return (lv - rv).to(torch.int64), lok & rok
    if lt.name in ("date", "timestamp"):
        return (lv - rv.to(lv.dtype)), lok & rok
    dt = _np_dt(ot)
    return lv.to(dt) - rv.to(dt), lok & rok


def _multiply(node, lanes, ctx):
    (lv, lok), (rv, rok) = lanes
    ot = node.type
    if ot.is_decimal:
        from ..ops import wide_decimal as wd

        lt, rt = node.args[0].type, node.args[1].type
        sl = lt.scale if lt.is_decimal else 0
        sr = rt.scale if rt.is_decimal else 0
        pl = lt.precision if lt.is_decimal else 18
        pr = rt.precision if rt.is_decimal else 18
        wide_out = getattr(ot, "wide", False)
        input_wide = lv.dim() == 2 or rv.dim() == 2
        if pl + pr <= 18 and not input_wide:
            prod = lv.to(torch.int64) * rv.to(torch.int64)  # scale sl+sr
            return _rescale(prod, sl + sr, ot.scale), lok & rok
        if not input_wide and not getattr(ctx, "force_wide_mul", False):
            # declared precision says the product COULD exceed int64:
            # run the int64 product and flag suspicion via an f64
            # magnitude estimate; the executor re-runs with the 128-bit
            # product when a flag fires
            l64 = lv.to(torch.int64)
            r64 = rv.to(torch.int64)
            approx = torch.abs(l64.to(torch.float64)) * torch.abs(
                r64.to(torch.float64)
            )
            suspect = torch.sum((approx > 4.0e18) & lok & rok)
            if hasattr(ctx, "overflow_flags"):
                ctx.overflow_flags.append(suspect)
            return _rescale(l64 * r64, sl + sr, ot.scale), lok & rok
        res = wd.mul_wide(lv, rv, sl + sr - ot.scale)
        return (res if wide_out else wd.narrow(res)), lok & rok
    dt = _np_dt(ot)
    return lv.to(dt) * rv.to(dt), lok & rok


def _divide(node, lanes, ctx):
    (lv, lok), (rv, rok) = lanes
    ot = node.type
    ok = lok & rok
    if ot.is_decimal:
        lt, rt = node.args[0].type, node.args[1].type
        sl = lt.scale if lt.is_decimal else 0
        sr = rt.scale if rt.is_decimal else 0
        pl = lt.precision if lt.is_decimal else 18
        shift = ot.scale - sl + sr
        if lv.dim() == 2 or rv.dim() == 2:
            from ..ops import wide_decimal as wd

            num = wd.rescale(wd.promote(lv), shift)
            if rv.dim() == 2:
                den64 = torch.where(
                    wd.fits_narrow(rv), wd.narrow(rv),
                    torch.full_like(wd.narrow(rv), 2**63 - 1),
                )
            else:
                den64 = rv.to(torch.int64)
            nonzero = den64 != 0
            den_abs = torch.where(
                den64 == -(2**63),
                torch.full_like(den64, 2**63 - 1),
                torch.abs(torch.where(nonzero, den64, torch.ones_like(den64))),
            )
            q = wd.div_round(num, den_abs)
            q = torch.where((den64 < 0)[..., None], wd.negate(q), q)
            wide_out = getattr(ot, "wide", False)
            return (q if wide_out else wd.narrow(q)), ok & nonzero
        den = torch.where(rv == 0, torch.ones_like(rv), rv).to(torch.int64)
        assert shift >= 0, (lt, rt, ot)
        if pl + shift > 18 and not getattr(ctx, "force_wide_mul", False):
            l64 = lv.to(torch.int64)
            approx = torch.abs(l64.to(torch.float64)) * float(10**shift)
            suspect = torch.sum((approx > 4.0e18) & ok)
            if hasattr(ctx, "overflow_flags"):
                ctx.overflow_flags.append(suspect)
            num = l64 * (10**shift if shift <= 18 else 0)
            return _div_round_away(num, den), ok & (rv != 0)
        if pl + shift > 18:
            from ..ops import int128

            q = int128.mul_shift_div_round(lv.to(torch.int64), 10**shift, den)
            return q, ok & (rv != 0)
        num = lv.to(torch.int64) * (10**shift)
        return _div_round_away(num, den), ok & (rv != 0)
    if ot.name in ("double", "real"):
        dt = _np_dt(ot)
        den = torch.where(rv == 0, torch.ones_like(rv), rv).to(dt)
        return lv.to(dt) / den, ok & (rv != 0)
    den = torch.where(rv == 0, torch.ones_like(rv), rv)
    lv, den = _promote(lv, den)
    return torch.div(lv, den, rounding_mode="floor").to(_np_dt(ot)), ok & (rv != 0)


def _modulus(node, lanes, ctx):
    (lv, lok), (rv, rok) = lanes
    lt, rt = node.args[0].type, node.args[1].type
    lv, rv = align_numeric(lt, lv, rt, rv)
    den = torch.where(rv == 0, torch.ones_like(rv), rv)
    # Trino mod follows the dividend's sign (truncated division)
    res = torch.sign(lv) * torch.remainder(torch.abs(lv), torch.abs(den))
    return res.to(_np_dt(node.type)), lok & rok & (rv != 0)


def _negate(node, lanes, ctx):
    (v, ok) = lanes[0]
    if v.dim() == 2:
        from ..ops import wide_decimal as wd

        return wd.negate(v), ok
    return -v, ok


def _abs(node, lanes, ctx):
    v, ok = lanes[0]
    if v.dim() == 2:
        from ..ops import wide_decimal as wd

        mag, _ = wd.abs128(v)
        return mag, ok
    return torch.abs(v), ok


def _round(node, lanes, ctx):
    v, ok = lanes[0]
    at = node.args[0].type
    nd = 0
    if len(lanes) > 1:
        d = node.args[1]
        assert isinstance(d, ir.Constant), "round() digits must be constant"
        nd = int(d.value)
    if at.is_decimal:
        return _rescale(_rescale(v, at.scale, nd), nd, node.type.scale), ok
    if at.name in ("double", "real"):
        f = 10.0**nd
        return round_half_away(v * f) / f, ok
    return v, ok


# --- date/time ---------------------------------------------------------


def civil_from_days(days: torch.Tensor):
    """Vectorized days-since-epoch -> (year, month, day) (Howard
    Hinnant's civil_from_days, floor divisions explicit)."""
    fl = lambda a, b: torch.div(a, b, rounding_mode="floor")  # noqa: E731
    z = days.to(torch.int64) + 719468
    era = fl(z, 146097)
    doe = z - era * 146097
    yoe = fl(doe - fl(doe, 1460) + fl(doe, 36524) - fl(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fl(yoe, 4) - fl(yoe, 100))
    mp = fl(5 * doy + 2, 153)
    d = doy - fl(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y: int, m: int, d: int) -> int:
    """Host-side scalar inverse (for date literals)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _year(node, lanes, ctx):
    v, ok = lanes[0]
    y, _, _ = civil_from_days(v)
    return y, ok


def _month(node, lanes, ctx):
    v, ok = lanes[0]
    _, m, _ = civil_from_days(v)
    return m, ok


def _day(node, lanes, ctx):
    v, ok = lanes[0]
    _, _, d = civil_from_days(v)
    return d, ok


# --- strings (dictionary-code domain) ---------------------------------


def like_to_regex(pattern: str, escape: str | None = None) -> "re.Pattern":
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _like(node, lanes, ctx):
    col = node.args[0]
    pat = node.args[1]
    assert isinstance(pat, ir.Constant), "LIKE pattern must be constant"
    esc = None
    if len(node.args) > 2 and isinstance(node.args[2], ir.Constant):
        esc = node.args[2].value
    if ctx.dict_for_expr(col) is None:
        raise NotImplementedError("LIKE requires a dictionary-encoded column")
    rx = like_to_regex(pat.value, esc)
    table = ctx.dict_mask(col, lambda s: rx.match(s) is not None)
    cv, cok = lanes[0]
    return dict_gather(table, cv), cok


def _length(node, lanes, ctx):
    col = node.args[0]
    d = ctx.dict_for_expr(col)
    if d is None:
        raise NotImplementedError("length() requires a dictionary column")
    lens = np.array([len(str(s)) for s in d], dtype=np.int64)
    cv, cok = lanes[0]
    return dict_gather(lens, cv, 0), cok


def register_derived_dict(ctx, node, transformed):
    """Dedup a per-entry transformed string list into a derived dictionary
    registered for ``node``; returns the old-code -> new-code remap.  A
    ``None`` entry maps to code -1 (NULL row)."""
    index: dict = {}
    newvals: list = []
    remap = np.empty(len(transformed), dtype=np.int32)
    for i, t in enumerate(transformed):
        if t is None:
            remap[i] = -1
            continue
        if t not in index:
            index[t] = len(newvals)
            newvals.append(t)
        remap[i] = index[t]
    # element-wise object array: np.array(list_of_tuples, dtype=object)
    # would build a 2-D array for equal-length tuple entries
    arr = np.empty(len(newvals), dtype=object)
    for i, v in enumerate(newvals):
        arr[i] = v
    ctx.expr_dicts[node] = arr
    return remap


def _derived_string_fn(node, lanes, ctx, transform):
    """Apply a host string transform per dictionary entry and register a
    derived dictionary for the produced expression (the dictionary-
    projection trick: O(|dict|) host work, one O(n) device gather)."""
    src = ctx.dict_for_expr(node.args[0])
    if src is None:
        raise NotImplementedError(f"{node.name}() requires a dictionary input")
    remap = register_derived_dict(ctx, node, [transform(str(x)) for x in src])
    cv, cok = lanes[0]
    return dict_gather(remap, cv, -1), cok


def _const_int_arg(node, i: int) -> int:
    a = node.args[i]
    if not isinstance(a, ir.Constant):
        raise NotImplementedError(f"{node.name}() takes constant positions")
    return int(a.value)


def _substring(node, lanes, ctx):
    start = _const_int_arg(node, 1) - 1  # SQL is 1-based
    length = _const_int_arg(node, 2) if len(node.args) > 2 else None

    def tf(s: str) -> str:
        return s[start: start + length] if length is not None else s[start:]

    return _derived_string_fn(node, lanes, ctx, tf)


FUNCTIONS: Dict[str, Callable] = {
    "add": _add,
    "subtract": _subtract,
    "multiply": _multiply,
    "divide": _divide,
    "modulus": _modulus,
    "mod": _modulus,
    "negate": _negate,
    "abs": _abs,
    "round": _round,
    "year": _year,
    "month": _month,
    "day": _day,
    "day_of_month": _day,
    "like": _like,
    "length": _length,
    "substring": _substring,
    "substr": _substring,
}


# --- result-type inference used by the analyzer ------------------------


def arith_result_type(op: str, lt: T.Type, rt: T.Type) -> T.Type:
    """Decimal-aware result types, mirroring DecimalOperators'
    precision/scale rules with precision clamped to 18."""
    if op in ("add", "subtract"):
        if lt.name == "date" and rt.name == "bigint":
            return T.DATE
        if lt.name == "date" and rt.name == "date" and op == "subtract":
            return T.BIGINT
        if lt.is_decimal or rt.is_decimal:
            sl = lt.scale if lt.is_decimal else 0
            sr = rt.scale if rt.is_decimal else 0
            pl = lt.precision if lt.is_decimal else 18
            pr = rt.precision if rt.is_decimal else 18
            s = max(sl, sr)
            p = min(38, max(pl - sl, pr - sr) + s + 1)
            return T.decimal(p, s)
        return T.common_super_type(lt, rt)
    if op == "multiply":
        if lt.is_decimal or rt.is_decimal:
            sl = lt.scale if lt.is_decimal else 0
            sr = rt.scale if rt.is_decimal else 0
            pl = lt.precision if lt.is_decimal else 18
            pr = rt.precision if rt.is_decimal else 18
            # cap scale at 6 (Trino keeps sl+sr; 6 bounds rescale chains
            # while staying inside oracle tolerance)
            s = min(sl + sr, 6)
            return T.decimal(min(38, pl + pr), s)
        return T.common_super_type(lt, rt)
    if op == "divide":
        if lt.name in ("double", "real") or rt.name in ("double", "real"):
            return T.DOUBLE
        if lt.is_decimal or rt.is_decimal:
            sl = lt.scale if lt.is_decimal else 0
            s = max(6, sl)
            return T.decimal(18, s)
        if T.is_integral(lt) and T.is_integral(rt):
            return T.common_super_type(lt, rt)
        return T.DOUBLE
    if op == "modulus":
        return T.common_super_type(lt, rt)
    raise NotImplementedError(op)


# --- signature registry (analyzer-facing typing rules) ------------------
# Reference parity: metadata/GlobalFunctionCatalog.java:69 +
# metadata/FunctionResolver — here a name -> (ir args) -> result Type rule.


def _req_dict(args, i=0, name="function"):
    if not args[i].type.is_dictionary:
        raise ValueError(f"{name}() requires a varchar argument")


def _common_of(args):
    rt = args[0].type
    for a in args[1:]:
        rt = T.common_super_type(rt, a.type)
    return rt


def _sig_double(args):
    return T.DOUBLE


def _sig_bigint(args):
    return T.BIGINT


def _sig_boolean(args):
    return T.BOOLEAN


def _sig_varchar(args):
    return T.VARCHAR


def _sig_str_to_varchar(args):
    _req_dict(args)
    return T.VARCHAR


def _sig_str_to_bigint(args):
    _req_dict(args)
    return T.BIGINT


def _sig_str_to_boolean(args):
    _req_dict(args)
    return T.BOOLEAN


def _sig_arg0(args):
    return args[0].type


def _sig_common(args):
    return _common_of(args)


def _sig_common_nonstring(args):
    if any(a.type.is_dictionary for a in args):
        raise ValueError(
            "greatest()/least() on varchar is not supported (dictionary "
            "codes are not ordered by string value)"
        )
    return _common_of(args)


def _sig_sign(args):
    t = args[0].type
    if t.name in ("double", "real"):
        return t
    return T.BIGINT


def _sig_date_fn(args):
    # (unit, ..., date) -> date
    return args[-1].type


SIGNATURES: Dict[str, Callable] = {
    "mod": _sig_common,
    "truncate": _sig_arg0,
    "sign": _sig_sign,
    "ln": _sig_double,
    "log": _sig_double,
    "log2": _sig_double,
    "log10": _sig_double,
    "exp": _sig_double,
    "power": _sig_double,
    "pow": _sig_double,
    "cbrt": _sig_double,
    "degrees": _sig_double,
    "radians": _sig_double,
    "sin": _sig_double,
    "cos": _sig_double,
    "tan": _sig_double,
    "asin": _sig_double,
    "acos": _sig_double,
    "atan": _sig_double,
    "atan2": _sig_double,
    "sinh": _sig_double,
    "cosh": _sig_double,
    "tanh": _sig_double,
    "width_bucket": _sig_bigint,
    "greatest": _sig_common_nonstring,
    "least": _sig_common_nonstring,
    "is_nan": _sig_boolean,
    "is_finite": _sig_boolean,
    "is_infinite": _sig_boolean,
    "day_of_week": _sig_bigint,
    "dow": _sig_bigint,
    "day_of_year": _sig_bigint,
    "doy": _sig_bigint,
    "day_of_month": _sig_bigint,
    "week": _sig_bigint,
    "week_of_year": _sig_bigint,
    "year_of_week": _sig_bigint,
    "yow": _sig_bigint,
    "last_day_of_month": _sig_date_fn,
    "date_trunc": _sig_date_fn,
    "date_add": _sig_date_fn,
    "date_diff": _sig_bigint,
    "upper": _sig_str_to_varchar,
    "lower": _sig_str_to_varchar,
    "trim": _sig_str_to_varchar,
    "ltrim": _sig_str_to_varchar,
    "rtrim": _sig_str_to_varchar,
    "reverse": _sig_str_to_varchar,
    "replace": _sig_str_to_varchar,
    "lpad": _sig_str_to_varchar,
    "rpad": _sig_str_to_varchar,
    "split_part": _sig_str_to_varchar,
    "translate": _sig_str_to_varchar,
    "strpos": _sig_str_to_bigint,
    "codepoint": _sig_str_to_bigint,
    "starts_with": _sig_str_to_boolean,
    "regexp_like": _sig_str_to_boolean,
    "regexp_extract": _sig_str_to_varchar,
    "regexp_replace": _sig_str_to_varchar,
    "concat": _sig_varchar,
    "pi": _sig_double,
    "e": _sig_double,
}


# --- host-side constant evaluation (used by the analyzer's folder) ------


def _ce_str(f):
    def ev(out_t, args):
        return f(*[a.value for a in args])

    return ev


def _ce_dbl(f):
    import math  # noqa: F401

    def ev(out_t, args):
        vals = []
        for a in args:
            v = a.value
            if a.type.is_decimal:
                v = v / 10**a.type.scale
            vals.append(float(v))
        return f(*vals)

    return ev


def _const_eval_registry():
    import math

    return {
        "pi": lambda out_t, args: math.pi,
        "e": lambda out_t, args: math.e,
        "ln": _ce_dbl(math.log),
        "exp": _ce_dbl(math.exp),
        "log2": _ce_dbl(math.log2),
        "log10": _ce_dbl(math.log10),
        "power": _ce_dbl(lambda b, e: b**e),
        "pow": _ce_dbl(lambda b, e: b**e),
        "sqrt": _ce_dbl(math.sqrt),
        "sin": _ce_dbl(math.sin),
        "cos": _ce_dbl(math.cos),
        "tan": _ce_dbl(math.tan),
        "upper": _ce_str(lambda s: s.upper()),
        "lower": _ce_str(lambda s: s.lower()),
        "trim": _ce_str(lambda s: s.strip()),
        "ltrim": _ce_str(lambda s: s.lstrip()),
        "rtrim": _ce_str(lambda s: s.rstrip()),
        "reverse": _ce_str(lambda s: s[::-1]),
        "replace": _ce_str(lambda s, a, b="": s.replace(a, b)),
        "concat": _ce_str(lambda *ss: "".join(ss)),
        "length": _ce_str(len),
        "strpos": _ce_str(lambda s, sub: s.find(sub) + 1),
        "substring": None,  # handled in _eval_const (int args)
    }


CONST_EVAL = {k: v for k, v in _const_eval_registry().items() if v is not None}

