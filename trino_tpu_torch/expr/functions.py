"""Scalar function registry: name -> lowering to torch ops.

Counterpart of trino_tpu/expr/functions.py.  Each function lowers to
PyTorch ops on (values, valid) lanes, evaluated eagerly: decimal
arithmetic and rescale, division with round-half-away, the math library
(float64, out-of-domain rows NULL), the civil-date functions (integer
arithmetic, exact), and the string functions, which transform each
dictionary entry on the host and gather a derived dictionary's codes on
the device.  The analyzer-facing typing rules (arith_result_type,
SIGNATURES, CONST_EVAL) are copied verbatim.

The array, map and lambda functions live in expr/arrays.py and register
here; the JSON, URL, digest, base64/hex, crc32 and levenshtein functions
are dictionary projections on the host like the string functions, and
to_unixtime / from_unixtime are float64 arithmetic on the device.  A
function typed by the analyzer but not lowered here raises
NotImplementedError at execution (trino_tpu_torch/expr/lower.py).

Decimal arithmetic follows the reference's DecimalOperators scale rules
(add/sub: s=max(s1,s2); mul: s=s1+s2 capped at 6; div: s=max(6, s1)).
Integer division is explicit about rounding: torch's ``//`` floors,
like jnp's, and every round-half-away is computed in |.|-space.
"""
from __future__ import annotations

import itertools
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


_FILL_DTYPE = {"b": torch.bool, "i": torch.int64, "f": torch.float64}


def _gathered_dtype(tbl: torch.dtype, fill) -> torch.dtype:
    """The dtype of the JAX package's jnp.where(codes >= 0, table[codes],
    fill) under x64: a Python fill is weakly typed, so an int fill
    widens a bool table to int64 and a float fill a bool or integer
    table to float64; otherwise the table's dtype stands."""
    kind = np.asarray(fill).dtype.kind
    if kind == "i" and tbl == torch.bool:
        return torch.int64
    if kind == "f" and not tbl.is_floating_point:
        return torch.float64
    return tbl


def dict_gather(table: np.ndarray, codes: torch.Tensor, fill=False):
    """Apply a per-dictionary-entry table to a lane of codes;
    out-of-dictionary codes (negative sentinels) produce ``fill``.  The
    result's dtype is the JAX package's (_gathered_dtype; an empty table
    gives the fill's own dtype)."""
    tbl = torch.as_tensor(np.asarray(table), device=codes.device)
    if tbl.shape[0] == 0:
        dt = _FILL_DTYPE[np.asarray(fill).dtype.kind]
        return torch.full(codes.shape, fill, dtype=dt, device=codes.device)
    dt = _gathered_dtype(tbl.dtype, fill)
    safe = torch.clamp(codes.to(torch.int64), 0, tbl.shape[0] - 1)
    fill_t = torch.full((), fill, dtype=dt, device=codes.device)
    return torch.where(codes >= 0, tbl[safe].to(dt), fill_t)


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


def _sqrt(node, lanes, ctx):
    v, ok = lanes[0]
    fv = v.to(torch.float64)
    if node.args[0].type.is_decimal:
        fv = fv / (10 ** node.args[0].type.scale)
    return torch.sqrt(torch.clamp(fv, min=0.0)), ok & (fv >= 0)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _floor(node, lanes, ctx):
    v, ok = lanes[0]
    at = node.args[0].type
    if at.is_decimal:
        q = _fdiv(v, 10**at.scale)
        return (q * (10 ** node.type.scale) if node.type.is_decimal else q), ok
    return (torch.floor(v) if v.is_floating_point() else v), ok


def _ceil(node, lanes, ctx):
    v, ok = lanes[0]
    at = node.args[0].type
    if at.is_decimal:
        q = -_fdiv(-v, 10**at.scale)
        return (q * (10 ** node.type.scale) if node.type.is_decimal else q), ok
    return (torch.ceil(v) if v.is_floating_point() else v), ok


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


def _quarter(node, lanes, ctx):
    v, ok = lanes[0]
    _, m, _ = civil_from_days(v)
    return _fdiv(m - 1, 3) + 1, ok


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


def memoized(ctx, node, src, compute):
    """compute(), a pure function of `node` and the dictionary `src`,
    once per (node, dictionary object) while the context's projection
    memo (LoweringContext.memo, the session's) holds the result: the
    eager counterpart of the JAX package reusing a traced fragment, whose
    host dictionary work ran once at trace time.  The entry keeps `src`
    alive, so no other dictionary can take its id meanwhile."""
    memo = getattr(ctx, "memo", None)
    if memo is None:
        return compute()
    key = (node, id(src))
    hit = memo.get(key)
    if hit is not None and hit[0] is src:
        return hit[1]
    out = compute()
    memo.put(key, (src, out))
    return out


def derived_remap(ctx, node, src, transform_entries):
    """register_derived_dict(ctx, node, transform_entries(src)), memoized:
    the old-code -> new-code remap, with node's derived dictionary
    registered."""
    def compute():
        remap = register_derived_dict(ctx, node, transform_entries(src))
        return remap, ctx.expr_dicts[node]

    remap, derived = memoized(ctx, node, src, compute)
    ctx.expr_dicts[node] = derived
    return remap


def _derived_string_fn(node, lanes, ctx, transform):
    """Apply a host string transform per dictionary entry and register a
    derived dictionary for the produced expression (the dictionary-
    projection trick: O(|dict|) host work, one O(n) device gather)."""
    src = ctx.dict_for_expr(node.args[0])
    if src is None:
        raise NotImplementedError(f"{node.name}() requires a dictionary input")
    remap = derived_remap(ctx, node, src,
                          lambda d: [transform(str(x)) for x in d])
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


# --- generic numeric machinery -----------------------------------------


def to_double(v, t: T.Type):
    """Lane values -> float64 in value space (decimals divide out scale)."""
    fv = v.to(torch.float64)
    if t.is_decimal:
        fv = fv / (10**t.scale)
    return fv


def coerce_to(v, ft: T.Type, tt: T.Type):
    """Coerce lane values between numeric representations.  Wide target
    or source lanes stay in/enter the two-limb form."""
    wide_tgt = getattr(tt, "wide", False)
    if v.dim() == 2 or wide_tgt:
        from ..ops import wide_decimal as wd

        if ft.is_decimal and tt.is_decimal:
            w = wd.decimal_rescale_wide(
                wd.promote(v if v.dim() == 2 else v.to(torch.int64)),
                ft.scale, tt.scale,
            )
            return w if wide_tgt else wd.narrow(w)
        if ft.is_decimal:  # wide -> double/int
            return (wd.to_double(v) / (10**ft.scale)).to(_np_dt(tt))
        if ft.name in ("double", "real"):
            n = round_half_away(v * (10**tt.scale)).to(torch.int64)
            return wd.widen(n)
        return wd.rescale(wd.widen(v.to(torch.int64)), tt.scale)
    if ft.is_decimal and tt.is_decimal:
        return decimal_rescale(v.to(torch.int64), ft.scale, tt.scale)
    if ft.is_decimal:
        return to_double(v, ft).to(_np_dt(tt))
    if tt.is_decimal:
        if ft.name in ("double", "real"):
            return round_half_away(v * (10**tt.scale)).to(torch.int64)
        return v.to(torch.int64) * (10**tt.scale)
    return v.to(_np_dt(tt))


def _dbl_unary(f, domain=None):
    """Factory: double-valued unary math function with an optional
    domain check (out-of-domain rows become NULL, TRY semantics)."""

    def low(node, lanes, ctx):
        v, ok = lanes[0]
        fv = to_double(v, node.args[0].type)
        res = f(fv)
        if domain is not None:
            good = domain(fv)
            return torch.where(good, res, 0.0), ok & good
        return res, ok

    return low


def _positive_or_one(v):
    return torch.where(v > 0, v, 1.0)


def _log(node, lanes, ctx):
    if len(lanes) == 1:
        v, ok = lanes[0]
        fv = to_double(v, node.args[0].type)
        return torch.log(_positive_or_one(fv)), ok & (fv > 0)
    (bv, bok), (xv, xok) = lanes
    fb = to_double(bv, node.args[0].type)
    fx = to_double(xv, node.args[1].type)
    good = (fb > 0) & (fx > 0)
    res = torch.log(_positive_or_one(fx)) / torch.log(torch.where(fb > 0, fb, 2.0))
    return torch.where(good, res, 0.0), bok & xok & good


def _power(node, lanes, ctx):
    (bv, bok), (ev_, eok) = lanes
    fb = to_double(bv, node.args[0].type)
    fe = to_double(ev_, node.args[1].type)
    return torch.pow(fb, fe), bok & eok


def _cbrt(v):
    # torch has no cbrt: the real cube root through |v|^(1/3)
    return torch.sign(v) * torch.pow(torch.abs(v), 1.0 / 3.0)


def _atan2(node, lanes, ctx):
    (yv, yok), (xv, xok) = lanes
    return torch.atan2(
        to_double(yv, node.args[0].type), to_double(xv, node.args[1].type)
    ), yok & xok


def _sign(node, lanes, ctx):
    v, ok = lanes[0]
    if node.args[0].type.name in ("double", "real"):
        return torch.sign(v), ok
    return torch.sign(v).to(torch.int64), ok


def _truncate(node, lanes, ctx):
    v, ok = lanes[0]
    at = node.args[0].type
    nd = 0
    if len(lanes) > 1:
        d = node.args[1]
        assert isinstance(d, ir.Constant), "truncate() digits must be constant"
        nd = int(d.value)
    if at.is_decimal:
        if nd >= at.scale:
            return v, ok
        div = 10 ** (at.scale - nd)
        q = torch.sign(v) * _fdiv(torch.abs(v), div)
        return q * div, ok
    f = 10.0**nd
    return torch.trunc(v * f) / f, ok


def _width_bucket(node, lanes, ctx):
    (ov, ook), (lv, lok), (hv, hok), (nv, nok) = lanes
    op = to_double(ov, node.args[0].type)
    b1 = to_double(lv, node.args[1].type)
    b2 = to_double(hv, node.args[2].type)
    n = nv.to(torch.int64)
    ok = ook & lok & hok & nok & (n > 0) & (b1 != b2)
    zero = torch.zeros_like(n)

    def bucket(num, den):
        raw = torch.floor(n * num / den).to(torch.int64) + 1
        return torch.minimum(torch.maximum(raw, zero), n + 1)

    asc = bucket(op - b1, torch.where(b1 != b2, b2 - b1, 1.0))
    asc = torch.where(op >= b2, n + 1, torch.where(op < b1, zero, asc))
    # descending bounds (bound1 > bound2) count buckets downward
    desc = bucket(b1 - op, torch.where(b1 != b2, b1 - b2, 1.0))
    desc = torch.where(op > b1, zero, torch.where(op <= b2, n + 1, desc))
    return torch.where(b1 <= b2, asc, desc), ok


def _extreme(node, lanes, take_max: bool):
    ot = node.type
    vals, ok = [], None
    for a, (v, aok) in zip(node.args, lanes):
        vals.append(coerce_to(v, a.type, ot))
        ok = aok if ok is None else ok & aok
    r = vals[0]
    if r.dim() == 2:
        # wide decimal: per-limb extremes are not 128-bit order — select
        # whole rows by lexicographic comparison
        from ..ops import wide_decimal as wd

        for v in vals[1:]:
            take = wd.compare(v, r, ">" if take_max else "<")
            r = torch.where(take[..., None], v, r)
        return r, ok
    f = torch.maximum if take_max else torch.minimum
    for v in vals[1:]:
        r = f(r, v)
    return r, ok


def _greatest(node, lanes, ctx):
    return _extreme(node, lanes, True)


def _least(node, lanes, ctx):
    return _extreme(node, lanes, False)


def _double_predicate(f, other: bool):
    def low(node, lanes, ctx):
        v, ok = lanes[0]
        if node.args[0].type.name in ("double", "real"):
            return f(v), ok
        return torch.full(v.shape, other, dtype=torch.bool, device=v.device), ok

    return low


def _rand(node, lanes, ctx):
    """Per-row uniform double in [0,1): the splitmix64 finalizer over
    (row index + the per-query seed the analyzer draws), bit-identical
    to the JAX package's (uint64 arithmetic in int64, logical shifts)."""
    from ..ops.aggregation import _splitmix64
    from ..ops.int128 import srl

    sv, _ = lanes[0]
    n = sv.shape[0]
    z = _splitmix64(
        sv.to(torch.int64) + torch.arange(n, dtype=torch.int64, device=sv.device)
    )
    v = srl(z, 11).to(torch.float64) * (1.0 / (1 << 53))
    return v, torch.ones(n, dtype=torch.bool, device=sv.device)


# --- more strings (dictionary-code domain) -----------------------------


def _const_str(node, i: int, default=None) -> str | None:
    if len(node.args) <= i:
        return default
    a = node.args[i]
    assert isinstance(a, ir.Constant), f"{node.name} arg {i} must be constant"
    return a.value


def _const_int(node, i: int, default=None):
    if len(node.args) <= i:
        return default
    a = node.args[i]
    assert isinstance(a, ir.Constant), f"{node.name} arg {i} must be constant"
    return int(a.value)


def _derived_nullable_string_fn(node, lanes, ctx, transform):
    """Like _derived_string_fn but transform may return None -> NULL row."""
    res, cok = _derived_string_fn(node, lanes, ctx, transform)
    return res, cok & (res >= 0)


def _dict_numeric_fn(node, lanes, ctx, f, dtype=np.int64, fill=0):
    """Numeric-from-string: per-dictionary-entry host eval + device
    gather; f may return None -> NULL row."""
    src = ctx.dict_for_expr(node.args[0])
    if src is None:
        raise NotImplementedError(f"{node.name}() requires a dictionary input")

    def compute():
        vals = np.full(len(src), fill, dtype=dtype)
        valid = np.ones(len(src), dtype=bool)
        for i, x in enumerate(src):
            r = f(str(x))
            if r is None:
                valid[i] = False
            else:
                vals[i] = r
        return vals, valid

    vals, valid = memoized(ctx, node, src, compute)
    cv, cok = lanes[0]
    return dict_gather(vals, cv, fill), cok & dict_gather(valid, cv, False)


def _str_fn(transform):
    return lambda node, lanes, ctx: _derived_string_fn(node, lanes, ctx, transform)


def _replace(node, lanes, ctx):
    search = _const_str(node, 1)
    rep = _const_str(node, 2, "")
    return _derived_string_fn(node, lanes, ctx, lambda s: s.replace(search, rep))


def _pad(left: bool):
    def low(node, lanes, ctx):
        n = _const_int(node, 1)
        pad = _const_str(node, 2, " ")

        def tf(s: str) -> str:
            if len(s) >= n:
                return s[:n]
            filln = n - len(s)
            fill = (pad * filln)[:filln]
            return fill + s if left else s + fill

        return _derived_string_fn(node, lanes, ctx, tf)

    return low


def _split_part(node, lanes, ctx):
    delim = _const_str(node, 1)
    idx = _const_int(node, 2)

    def tf(s: str):
        parts = s.split(delim) if delim else [s]
        return parts[idx - 1] if 1 <= idx <= len(parts) else None

    return _derived_nullable_string_fn(node, lanes, ctx, tf)


def _translate(node, lanes, ctx):
    frm = _const_str(node, 1)
    to = _const_str(node, 2)
    table = {ord(a): (to[i] if i < len(to) else None) for i, a in enumerate(frm)}
    return _derived_string_fn(node, lanes, ctx, lambda s: s.translate(table))


def _strpos(node, lanes, ctx):
    sub = _const_str(node, 1)
    return _dict_numeric_fn(node, lanes, ctx, lambda s: s.find(sub) + 1)


def _codepoint(node, lanes, ctx):
    return _dict_numeric_fn(node, lanes, ctx, lambda s: ord(s[0]) if s else None)


def _dict_predicate(node, lanes, ctx, pred):
    col = node.args[0]
    if ctx.dict_for_expr(col) is None:
        raise NotImplementedError(f"{node.name} requires a dictionary column")
    table = ctx.dict_mask(col, pred)
    cv, cok = lanes[0]
    return dict_gather(table, cv), cok


def _starts_with(node, lanes, ctx):
    prefix = _const_str(node, 1)
    return _dict_predicate(node, lanes, ctx, lambda s: s.startswith(prefix))


def _regexp_like(node, lanes, ctx):
    rx = re.compile(_const_str(node, 1))
    return _dict_predicate(node, lanes, ctx, lambda s: rx.search(s) is not None)


def _regexp_extract(node, lanes, ctx):
    rx = re.compile(_const_str(node, 1))
    group = _const_int(node, 2, 0)

    def tf(s: str):
        m = rx.search(s)
        if m is None:
            return None
        try:
            return m.group(group)
        except IndexError:
            return None

    return _derived_nullable_string_fn(node, lanes, ctx, tf)


def _regexp_replace(node, lanes, ctx):
    rx = re.compile(_const_str(node, 1))
    # Trino writes back references as $1, python as \1
    pyrep = re.sub(r"\$(\d+)", r"\\\1", _const_str(node, 2, ""))
    return _derived_string_fn(node, lanes, ctx, lambda s: rx.sub(pyrep, s))


def _concat(node, lanes, ctx):
    """concat over string constants and dictionary columns.  Several
    dictionary inputs combine into a cross-product dictionary (capped),
    in the JAX package's stride order."""
    MAX_COMBINED = 1 << 16
    parts = []  # ('c', str) | ('d', dict_array, lane)
    ok = None
    for a, lane in zip(node.args, lanes):
        if lane is None:
            parts.append(("c", a.value))
            continue
        d = ctx.dict_for_expr(a)
        if d is None:
            raise NotImplementedError("concat requires dictionary inputs")
        parts.append(("d", d, lane))
        ok = lane[1] if ok is None else ok & lane[1]
    dict_parts = [p for p in parts if p[0] == "d"]
    if not dict_parts:
        raise NotImplementedError("all-constant concat should have been folded")
    if len(dict_parts) == 1:
        at = parts.index(dict_parts[0])
        pre = "".join(p[1] for p in parts[:at] if p[0] == "c")
        post = "".join(p[1] for p in parts[at + 1:] if p[0] == "c")
        remap = derived_remap(ctx, node, dict_parts[0][1],
                              lambda d: [pre + str(x) + post for x in d])
        return dict_gather(remap, dict_parts[0][2][0], -1), ok
    size = 1
    for p in dict_parts:
        size *= len(p[1])
    if size == 0:
        # a part with an empty dictionary (a NULL varchar constant) makes
        # every row NULL
        ctx.expr_dicts[node] = np.array([], dtype=object)
        codes = torch.full(dict_parts[0][2][0].shape, -1, dtype=torch.int32,
                           device=dict_parts[0][2][0].device)
        return codes, torch.zeros(codes.shape, dtype=torch.bool,
                                  device=codes.device)
    if size > MAX_COMBINED:
        raise NotImplementedError(
            f"concat cross-dictionary size {size} exceeds cap {MAX_COMBINED}"
        )
    # combined code = sum(code_i * stride_i); dictionary = cross product
    strides = []
    stride = 1
    for p in reversed(dict_parts):
        strides.append(stride)
        stride *= len(p[1])
    strides.reverse()
    code = None
    for (_, _d, lane), st in zip(dict_parts, strides):
        c = torch.clamp(lane[0], min=0).to(torch.int64) * st
        code = c if code is None else code + c
    out = []
    for combo in itertools.product(*[[str(x) for x in p[1]] for p in dict_parts]):
        pieces = iter(combo)
        out.append("".join(p[1] if p[0] == "c" else next(pieces) for p in parts))
    ctx.expr_dicts[node] = np.array(out, dtype=object)
    return code.to(torch.int32), ok


# --- more date/time ----------------------------------------------------


def days_from_civil_v(y, m, d):
    """Vectorized inverse of civil_from_days."""
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = m + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _is_leap(y):
    return (torch.remainder(y, 4) == 0) & (
        (torch.remainder(y, 100) != 0) | (torch.remainder(y, 400) == 0)
    )


_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31], np.int64)


def _days_in_month(y, m):
    base = torch.as_tensor(_MONTH_DAYS, device=m.device)[m - 1]
    return base + ((m == 2) & _is_leap(y)).to(torch.int64)


def _iso_dow(days):
    # 1970-01-01 was a Thursday (ISO 4); Monday=1..Sunday=7
    return torch.remainder(days.to(torch.int64) + 3, 7) + 1


def _day_of_week(node, lanes, ctx):
    v, ok = lanes[0]
    return _iso_dow(v), ok


def _jan1(y):
    one = torch.ones_like(y)
    return days_from_civil_v(y, one, one)


def _day_of_year(node, lanes, ctx):
    v, ok = lanes[0]
    y, _, _ = civil_from_days(v)
    return v.to(torch.int64) - _jan1(y) + 1, ok


def _iso_week_parts(days):
    y, m, d = civil_from_days(days)
    dow = _iso_dow(days)
    doy = days.to(torch.int64) - _jan1(y) + 1
    w = _fdiv(doy - dow + 10, 7)

    def p(yy):
        return torch.remainder(yy + _fdiv(yy, 4) - _fdiv(yy, 100) + _fdiv(yy, 400), 7)

    long_year = (p(y) == 4) | (p(y - 1) == 3)
    prev_long = (p(y - 1) == 4) | (p(y - 2) == 3)
    week = torch.where(w == 53, torch.where(long_year, 53, 1), w)
    week = torch.where(w == 0, torch.where(prev_long, 53, 52), week)
    yow = (y + ((m == 12) & (week == 1)).to(torch.int64)
           - ((m == 1) & (week >= 52)).to(torch.int64))
    return week, yow


def _week(node, lanes, ctx):
    v, ok = lanes[0]
    week, _ = _iso_week_parts(v)
    return week.to(torch.int64), ok


def _year_of_week(node, lanes, ctx):
    v, ok = lanes[0]
    _, yow = _iso_week_parts(v)
    return yow.to(torch.int64), ok


def _last_day_of_month(node, lanes, ctx):
    v, ok = lanes[0]
    y, m, _ = civil_from_days(v)
    first = days_from_civil_v(y, m, torch.ones_like(m))
    return (first + _days_in_month(y, m) - 1).to(v.dtype), ok


def _date_trunc(node, lanes, ctx):
    unit = _const_str(node, 0).lower()
    v, ok = lanes[1]
    days = v.to(torch.int64)
    if unit == "day":
        return v, ok
    if unit == "week":
        return (days - (_iso_dow(days) - 1)).to(v.dtype), ok
    y, m, _ = civil_from_days(days)
    one = torch.ones_like(y)
    if unit == "month":
        return days_from_civil_v(y, m, one).to(v.dtype), ok
    if unit == "quarter":
        qm = 3 * _fdiv(m - 1, 3) + 1
        return days_from_civil_v(y, qm, one).to(v.dtype), ok
    if unit == "year":
        return days_from_civil_v(y, one, one).to(v.dtype), ok
    raise NotImplementedError(f"date_trunc unit {unit}")


def _date_add(node, lanes, ctx):
    unit = _const_str(node, 0).lower()
    nv, nok = lanes[1]
    v, ok = lanes[2]
    n = nv.to(torch.int64)
    days = v.to(torch.int64)
    ok = ok & nok
    if unit == "day":
        return (days + n).to(v.dtype), ok
    if unit == "week":
        return (days + 7 * n).to(v.dtype), ok
    if unit in ("month", "quarter", "year"):
        y, m, d = civil_from_days(days)
        mult = {"month": 1, "quarter": 3, "year": 12}[unit]
        total = y * 12 + (m - 1) + n * mult
        y2 = _fdiv(total, 12)
        m2 = torch.remainder(total, 12) + 1
        d2 = torch.minimum(d, _days_in_month(y2, m2))
        return days_from_civil_v(y2, m2, d2).to(v.dtype), ok
    raise NotImplementedError(f"date_add unit {unit}")


def _sign_trunc_div(x, k: int):
    return torch.sign(x) * _fdiv(torch.abs(x), k)


def _date_diff(node, lanes, ctx):
    unit = _const_str(node, 0).lower()
    (av, aok), (bv, bok) = lanes[1], lanes[2]
    a = av.to(torch.int64)
    b = bv.to(torch.int64)
    ok = aok & bok
    if unit == "day":
        return b - a, ok
    if unit == "week":
        return _sign_trunc_div(b - a, 7), ok
    y1, m1, d1 = civil_from_days(a)
    y2, m2, d2 = civil_from_days(b)
    months = (y2 * 12 + m2) - (y1 * 12 + m1)
    months = (months - ((months > 0) & (d2 < d1)).to(torch.int64)
              + ((months < 0) & (d2 > d1)).to(torch.int64))
    if unit == "month":
        return months, ok
    if unit == "quarter":
        return _sign_trunc_div(months, 3), ok
    if unit == "year":
        return _sign_trunc_div(months, 12), ok
    raise NotImplementedError(f"date_diff unit {unit}")


def _log_base(f):
    return _dbl_unary(lambda v: f(_positive_or_one(v)), lambda v: v > 0)


def _in_unit_range(v):
    return torch.abs(v) <= 1


FUNCTIONS: Dict[str, Callable] = {
    "add": _add,
    "subtract": _subtract,
    "multiply": _multiply,
    "divide": _divide,
    "modulus": _modulus,
    "mod": _modulus,
    "negate": _negate,
    "abs": _abs,
    "sqrt": _sqrt,
    "rand": _rand,
    "round": _round,
    "floor": _floor,
    "ceil": _ceil,
    "ceiling": _ceil,
    "truncate": _truncate,
    "sign": _sign,
    "ln": _log,
    "log": _log,
    "log2": _log_base(torch.log2),
    "log10": _log_base(torch.log10),
    "exp": _dbl_unary(torch.exp),
    "power": _power,
    "pow": _power,
    "cbrt": _dbl_unary(_cbrt),
    "degrees": _dbl_unary(torch.rad2deg),
    "radians": _dbl_unary(torch.deg2rad),
    "sin": _dbl_unary(torch.sin),
    "cos": _dbl_unary(torch.cos),
    "tan": _dbl_unary(torch.tan),
    "asin": _dbl_unary(torch.asin, _in_unit_range),
    "acos": _dbl_unary(torch.acos, _in_unit_range),
    "atan": _dbl_unary(torch.atan),
    "atan2": _atan2,
    "sinh": _dbl_unary(torch.sinh),
    "cosh": _dbl_unary(torch.cosh),
    "tanh": _dbl_unary(torch.tanh),
    "width_bucket": _width_bucket,
    "greatest": _greatest,
    "least": _least,
    "is_nan": _double_predicate(torch.isnan, False),
    "is_finite": _double_predicate(torch.isfinite, True),
    "is_infinite": _double_predicate(torch.isinf, False),
    "year": _year,
    "month": _month,
    "day": _day,
    "day_of_month": _day,
    "quarter": _quarter,
    "day_of_week": _day_of_week,
    "dow": _day_of_week,
    "day_of_year": _day_of_year,
    "doy": _day_of_year,
    "week": _week,
    "week_of_year": _week,
    "year_of_week": _year_of_week,
    "yow": _year_of_week,
    "last_day_of_month": _last_day_of_month,
    "date_trunc": _date_trunc,
    "date_add": _date_add,
    "date_diff": _date_diff,
    "like": _like,
    "length": _length,
    "substring": _substring,
    "substr": _substring,
    "upper": _str_fn(str.upper),
    "lower": _str_fn(str.lower),
    "trim": _str_fn(str.strip),
    "ltrim": _str_fn(str.lstrip),
    "rtrim": _str_fn(str.rstrip),
    "reverse": _str_fn(lambda s: s[::-1]),
    "replace": _replace,
    "lpad": _pad(True),
    "rpad": _pad(False),
    "split_part": _split_part,
    "translate": _translate,
    "strpos": _strpos,
    "position": _strpos,
    "codepoint": _codepoint,
    "starts_with": _starts_with,
    "regexp_like": _regexp_like,
    "regexp_extract": _regexp_extract,
    "regexp_replace": _regexp_replace,
    "concat": _concat,
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


# -- array functions (expr/arrays.py; registered late to avoid a cycle) --


def _sig_array_common(args):
    t = args[0].type
    if not getattr(t, "is_array", False):
        raise ValueError("expected an array argument")
    return t


def _sig_cardinality(args):
    t = args[0].type
    if not (getattr(t, "is_array", False) or getattr(t, "is_map", False)):
        raise ValueError("expected an array or map argument")
    return T.BIGINT


def _sig_element_at(args):
    t = args[0].type
    if getattr(t, "is_map", False):
        return t.value
    return _sig_array_common(args).element


def _sig_array_bool(args):
    _sig_array_common(args)
    return T.BOOLEAN


def _sig_array_elem(args):
    return _sig_array_common(args).element


def _sig_split(args):
    _req_dict(args, 0, "split")
    return T.array_of(T.VARCHAR)


def _register_array_functions():
    from .arrays import ARRAY_FUNCTIONS

    FUNCTIONS.update(ARRAY_FUNCTIONS)
    SIGNATURES.update({
        "cardinality": _sig_cardinality,
        "element_at": _sig_element_at,
        "contains": _sig_array_bool,
        "array_min": _sig_array_elem,
        "array_max": _sig_array_elem,
        "array_join": _sig_str_to_varchar_arr,
        "array_distinct": _sig_array_common,
        "array_sort": _sig_array_common,
        "array_reverse": _sig_array_common,
        "slice": _sig_array_common,
        "array_position": _sig_cardinality,
        "split": _sig_split,
        "map_keys": _sig_map_keys,
        "map_values": _sig_map_values,
        "map_concat": _sig_map_common,
        "any_match": _sig_array_bool,
        "all_match": _sig_array_bool,
        "none_match": _sig_array_bool,
        # transform/filter/reduce are typed by the analyzer (lambda-aware)
    })


def _sig_str_to_varchar_arr(args):
    _sig_array_common(args)
    return T.VARCHAR


def _sig_map_common(args):
    t = args[0].type
    if not getattr(t, "is_map", False):
        raise ValueError("expected a map argument")
    return t


def _sig_map_keys(args):
    return T.array_of(_sig_map_common(args).key)


def _sig_map_values(args):
    return T.array_of(_sig_map_common(args).value)


_register_array_functions()


# -- JSON functions (operator/scalar/json/*; JsonPath subset) ------------


def _json_path_eval(doc: str, path: str):
    """Evaluate a JsonPath subset ($.a.b[0], $[1].c) over a JSON text.
    Returns the python value, or None on parse/navigation failure (the
    reference returns NULL for invalid json in the _scalar flavors)."""
    import json as _json
    import re as _re

    try:
        v = _json.loads(doc)
    except (ValueError, TypeError):
        return None
    if path in ("$", ""):
        return v
    if not path.startswith("$"):
        return None
    steps = _re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]|\[\"([^\"]+)\"\]", path[1:])
    consumed = sum(len(f".{a}") if a else (len(f"[{b}]") if b else len(f'["{c}"]')) for a, b, c in steps)
    if consumed != len(path) - 1:
        return None  # unsupported path syntax
    for attr, idx, quoted in steps:
        key = attr or quoted
        if key:
            if not isinstance(v, dict) or key not in v:
                return None
            v = v[key]
        else:
            i = int(idx)
            if not isinstance(v, list) or i >= len(v):
                return None
            v = v[i]
    return v


def _json_extract_scalar(node, lanes, ctx):
    import json as _json

    path = _const_str(node, 1)

    def tf(s: str):
        v = _json_path_eval(s, path)
        if v is None or isinstance(v, (dict, list)):
            return None
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, float) and v.is_integer():
            return str(v)
        return str(v)

    return _derived_nullable_string_fn(node, lanes, ctx, tf)


def _json_extract(node, lanes, ctx):
    import json as _json

    path = _const_str(node, 1)

    def tf(s: str):
        v = _json_path_eval(s, path)
        return None if v is None else _json.dumps(v, separators=(",", ":"))

    return _derived_nullable_string_fn(node, lanes, ctx, tf)


def _json_array_length(node, lanes, ctx):
    import json as _json

    def f(s: str):
        try:
            v = _json.loads(s)
        except (ValueError, TypeError):
            return None
        return len(v) if isinstance(v, list) else None

    return _dict_numeric_fn(node, lanes, ctx, f)


def _json_size(node, lanes, ctx):
    path = _const_str(node, 1)

    def f(s: str):
        v = _json_path_eval(s, path)
        if isinstance(v, (dict, list)):
            return len(v)
        return 0 if v is not None else None

    return _dict_numeric_fn(node, lanes, ctx, f)


def _json_array_contains(node, lanes, ctx):
    import json as _json

    needle = node.args[1]
    assert isinstance(needle, ir.Constant), "json_array_contains needs a constant"
    want = needle.value
    if needle.type.is_decimal:
        want = want / 10 ** needle.type.scale

    def matches(x) -> bool:
        if isinstance(want, bool) or isinstance(x, bool):
            return x is want
        if isinstance(want, (int, float)) and isinstance(x, (int, float)):
            return x == want
        return type(x) is type(want) and x == want

    def f(s: str):
        try:
            v = _json.loads(s)
        except (ValueError, TypeError):
            return None
        if not isinstance(v, list):
            return None
        return any(matches(x) for x in v)

    return _dict_numeric_fn(node, lanes, ctx, f, dtype=np.bool_, fill=False)


def _json_format(node, lanes, ctx):
    import json as _json

    def tf(s: str):
        try:
            return _json.dumps(_json.loads(s), separators=(",", ":"))
        except (ValueError, TypeError):
            return None

    return _derived_nullable_string_fn(node, lanes, ctx, tf)


# -- URL functions (operator/scalar/UrlFunctions) ------------------------


def _url_fn(part: str):
    from urllib.parse import urlparse

    def low(node, lanes, ctx):
        def tf(s: str):
            try:
                u = urlparse(s)
            except ValueError:
                return None
            v = getattr(u, part)
            if part == "port":
                return None
            return v if v else None

        return _derived_nullable_string_fn(node, lanes, ctx, tf)

    return low


def _url_extract_port(node, lanes, ctx):
    from urllib.parse import urlparse

    def f(s: str):
        try:
            return urlparse(s).port
        except ValueError:
            return None

    return _dict_numeric_fn(node, lanes, ctx, f)


def _url_extract_parameter(node, lanes, ctx):
    from urllib.parse import parse_qs, urlparse

    name = _const_str(node, 1)

    def tf(s: str):
        try:
            q = parse_qs(urlparse(s).query, keep_blank_values=True)
        except ValueError:
            return None
        vals = q.get(name)
        return vals[0] if vals else None

    return _derived_nullable_string_fn(node, lanes, ctx, tf)


def _url_encode(node, lanes, ctx):
    from urllib.parse import quote

    return _derived_string_fn(node, lanes, ctx, lambda s: quote(s, safe=""))


def _url_decode(node, lanes, ctx):
    from urllib.parse import unquote

    return _derived_string_fn(node, lanes, ctx, unquote)


# -- digest / encoding functions (VarbinaryFunctions; hex-string results) --


def _hash_fn(algo: str):
    import hashlib

    def low(node, lanes, ctx):
        def tf(s: str):
            return getattr(hashlib, algo)(s.encode()).hexdigest()

        return _derived_string_fn(node, lanes, ctx, tf)

    return low


def _crc32(node, lanes, ctx):
    import zlib

    return _dict_numeric_fn(node, lanes, ctx, lambda s: zlib.crc32(s.encode()))


def _to_base64(node, lanes, ctx):
    import base64

    return _derived_string_fn(
        node, lanes, ctx, lambda s: base64.b64encode(s.encode()).decode()
    )


def _from_base64(node, lanes, ctx):
    import base64

    def tf(s: str):
        try:
            return base64.b64decode(s).decode()
        except Exception:
            return None

    return _derived_nullable_string_fn(node, lanes, ctx, tf)


def _to_hex(node, lanes, ctx):
    return _derived_string_fn(node, lanes, ctx, lambda s: s.encode().hex().upper())


def _levenshtein_distance(node, lanes, ctx):
    other = _const_str(node, 1)

    def dist(a: str, b: str) -> int:
        if len(a) < len(b):
            a, b = b, a
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        return prev[-1]

    return _dict_numeric_fn(node, lanes, ctx, lambda s: dist(s, other))


def _register_json_url_functions():
    FUNCTIONS.update({
        "json_extract_scalar": _json_extract_scalar,
        "json_extract": _json_extract,
        "json_array_length": _json_array_length,
        "json_size": _json_size,
        "json_array_contains": _json_array_contains,
        "json_format": _json_format,
        "url_extract_host": _url_fn("hostname"),
        "url_extract_path": _url_fn("path"),
        "url_extract_query": _url_fn("query"),
        "url_extract_protocol": _url_fn("scheme"),
        "url_extract_fragment": _url_fn("fragment"),
        "url_extract_port": _url_extract_port,
        "url_extract_parameter": _url_extract_parameter,
        "url_encode": _url_encode,
        "url_decode": _url_decode,
        "md5": _hash_fn("md5"),
        "sha1": _hash_fn("sha1"),
        "sha256": _hash_fn("sha256"),
        "sha512": _hash_fn("sha512"),
        "crc32": _crc32,
        "to_base64": _to_base64,
        "from_base64": _from_base64,
        "to_hex": _to_hex,
        "levenshtein_distance": _levenshtein_distance,
    })
    SIGNATURES.update({
        "json_extract_scalar": _sig_str_to_varchar,
        "json_extract": _sig_str_to_varchar,
        "json_array_length": _sig_str_to_bigint,
        "json_size": _sig_str_to_bigint,
        "json_array_contains": _sig_str_to_boolean,
        "json_format": _sig_str_to_varchar,
        "url_extract_host": _sig_str_to_varchar,
        "url_extract_path": _sig_str_to_varchar,
        "url_extract_query": _sig_str_to_varchar,
        "url_extract_protocol": _sig_str_to_varchar,
        "url_extract_fragment": _sig_str_to_varchar,
        "url_extract_port": _sig_str_to_bigint,
        "url_extract_parameter": _sig_str_to_varchar,
        "url_encode": _sig_str_to_varchar,
        "url_decode": _sig_str_to_varchar,
        "md5": _sig_str_to_varchar,
        "sha1": _sig_str_to_varchar,
        "sha256": _sig_str_to_varchar,
        "sha512": _sig_str_to_varchar,
        "crc32": _sig_str_to_bigint,
        "to_base64": _sig_str_to_varchar,
        "from_base64": _sig_str_to_varchar,
        "to_hex": _sig_str_to_varchar,
        "levenshtein_distance": _sig_str_to_bigint,
    })


_register_json_url_functions()



def _to_unixtime(node, lanes, ctx):
    v, ok = lanes[0]
    return v.to(torch.float64) / 1e6, ok


def _from_unixtime(node, lanes, ctx):
    v, ok = lanes[0]
    return (v.to(torch.float64) * 1e6).to(torch.int64), ok


def _sig_to_unixtime(args):
    if args[0].type.name != "timestamp":
        raise ValueError("to_unixtime expects a timestamp")
    return T.DOUBLE


def _sig_from_unixtime(args):
    return T.TIMESTAMP


FUNCTIONS.update({
    "to_unixtime": _to_unixtime,
    "from_unixtime": _from_unixtime,
})
SIGNATURES.update({
    "to_unixtime": _sig_to_unixtime,
    "from_unixtime": _sig_from_unixtime,
})
