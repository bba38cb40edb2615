"""Plain reference of TPC-H Q1 (pricing summary report).

For lineitem rows shipped on or before 1998-12-01 - DELTA days, grouped
by (l_returnflag, l_linestatus) in that order: sum_qty and sum_base_price
decimal(38,2), sum_disc_price decimal(38,4), sum_charge decimal(38,6),
avg_qty, avg_price and avg_disc decimal(18,6) (the sum over the count,
rounded half away from zero), count_order bigint."""
from __future__ import annotations

from typing import List

import torch

from portbench.reference import exact
from portbench.reference.tpchgen import LINE_STATUS, RETURN_FLAGS, TpchData, days

SCALES = (None, None, 2, 2, 4, 6, 6, 6, 6, None)
_COLS = ("shipdate", "quantity", "extendedprice", "discount", "tax",
         "returnflag", "linestatus")
_GROUPS = [(f, s) for f in range(len(RETURN_FLAGS)) for s in range(len(LINE_STATUS))]


def _key(params):
    return tuple(sorted(params.items()))


def _sums(data: TpchData, param_sets: List[dict], dtype):
    """{key: {group: [count, qty, ext, disc_price, charge, disc]}}: exact
    ints in the lanes' units (dtype int64) or floats in the values' own
    units (the control)."""
    cuts = {_key(p): days("1998-12-01") - int(p["DELTA"]) for p in param_sets}
    zero = 0 if dtype == torch.int64 else 0.0
    acc = {k: {g: [0] + [zero] * 5 for g in _GROUPS} for k in cuts}
    for lo, hi in data.blocks():
        j = data.index(lo, hi)
        o = data.orders(j)
        li = data.lines(j, o["orderdate"], o["lines"], _COLS)
        gid = li["returnflag"] * len(LINE_STATUS) + li["linestatus"]
        qty, ext, disc, tax = li["quantity"], li["extendedprice"], li["discount"], li["tax"]
        if dtype == torch.int64:
            vals = (qty * 100, ext, ext * (100 - disc), ext * (100 - disc) * (100 + tax), disc)
        else:
            e, d, t = ext.to(dtype) / 100, disc.to(dtype) / 100, tax.to(dtype) / 100
            vals = (qty.to(dtype), e, e * (1 - d), e * (1 - d) * (1 + t), d)
        for key, cut in cuts.items():
            m = li["live"] & (li["shipdate"] <= cut)
            for g in _GROUPS:
                mg = m & (gid == g[0] * len(LINE_STATUS) + g[1])
                a = acc[key][g]
                a[0] += int(mg.sum())
                for i, v in enumerate(vals):
                    a[i + 1] += torch.where(mg, v, 0).sum().item()
        del j, o, li, gid, qty, ext, disc, tax, vals
    return acc


def expected(data: TpchData, param_sets: List[dict]) -> dict:
    out = {}
    for key, groups in _sums(data, param_sets, torch.int64).items():
        rows = []
        for (f, s), (n, q, e, dp, ch, d) in sorted(groups.items()):
            if n:
                rows.append((RETURN_FLAGS[f], LINE_STATUS[s], exact.dec(q, 2),
                             exact.dec(e, 2), exact.dec(dp, 4), exact.dec(ch, 6),
                             exact.dec(exact.half_away(q * 10**4, n), 6),
                             exact.dec(exact.half_away(e * 10**4, n), 6),
                             exact.dec(exact.half_away(d * 10**4, n), 6), n))
        out[key] = rows
    return out


def control(data: TpchData, param_sets: List[dict], dtype) -> dict:
    """The answers computed in `dtype` with the decimals as binary
    floating point, each cast back to its column's scale (DOUBLE
    accumulators in place of DECIMAL ones)."""
    out = {}
    for key, groups in _sums(data, param_sets, dtype).items():
        rows = []
        for (f, s), (n, q, e, dp, ch, d) in sorted(groups.items()):
            if n:
                r = exact.rounded
                rows.append((RETURN_FLAGS[f], LINE_STATUS[s], r(q, 2), r(e, 2), r(dp, 4),
                             r(ch, 6), r(q / n, 6), r(e / n, 6), r(d / n, 6), n))
        out[key] = rows
    return out


def judge(data: TpchData, params: dict, want, rows):
    return exact.compare_rows(want, rows, SCALES)
