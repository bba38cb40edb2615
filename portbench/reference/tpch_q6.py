"""Plain reference of TPC-H Q6 (forecasting revenue change).

revenue = sum(l_extendedprice * l_discount) over lineitem rows shipped
in [DATE, DATE + 1 year), with l_discount in [DISCOUNT - 0.01, DISCOUNT +
0.01] and l_quantity < QUANTITY: decimal(38,4), exact, NULL over no row.
Lines are made order by order from the benchmark's own copy of the
generator's formulas, in blocks of orders on the given device."""
from __future__ import annotations

import datetime
from decimal import Decimal
from typing import Dict, List

import torch

from portbench.reference import exact
from portbench.reference.tpchgen import TpchData, days

SCALES = (4,)


def _bounds(params: Dict[str, str]):
    d = datetime.date.fromisoformat(params["DATE"])
    lo, hi = days(d.isoformat()), days(d.replace(year=d.year + 1).isoformat())
    disc = int(Decimal(params["DISCOUNT"]) * 100)
    return lo, hi, disc - 1, disc + 1, int(params["QUANTITY"])


def _key(params):
    return tuple(sorted(params.items()))


def _sums(data: TpchData, param_sets: List[dict], dtype):
    """{key: (rows matched, sum)} over every block; the sum is an exact
    int in units of 1e-4 (dtype int64) or a float (the control)."""
    acc = {_key(p): [0, 0 if dtype == torch.int64 else 0.0] for p in param_sets}
    bounds = {_key(p): _bounds(p) for p in param_sets}
    for lo, hi in data.blocks():
        j = data.index(lo, hi)
        o = data.orders(j)
        li = data.lines(j, o["orderdate"], o["lines"])
        ship, qty, disc = li["shipdate"], li["quantity"], li["discount"]
        if dtype == torch.int64:
            rev = li["extendedprice"] * disc
        else:
            rev = (li["extendedprice"].to(dtype) / 100) * (disc.to(dtype) / 100)
        for key, (d0, d1, c0, c1, q) in bounds.items():
            m = li["live"] & (ship >= d0) & (ship < d1) & (disc >= c0) & (disc <= c1) & (qty < q)
            acc[key][0] += int(m.sum())
            acc[key][1] += torch.where(m, rev, 0).sum().item()
        del j, o, li, ship, qty, disc, rev
    return acc


def expected(data: TpchData, param_sets: List[dict]) -> dict:
    return {k: [(exact.dec(s, 4) if n else None,)]
            for k, (n, s) in _sums(data, param_sets, torch.int64).items()}


def control(data: TpchData, param_sets: List[dict], dtype) -> dict:
    """The answers of this reference computed in `dtype` with the
    decimals as binary floating point, cast back to the column's scale
    (a DOUBLE accumulator in place of a DECIMAL one)."""
    return {k: [(exact.rounded(s, 4) if n else None,)]
            for k, (n, s) in _sums(data, param_sets, dtype).items()}


def judge(data: TpchData, params: dict, want, rows):
    return exact.compare_rows(want, rows, SCALES)
