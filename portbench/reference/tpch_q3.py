"""Plain reference of TPC-H Q3 (shipping priority).

Orders of customers in SEGMENT placed before DATE, their lines shipped
after DATE: revenue = sum(l_extendedprice * (1 - l_discount)) per order,
decimal(38,4); the 10 orders with the highest revenue, the earlier order
date first among equal revenues.  Orders tied on both keys may come in
any order, so an answer is held row by row to the order it names (its
revenue, date and priority, worked out again for that order) and as a
whole to the reference's sequence of (revenue, date)."""
from __future__ import annotations

from fractions import Fraction
from typing import List

import torch

from portbench.reference import exact
from portbench.reference.tpchgen import EPOCH_1992, SEGMENTS, TpchData, days, iso

LIMIT = 10
_DATE_BITS = 14  # o_orderdate - 1992-01-01 < 2^14
_COLS = ("shipdate", "extendedprice", "discount")


def _key(params):
    return tuple(sorted(params.items()))


def _block(data: TpchData, j: torch.Tensor, dtype) -> dict:
    """What every parameter set reads of orders j: their date, segment
    and priority, and each line's ship date and revenue (units of 1e-4
    in int64, or a float for the control)."""
    o = data.orders(j)
    li = data.lines(j, o["orderdate"], o["lines"], _COLS)
    if dtype == torch.int64:
        rev = li["extendedprice"] * (100 - li["discount"])
    else:
        rev = (li["extendedprice"].to(dtype) / 100) * (1 - li["discount"].to(dtype) / 100)
    return {"j": j, "odate": o["orderdate"], "seg": data.segment(o["custkey"]),
            "prio": o["shippriority"], "live": li["live"], "ship": li["shipdate"],
            "rev": rev}


def _revenue(b: dict, seg: int, cut: int):
    """(qualifies, revenue) of the block's orders under SEGMENT, DATE."""
    hit = b["live"] & (b["ship"] > cut)
    rev = torch.where(hit, b["rev"], 0).sum(0)
    return (b["odate"] < cut) & (b["seg"] == seg) & hit.any(0), rev


def _params(p):
    return SEGMENTS.index(p["SEGMENT"]), days(p["DATE"])


def expected(data: TpchData, param_sets: List[dict]) -> dict:
    """{key: [(revenue, orderdate text)] of the top LIMIT orders}."""
    best = {_key(p): [] for p in param_sets}
    for lo, hi in data.blocks():
        b = _block(data, data.index(lo, hi), torch.int64)
        for p in param_sets:
            ok, rev = _revenue(b, *_params(p))
            rank = torch.where(ok, (rev << _DATE_BITS)
                               + ((1 << _DATE_BITS) - 1 - (b["odate"] - EPOCH_1992)), -1)
            top = torch.topk(rank, min(LIMIT, rank.shape[0])).values
            best[_key(p)] += [int(v) for v in top.tolist() if v >= 0]
        del b
    out = {}
    for key, ranks in best.items():
        ranks = sorted(ranks, reverse=True)[:LIMIT]
        out[key] = [(exact.dec(r >> _DATE_BITS, 4),
                     iso(EPOCH_1992 + (1 << _DATE_BITS) - 1 - (r & ((1 << _DATE_BITS) - 1))))
                    for r in ranks]
    return out


def control(data: TpchData, param_sets: List[dict], dtype) -> dict:
    """The answers computed in `dtype` with the decimals as binary
    floating point, the revenue cast back to its scale (a DOUBLE
    accumulator in place of a DECIMAL one)."""
    cand = {_key(p): [] for p in param_sets}
    for lo, hi in data.blocks():
        b = _block(data, data.index(lo, hi), dtype)
        for p in param_sets:
            ok, rev = _revenue(b, *_params(p))
            rev = torch.where(ok, rev, -1)
            top = torch.topk(rev, min(2 * LIMIT, rev.shape[0])).indices
            for jj, r, d, pr in zip(b["j"][top].tolist(), rev[top].tolist(),
                                    b["odate"][top].tolist(), b["prio"][top].tolist()):
                if r >= 0:
                    cand[_key(p)].append((-r, d, jj, pr))
        del b
    out = {}
    for key, rows in cand.items():
        rows.sort()
        out[key] = [(int(TpchData.orderkey(torch.tensor(jj))), exact.rounded(-nr, 4), iso(d), pr)
                    for nr, d, jj, pr in rows[:LIMIT]]
    return out


def judge(data: TpchData, params: dict, want, rows):
    """Each row against its own order, then the (revenue, date) sequence."""
    seg, cut = _params(params)
    wrong = len(rows) != len(want)
    widest = Fraction(0)
    keys = torch.tensor([int(r[0]) for r in rows] or [1], dtype=torch.int64,
                        device=data.device)
    j = TpchData.order_index(keys)
    valid = (j >= 0) & (j < data.n["orders"])
    b = _block(data, torch.where(valid, j, 0), torch.int64)
    ok, rev = _revenue(b, seg, cut)
    ok, odate, prio = ok & valid, b["odate"], b["prio"]
    for i, row in enumerate(rows):
        if len(row) != 4 or not bool(ok[i]):
            wrong = True
            continue
        d = exact.gap_units(row[1], exact.dec(int(rev[i]), 4), 4)
        widest = max(widest, d)
        wrong |= d != 0 or row[2] != iso(int(odate[i])) or row[3] != int(prio[i])
    seq_wrong, seq_gap = exact.compare_rows(
        want, [(r[1], r[2]) for r in rows if len(r) == 4], (4, None))
    return wrong or seq_wrong, max(widest, seq_gap)
