"""The benchmark's own copy of the TPC-H data's formulas.

The port's TPC-H connector does not replay dbgen's byte stream: every
attribute is a pure function of (table, column, row index) through the
splitmix64 finalizer, keyed by the FNV-1a hash of the column's name.
This file freezes those formulas, so that the references compute the
columns each query reads without anything of the program.  It keeps
TPC-H's schema and cardinalities (spec v3.0.1 section 4.2): sparse order
keys (8 of every 32), 1 to 7 lines an order, customers whose key is a
multiple of 3 never order, l_extendedprice = quantity * retail price of
the part, dates chained off o_orderdate, return flag and line status
split at 1995-06-17.

Values are the lanes the SQL types hold: decimals as integers in units
of their last digit (cents), dates as days since 1970-01-01, dictionary
columns as codes into the vocabularies below.  uint64 arithmetic runs in
int64 tensors (add and multiply wrap alike; right shifts are made
logical), and `x mod n` of a uint64 goes through its two 32-bit halves.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

EPOCH_1992 = 8035           # 1992-01-01
ORDER_DATE_SPAN = 2406 - 151  # o_orderdate in [1992-01-01, 1998-08-02]
CURRENT_DATE = 9298         # 1995-06-17
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
RETURN_FLAGS = ("A", "N", "R")
LINE_STATUS = ("F", "O")
MAX_LINES = 7

_U64 = (1 << 64) - 1
_GOLD = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_LO32 = 0xFFFFFFFF


def _i64(x: int) -> int:
    """The int64 with the bit pattern of the uint64 `x`."""
    x &= _U64
    return x - (1 << 64) if x >= 1 << 63 else x


def _fnv(key: str) -> int:
    h = 0xCBF29CE484222325
    for ch in key.encode():
        h = ((h ^ ch) * 0x100000001B3) & _U64
    return h


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    return (x >> k) & ((1 << (64 - k)) - 1)


def h64(key: str, idx: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer of idx ^ fnv(key), as uint64 bits in int64."""
    z = (idx ^ _i64(_fnv(key))) + _i64(_GOLD)
    z = (z ^ _srl(z, 30)) * _i64(_MIX1)
    z = (z ^ _srl(z, 27)) * _i64(_MIX2)
    return z ^ _srl(z, 31)


def umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """uint64 `x` mod n, 0 < n < 2^31, every step below 2^63."""
    return ((_srl(x, 32) % n) * ((1 << 32) % n) + (x & _LO32)) % n


def uint_in(key: str, idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return umod(h64(key, idx), hi - lo + 1) + lo


def counts(sf: float) -> Dict[str, int]:
    return {
        "supplier": max(1, int(10_000 * sf)),
        "customer": max(1, int(150_000 * sf)),
        "part": max(1, int(200_000 * sf)),
        "orders": max(1, int(1_500_000 * sf)),
    }


class TpchData:
    """The columns of orders and lineitem, made order by order.

    `orders(j)` gives the order attributes of order indexes `j`;
    `lines(j, odate)` gives lineitem attributes laid out [MAX_LINES, len(j)],
    with `live` false past each order's line count."""

    def __init__(self, sf: float, device, block_orders: int = 1 << 22):
        self.sf = float(sf)
        self.device = torch.device(device)
        self.n = counts(self.sf)
        self.block_orders = int(block_orders)

    def blocks(self) -> Iterator[Tuple[int, int]]:
        n = self.n["orders"]
        for lo in range(0, n, self.block_orders):
            yield lo, min(n, lo + self.block_orders)

    def index(self, lo: int, hi: int) -> torch.Tensor:
        return torch.arange(lo, hi, dtype=torch.int64, device=self.device)

    # -- orders ------------------------------------------------------------
    @staticmethod
    def orderkey(j: torch.Tensor) -> torch.Tensor:
        return (j // 8) * 32 + (j % 8) + 1

    @staticmethod
    def order_index(orderkey: torch.Tensor) -> torch.Tensor:
        """j of each order key (-1 where no order has that key)."""
        k = orderkey - 1
        r = k % 32
        return torch.where(r < 8, (k // 32) * 8 + r, -1)

    def orders(self, j: torch.Tensor) -> Dict[str, torch.Tensor]:
        usable = self.n["customer"] - self.n["customer"] // 3
        i = umod(h64("o_custkey", j), max(1, usable))
        return {
            "orderdate": EPOCH_1992 + uint_in("o_orderdate", j, 0, ORDER_DATE_SPAN - 1),
            "custkey": 3 * (i // 2) + 1 + (i % 2),
            "lines": 1 + umod(h64("l_count", j), MAX_LINES),
            "shippriority": torch.zeros_like(j),
        }

    def segment(self, custkey: torch.Tensor) -> torch.Tensor:
        """c_mktsegment code of each customer key (row custkey - 1)."""
        return umod(h64("c_mktsegment", custkey - 1), len(SEGMENTS))

    # -- lineitem ------------------------------------------------------------
    def lines(self, j: torch.Tensor, odate: torch.Tensor, nlines: torch.Tensor,
              cols=("shipdate", "quantity", "extendedprice", "discount")
              ) -> Dict[str, torch.Tensor]:
        """Line attributes [MAX_LINES, len(j)] of orders j: quantity in
        whole units, prices and discount and tax in cents."""
        ln = torch.arange(MAX_LINES, dtype=torch.int64, device=j.device)[:, None]
        lid = j[None, :] * 8 + ln
        out = {"live": ln < nlines[None, :]}
        ship = odate[None, :] + 1 + umod(h64("l_shipdate", lid), 121)
        want = set(cols)
        if want & {"shipdate", "returnflag", "linestatus"}:
            out["shipdate"] = ship
        if want & {"quantity", "extendedprice"}:
            qty = uint_in("l_quantity", lid, 1, 50)
            out["quantity"] = qty
            if "extendedprice" in want:
                partkey = 1 + umod(h64("l_partkey", lid), self.n["part"])
                retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
                out["extendedprice"] = qty * retail
        if "discount" in want:
            out["discount"] = uint_in("l_discount", lid, 0, 10)
        if "tax" in want:
            out["tax"] = uint_in("l_tax", lid, 0, 8)
        if "returnflag" in want:
            receipt = ship + uint_in("l_receiptdate", lid, 1, 30)
            out["returnflag"] = torch.where(
                receipt <= CURRENT_DATE, umod(h64("l_returnflag", lid), 2) * 2, 1)
        if "linestatus" in want:
            out["linestatus"] = (ship > CURRENT_DATE).to(torch.int64)
        return out


def days(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    import datetime

    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def iso(day: int) -> str:
    import datetime

    return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(day))).isoformat()
