"""On-device TPC-H column generation.

Counterpart of trino_tpu/connectors/tpch_device.py.  Reference parity:
plugin/trino-tpch generates rows in-process during the scan
(TpchPageSourceProvider streams generator output straight into the
operator pipeline).  The connector's generator is counter-based: every
attribute is a pure function of (table, column, row index) through the
splitmix64 finalizer (connectors/tpch.py), so a scan's lanes can be made
on the device from a row range, with no host generation and no
host-to-device copy.

The columns are plain PyTorch tensor code on an explicit device: the
same functions run on the card and on the CPU (where the tests hold them
byte for byte against the host generator and the JAX package's
`device_lanes`).  uint64 arithmetic runs in int64 (PyTorch's uint64 has
no shift, remainder or add): wrap-around `+` and `*` give the uint64
bits, right shifts are logical (ops/int128.srl), and an unsigned
`x mod n` for the n < 2^31 that occur here goes through the two 32-bit
halves (_umod).  The splitmix64 finalizer is the one TABLESAMPLE and
checksum use (ops/aggregation._splitmix64).

Eager PyTorch materialises every step of the hash chain, so rows are
generated in chunks: a chunk holds at most _LIVE_LANES int64
temporaries a row, and its rows are sized so those stay inside the
DEVGEN_TEMP_LANES lanes a row of the whole table that the out-of-core
gate reserves (exec/streaming._devgen_temp_bytes).

Columns whose host path formats per-row strings (names, phones,
addresses, clerks) are not generated here; a scan touching one takes
the host generator for the whole scan (`supports`).  The JAX package's
executable cache (`clear_jit_cache`) has no counterpart: eager tensor
code compiles nothing.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..exec.streaming import DEVGEN_TEMP_LANES
from ..ops.aggregation import _splitmix64
from ..ops.int128 import MASK32, as_i64, srl
from . import tpch as H

_M_GOLD = 0x9E3779B97F4A7C15
# int64 temporaries a generated row keeps live at most inside one chunk
# (row index, hash state, shift/xor/product steps, the halves of a
# remainder, and lineitem's order slot, line number and shared draws)
_LIVE_LANES = 16
_MIN_CHUNK_ROWS = 1 << 16

# columns the device path can produce (everything except host-formatted
# lazy strings); comments/names with fixed vocabularies are dict CODES
DEVICE_COLS: Dict[str, frozenset] = {
    "region": frozenset({"r_regionkey", "r_name", "r_comment"}),
    "nation": frozenset(
        {"n_nationkey", "n_name", "n_regionkey", "n_comment"}
    ),
    "supplier": frozenset(
        {"s_suppkey", "s_nationkey", "s_acctbal", "s_comment"}
    ),
    "customer": frozenset(
        {"c_custkey", "c_nationkey", "c_acctbal", "c_mktsegment",
         "c_comment"}
    ),
    "part": frozenset(
        {"p_partkey", "p_mfgr", "p_brand", "p_type", "p_size",
         "p_container", "p_retailprice", "p_comment"}
    ),
    "partsupp": frozenset(
        {"ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost",
         "ps_comment"}
    ),
    "orders": frozenset(
        {"o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
         "o_orderdate", "o_orderpriority", "o_shippriority", "o_comment"}
    ),
    "lineitem": frozenset(
        {"l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
         "l_quantity", "l_extendedprice", "l_discount", "l_tax",
         "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
         "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment"}
    ),
}

_NCOMMENT = len(H.COMMENTS)
# lane dtype of each generated column: the host generator's
_INT32 = {"r_name", "n_name", "c_mktsegment", "p_mfgr", "p_brand", "p_type",
          "p_container", "o_orderdate", "o_orderpriority", "o_orderstatus",
          "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
          "l_receiptdate", "l_shipinstruct", "l_shipmode"}


def _dtype(col: str) -> torch.dtype:
    return torch.int32 if col in _INT32 or col.endswith("_comment") else torch.int64


# ---------------------------------------------------------------------
# splitmix64 in int64 (connectors/tpch.h64 / uint_in)


def _h64(key: str, idx: torch.Tensor, salt: int = 0) -> torch.Tensor:
    base = as_i64(int(H._fnv(key)) ^ (salt * _M_GOLD & 0xFFFFFFFFFFFFFFFF))
    return _splitmix64(idx ^ base)


def _umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """Unsigned x mod n of uint64 bit patterns held in int64, 0 < n < 2^31:
    (hi * 2^32 + lo) mod n over the logical halves, every step below 2^63."""
    return ((srl(x, 32) % n) * ((1 << 32) % n) + (x & MASK32)) % n


def _uint_in(key: str, idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return _umod(_h64(key, idx), hi - lo + 1) + lo


def _dict_code(key: str, idx: torch.Tensor, n: int) -> torch.Tensor:
    return _umod(_h64(key, idx), n).to(torch.int32)


def _orderkey(j: torch.Tensor) -> torch.Tensor:
    return (j // 8) * 32 + (j % 8) + 1


def _custkey_for_order(j: torch.Tensor, ncust: int) -> torch.Tensor:
    usable = ncust - ncust // 3
    i = _umod(_h64("o_custkey", j), max(1, usable))
    return 3 * (i // 2) + 1 + (i % 2)


def _retail_price_cents(partkey: torch.Tensor) -> torch.Tensor:
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def _ps_suppkey(partkey: torch.Tensor, i, nsupp: int) -> torch.Tensor:
    return (partkey + i * (nsupp // 4 + (partkey - 1) // nsupp)) % nsupp + 1


def _line_count(j: torch.Tensor) -> torch.Tensor:
    return 1 + _umod(_h64("l_count", j), 7)


def _order_date(j: torch.Tensor) -> torch.Tensor:
    return H.EPOCH_1992 + _uint_in("o_orderdate", j, 0, H.ORDER_DATE_SPAN - 1)


# ---------------------------------------------------------------------
# per-table column generators over one chunk of row indices


def _base_table(table: str, col: str, idx: torch.Tensor,
                n: Dict[str, int]) -> torch.Tensor:
    """One column of a non-lineitem table at global row index `idx`."""
    c = col
    if c in ("r_regionkey", "n_nationkey"):
        return idx
    if c in ("r_name", "n_name"):
        return idx.to(torch.int32)
    if c == "n_regionkey":
        region_of = torch.tensor([r for _, r in H.NATIONS], dtype=torch.int64,
                                 device=idx.device)
        return region_of[torch.clamp(idx, 0, len(H.NATIONS) - 1)]
    if c in ("s_suppkey", "c_custkey", "p_partkey"):
        return idx + 1
    if c in ("s_nationkey", "c_nationkey"):
        return _uint_in(c, idx, 0, 24)
    if c in ("s_acctbal", "c_acctbal"):
        return _uint_in(c, idx, -99999, 999999)
    if c in ("c_mktsegment", "p_mfgr", "o_orderpriority"):
        return _dict_code(c, idx, 5)
    if c == "p_brand":
        m = _umod(_h64("p_mfgr", idx), 5)
        return (m * 5 + _umod(_h64("p_brand", idx), 5)).to(torch.int32)
    if c == "p_type":
        return _dict_code(c, idx, len(H.P_TYPES))
    if c == "p_size":
        return _uint_in(c, idx, 1, 50)
    if c == "p_container":
        return _dict_code(c, idx, len(H.CONTAINERS))
    if c == "p_retailprice":
        return _retail_price_cents(idx + 1)
    if c == "ps_partkey":
        return idx // 4 + 1
    if c == "ps_suppkey":
        return _ps_suppkey(idx // 4 + 1, idx % 4, n["supplier"])
    if c == "ps_availqty":
        return _uint_in(c, idx, 1, 9999)
    if c == "ps_supplycost":
        return _uint_in(c, idx, 100, 100000)
    if c == "o_orderkey":
        return _orderkey(idx)
    if c == "o_custkey":
        return _custkey_for_order(idx, n["customer"])
    if c == "o_orderdate":
        return _order_date(idx).to(torch.int32)
    if c == "o_totalprice":
        return _uint_in(c, idx, 100000, 50000000)
    if c == "o_shippriority":
        return torch.zeros_like(idx)
    if c == "o_orderstatus":
        # F when every line shipped by CURRENT_DATE, O when none, else P
        odate = _order_date(idx)
        counts = _line_count(idx)
        all_f = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
        all_o = all_f.clone()
        for ln in range(7):
            has = counts > ln
            ship = odate + 1 + _umod(_h64("l_shipdate", idx * 8 + ln), 121)
            f = ship <= H.CURRENT_DATE
            all_f &= ~has | f
            all_o &= ~has | ~f
        return torch.where(all_f, 0, torch.where(all_o, 1, 2)).to(torch.int32)
    if c.endswith("_comment"):
        return _dict_code(c, idx, _NCOMMENT)
    raise KeyError(f"{table}.{c}")


class _LineDraws:
    """Lineitem draws shared by several columns of one chunk, made once."""

    def __init__(self, oj: torch.Tensor, ln: torch.Tensor, n: Dict[str, int]):
        self.oj, self.ln, self.n = oj, ln, n
        self.lid = oj * 8 + ln
        self._memo: Dict[str, torch.Tensor] = {}

    def get(self, name: str) -> torch.Tensor:
        v = self._memo.get(name)
        if v is None:
            v = self._memo[name] = getattr(self, "_" + name)()
        return v

    def _odate(self):
        return _order_date(self.oj)

    def _ship(self):
        return self.get("odate") + 1 + _umod(_h64("l_shipdate", self.lid), 121)

    def _partkey(self):
        return 1 + _umod(_h64("l_partkey", self.lid), self.n["part"])

    def _qty(self):
        return _uint_in("l_quantity", self.lid, 1, 50)

    def _receipt(self):
        return self.get("ship") + _uint_in("l_receiptdate", self.lid, 1, 30)


def _lineitem(col: str, d: _LineDraws) -> torch.Tensor:
    """One lineitem column at (order index, line number)."""
    c, lid = col, d.lid
    if c == "l_orderkey":
        return _orderkey(d.oj)
    if c == "l_partkey":
        return d.get("partkey")
    if c == "l_suppkey":
        slot = _umod(_h64("l_supp_slot", lid), 4)
        return _ps_suppkey(d.get("partkey"), slot, d.n["supplier"])
    if c == "l_linenumber":
        return d.ln + 1
    if c == "l_quantity":
        return d.get("qty") * 100
    if c == "l_extendedprice":
        return d.get("qty") * _retail_price_cents(d.get("partkey"))
    if c == "l_discount":
        return _uint_in(c, lid, 0, 10)
    if c == "l_tax":
        return _uint_in(c, lid, 0, 8)
    if c == "l_shipdate":
        return d.get("ship").to(torch.int32)
    if c == "l_commitdate":
        return (d.get("odate") + _uint_in(c, lid, 30, 90)).to(torch.int32)
    if c == "l_receiptdate":
        return d.get("receipt").to(torch.int32)
    if c == "l_returnflag":
        rnd = _umod(_h64(c, lid), 2)
        return torch.where(d.get("receipt") <= H.CURRENT_DATE, rnd * 2, 1).to(torch.int32)
    if c == "l_linestatus":
        return (d.get("ship") > H.CURRENT_DATE).to(torch.int32)
    if c == "l_shipinstruct":
        return _dict_code(c, lid, 4)
    if c == "l_shipmode":
        return _dict_code(c, lid, 7)
    if c == "l_comment":
        return _dict_code(c, lid, _NCOMMENT)
    raise KeyError(f"lineitem.{c}")


# ---------------------------------------------------------------------
# entry points


def supports(table: str, cols: Sequence[str]) -> bool:
    dev = DEVICE_COLS.get(table)
    return dev is not None and all(c in dev for c in cols)


def chunk_rows(count: int) -> int:
    """Rows generated at once: _LIVE_LANES temporaries a chunk row stay
    within DEVGEN_TEMP_LANES lanes of the whole range."""
    return max(_MIN_CHUNK_ROWS, count * DEVGEN_TEMP_LANES // _LIVE_LANES)


def device_lanes(
    table: str,
    cols: Sequence[str],
    lo: int,
    hi: int,
    sf: float,
    count: int,
    device,
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The lanes of `table`'s rows whose (order-)index lies in [lo, hi),
    made on `device`: {column: (values, all-true validity)} with exactly
    `count` rows (for lineitem the host-computed line count of those
    orders; a generator whose line count disagrees raises)."""
    device = torch.device(device)
    n = H._counts(sf)
    cols = list(cols)
    out = {c: torch.empty(count, dtype=_dtype(c), device=device) for c in cols}
    step = chunk_rows(count)
    if table == "lineitem":
        j = torch.arange(lo, hi, dtype=torch.int64, device=device)
        cum = torch.cumsum(_line_count(j), 0)  # lines of orders lo..lo+k
        del j
        total = int(cum[-1]) if hi > lo else 0
        if total != count:
            raise ValueError(
                f"lineitem orders [{lo}, {hi}) have {total} lines on the "
                f"device, {count} on the host"
            )
        for s in range(0, count, step):
            r = torch.arange(s, min(s + step, count), dtype=torch.int64, device=device)
            # order slot of each output row: first k with cum[k] > r
            slot = torch.searchsorted(cum, r, right=True)
            prev = torch.where(slot > 0, cum[torch.clamp(slot - 1, min=0)], 0)
            draws = _LineDraws(lo + slot, r - prev, n)
            del slot, prev
            for c in cols:
                out[c][s: s + r.shape[0]] = _lineitem(c, draws)
            del draws, r
    else:
        for s in range(0, count, step):
            idx = torch.arange(lo + s, lo + min(s + step, count), dtype=torch.int64,
                               device=device)
            for c in cols:
                out[c][s: s + idx.shape[0]] = _base_table(table, c, idx, n)
            del idx
    ok = torch.ones(count, dtype=torch.bool, device=device)
    return {c: (out[c], ok) for c in cols}


def lineitem_count(lo: int, hi: int) -> int:
    """Exact line rows for orders [lo, hi): host numpy (one hash per
    order, the JAX package's; the columns stay on the device)."""
    j = np.arange(lo, hi, dtype=np.int64)
    return int(
        (1 + (H.h64("l_count", j) % np.uint64(7)).astype(np.int64)).sum()
    )
