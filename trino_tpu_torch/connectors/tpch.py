"""TPC-H generator connector — deterministic, split-parallel, column-pruned.

Reference parity: plugin/trino-tpch (TpchConnectorFactory, TpchMetadata with
statistics, TpchSplitManager.java:40 nodes*splitsPerNode splits,
TpchRecordSetProvider/TpchPageSourceProvider streaming generated rows).

TPU-first redesign: instead of the reference's sequential per-row dbgen port,
every attribute is a pure function of (table, column, row-index) via
counter-based hashing (splitmix64 finalizer), fully vectorized in numpy.
Any split of any table therefore generates independently — the property the
reference gets from dbgen's per-split RNG seeking, but without sequential
state, so a TPU host can generate splits in parallel at HBM-feed rate.

dbgen invariants preserved (needed for realistic join fan-outs and the spec
queries' selectivities):
  - sparse orderkeys: 8 used of every 32       (reference OrderGenerator)
  - customers with custkey % 3 == 0 never buy  (CustomerGenerator)
  - p_retailprice is a formula of partkey       (PartGenerator)
  - l_extendedprice = quantity * retailprice(partkey)
  - lineitem (partkey,suppkey) always one of the part's 4 partsupp rows
    (selectToOrderSupplier formula)
  - returnflag/linestatus split around CURRENT_DATE = 1995-06-17
  - 1..7 lineitems per order, dates chained off o_orderdate

Low-cardinality strings are dictionary-encoded against fixed vocabularies;
high-cardinality strings (names, phones, comments) are generated only when
the query requests them (column pruning down the generator — the analog of
TpchPageSourceProvider's projected columns).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..page import Column, Page
from ..spi import (
    ColumnSchema,
    ColumnStatistics,
    Connector,
    ConnectorFactory,
    ConnectorMetadata,
    PageSource,
    PageSourceProvider,
    Split,
    SplitManager,
    TableSchema,
    TableStatistics,
)

M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _fnv(s: str) -> np.uint64:
    h = np.uint64(0xCBF29CE484222325)
    for ch in s.encode():
        h = np.uint64((int(h) ^ ch) * 0x100000001B3 & 0xFFFFFFFFFFFFFFFF)
    return h


def mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the counter-based RNG core."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & M64
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9) & M64
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB) & M64
    return x ^ (x >> np.uint64(31))


def h64(key: str, idx: np.ndarray, salt: int = 0) -> np.ndarray:
    """Deterministic uint64 per (key, index, salt)."""
    base = _fnv(key) ^ np.uint64(salt * 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF)
    return mix64(idx.astype(np.uint64) ^ base)


def uint_in(key: str, idx: np.ndarray, lo: int, hi: int, salt: int = 0) -> np.ndarray:
    """Uniform integer in [lo, hi] (inclusive)."""
    span = np.uint64(hi - lo + 1)
    return (h64(key, idx, salt) % span).astype(np.int64) + lo


# --- calendar ----------------------------------------------------------

EPOCH_1992 = 8035  # 1992-01-01 in days since 1970-01-01
ORDER_DATE_SPAN = 2406 - 151  # orderdate in [1992-01-01, 1998-08-02]
CURRENT_DATE = 9298  # 1995-06-17 (dbgen's CURRENTDATE)

# --- vocabularies (reference: io.trino.tpch.Distributions) -------------

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
RETURN_FLAGS = ["A", "N", "R"]
LINE_STATUS = ["F", "O"]
ORDER_STATUS = ["F", "O", "P"]
MFGRS = [f"Manufacturer#{i}" for i in range(1, 6)]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
P_TYPES = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]
CONT_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
CONTAINERS = [f"{a} {b}" for a in CONT_S1 for b in CONT_S2]

_COMMENT_WORDS = (
    "blithely bold carefully final regular ironic express silent pending "
    "furiously slyly quickly deposits accounts requests packages theodolites "
    "instructions foxes dependencies pinto beans asymptotes sauternes courts "
    "ideas platelets sleep nag haggle wake above according active against "
    "along among special excuses unusual customer complaints".split()
)


def _comment_vocab(n: int = 2048) -> np.ndarray:
    """Deterministic pool of comment phrases; includes the LIKE-targets of
    Q13 ('special ... requests') and Q16 ('Customer Complaints')."""
    rng = np.random.default_rng(0x7C4)
    out = []
    for i in range(n):
        k = 4 + int(rng.integers(0, 5))
        words = [
            _COMMENT_WORDS[int(rng.integers(0, len(_COMMENT_WORDS)))]
            for _ in range(k)
        ]
        out.append(" ".join(words))
    # guarantee the phrases probed by spec queries appear with ~1% weight
    for j in range(0, n, 97):
        out[j] = "special packages wake furiously requests"
    for j in range(53, n, 211):
        out[j] = "slyly bold Customer Complaints nag"
    return np.array(out, dtype=object)


COMMENTS = _comment_vocab()

# dbgen P_NAME color vocabulary (TPC-H spec 4.2.3 / dists.dss "colors"):
# p_name is 5 words drawn from this list, so predicates like
# p_name LIKE '%green%' (Q9) and LIKE 'forest%' (Q20) select realistic
# fractions instead of matching nothing
P_NAME_WORDS = (
    "almond antique aquamarine azure beige bisque black blanched blue "
    "blush brown burlywood burnished chartreuse chiffon chocolate coral "
    "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
    "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
    "hot indian ivory khaki lace lavender lawn lemon light lime linen "
    "magenta maroon medium metallic midnight mint misty moccasin navajo "
    "navy olive orange orchid pale papaya peach peru pink plum powder "
    "puff purple red rose rosy royal saddle salmon sandy seashell sienna "
    "sky slate smoke snow spring steel tan thistle tomato turquoise "
    "violet wheat white yellow"
).split()

DEC = T.decimal(12, 2)

SCHEMAS: Dict[str, List[Tuple[str, T.Type]]] = {
    "region": [
        ("r_regionkey", T.BIGINT),
        ("r_name", T.VARCHAR),
        ("r_comment", T.VARCHAR),
    ],
    "nation": [
        ("n_nationkey", T.BIGINT),
        ("n_name", T.VARCHAR),
        ("n_regionkey", T.BIGINT),
        ("n_comment", T.VARCHAR),
    ],
    "supplier": [
        ("s_suppkey", T.BIGINT),
        ("s_name", T.VARCHAR),
        ("s_address", T.VARCHAR),
        ("s_nationkey", T.BIGINT),
        ("s_phone", T.VARCHAR),
        ("s_acctbal", DEC),
        ("s_comment", T.VARCHAR),
    ],
    "customer": [
        ("c_custkey", T.BIGINT),
        ("c_name", T.VARCHAR),
        ("c_address", T.VARCHAR),
        ("c_nationkey", T.BIGINT),
        ("c_phone", T.VARCHAR),
        ("c_acctbal", DEC),
        ("c_mktsegment", T.VARCHAR),
        ("c_comment", T.VARCHAR),
    ],
    "part": [
        ("p_partkey", T.BIGINT),
        ("p_name", T.VARCHAR),
        ("p_mfgr", T.VARCHAR),
        ("p_brand", T.VARCHAR),
        ("p_type", T.VARCHAR),
        ("p_size", T.BIGINT),
        ("p_container", T.VARCHAR),
        ("p_retailprice", DEC),
        ("p_comment", T.VARCHAR),
    ],
    "partsupp": [
        ("ps_partkey", T.BIGINT),
        ("ps_suppkey", T.BIGINT),
        ("ps_availqty", T.BIGINT),
        ("ps_supplycost", DEC),
        ("ps_comment", T.VARCHAR),
    ],
    "orders": [
        ("o_orderkey", T.BIGINT),
        ("o_custkey", T.BIGINT),
        ("o_orderstatus", T.VARCHAR),
        ("o_totalprice", DEC),
        ("o_orderdate", T.DATE),
        ("o_orderpriority", T.VARCHAR),
        ("o_clerk", T.VARCHAR),
        ("o_shippriority", T.BIGINT),
        ("o_comment", T.VARCHAR),
    ],
    "lineitem": [
        ("l_orderkey", T.BIGINT),
        ("l_partkey", T.BIGINT),
        ("l_suppkey", T.BIGINT),
        ("l_linenumber", T.BIGINT),
        ("l_quantity", DEC),
        ("l_extendedprice", DEC),
        ("l_discount", DEC),
        ("l_tax", DEC),
        ("l_returnflag", T.VARCHAR),
        ("l_linestatus", T.VARCHAR),
        ("l_shipdate", T.DATE),
        ("l_commitdate", T.DATE),
        ("l_receiptdate", T.DATE),
        ("l_shipinstruct", T.VARCHAR),
        ("l_shipmode", T.VARCHAR),
        ("l_comment", T.VARCHAR),
    ],
}

# column name -> fixed vocabulary (shared dictionaries)
_VOCABS: Dict[str, np.ndarray] = {
    "r_name": np.array(REGIONS, dtype=object),
    "n_name": np.array([n for n, _ in NATIONS], dtype=object),
    "c_mktsegment": np.array(SEGMENTS, dtype=object),
    "o_orderpriority": np.array(PRIORITIES, dtype=object),
    "o_orderstatus": np.array(ORDER_STATUS, dtype=object),
    "l_shipinstruct": np.array(INSTRUCTIONS, dtype=object),
    "l_shipmode": np.array(MODES, dtype=object),
    "l_returnflag": np.array(RETURN_FLAGS, dtype=object),
    "l_linestatus": np.array(LINE_STATUS, dtype=object),
    "p_mfgr": np.array(MFGRS, dtype=object),
    "p_brand": np.array(BRANDS, dtype=object),
    "p_type": np.array(P_TYPES, dtype=object),
    "p_container": np.array(CONTAINERS, dtype=object),
    "r_comment": COMMENTS,
    "n_comment": COMMENTS,
    "s_comment": COMMENTS,
    "c_comment": COMMENTS,
    "p_comment": COMMENTS,
    "ps_comment": COMMENTS,
    "o_comment": COMMENTS,
    "l_comment": COMMENTS,
}


def _counts(sf: float) -> Dict[str, int]:
    return {
        "region": 5,
        "nation": 25,
        "supplier": max(1, int(10_000 * sf)),
        "customer": max(1, int(150_000 * sf)),
        "part": max(1, int(200_000 * sf)),
        "partsupp": 4 * max(1, int(200_000 * sf)),
        "orders": max(1, int(1_500_000 * sf)),
        # lineitem count is data-dependent (1..7 per order, avg 4)
        "lineitem": 4 * max(1, int(1_500_000 * sf)),
    }


def _orderkey(j: np.ndarray) -> np.ndarray:
    """Sparse order keys: 8 used out of every 32 (OrderGenerator.makeOrderKey)."""
    return (j // 8) * 32 + (j % 8) + 1


def _custkey_for_order(j: np.ndarray, ncust: int) -> np.ndarray:
    """Uniform over custkeys with key % 3 != 0 (dbgen skips every third)."""
    usable = ncust - ncust // 3
    i = (h64("o_custkey", j) % np.uint64(max(1, usable))).astype(np.int64)
    return 3 * (i // 2) + 1 + (i % 2)


def _retail_price_cents(partkey: np.ndarray) -> np.ndarray:
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def _ps_suppkey(partkey: np.ndarray, i, nsupp: int) -> np.ndarray:
    """The i-th (0..3) supplier of a part (PartSupplierGenerator formula)."""
    return (partkey + i * (nsupp // 4 + (partkey - 1) // nsupp)) % nsupp + 1


def _line_count(j: np.ndarray) -> np.ndarray:
    return 1 + (h64("l_count", j) % np.uint64(7)).astype(np.int64)


class _Gen:
    """Vectorized column generators for one (table, row-index-range)."""

    def __init__(self, sf: float):
        self.sf = sf
        self.n = _counts(sf)

    # -- small dimension tables ------------------------------------
    def region(self, idx, cols):
        out = {}
        for c in cols:
            if c == "r_regionkey":
                out[c] = idx.astype(np.int64)
            elif c == "r_name":
                out[c] = idx.astype(np.int32)
            elif c == "r_comment":
                out[c] = (h64(c, idx) % np.uint64(len(COMMENTS))).astype(np.int32)
        return out

    def nation(self, idx, cols):
        region_of = np.array([r for _, r in NATIONS], dtype=np.int64)
        out = {}
        for c in cols:
            if c == "n_nationkey":
                out[c] = idx.astype(np.int64)
            elif c == "n_name":
                out[c] = idx.astype(np.int32)
            elif c == "n_regionkey":
                out[c] = region_of[idx]
            elif c == "n_comment":
                out[c] = (h64(c, idx) % np.uint64(len(COMMENTS))).astype(np.int32)
        return out

    def supplier(self, idx, cols):
        key = idx.astype(np.int64) + 1
        out = {}
        for c in cols:
            if c == "s_suppkey":
                out[c] = key
            elif c == "s_nationkey":
                out[c] = uint_in(c, idx, 0, 24)
            elif c == "s_acctbal":
                out[c] = uint_in(c, idx, -99999, 999999)
            elif c == "s_name":
                out[c] = ("Supplier#", key)  # lazy formatted
            elif c == "s_address":
                out[c] = ("addr-s-", key)
            elif c == "s_phone":
                out[c] = ("phone", uint_in("s_nationkey", idx, 0, 24), h64(c, idx))
            elif c == "s_comment":
                out[c] = (h64(c, idx) % np.uint64(len(COMMENTS))).astype(np.int32)
        return out

    def customer(self, idx, cols):
        key = idx.astype(np.int64) + 1
        out = {}
        for c in cols:
            if c == "c_custkey":
                out[c] = key
            elif c == "c_nationkey":
                out[c] = uint_in(c, idx, 0, 24)
            elif c == "c_acctbal":
                out[c] = uint_in(c, idx, -99999, 999999)
            elif c == "c_mktsegment":
                out[c] = (h64(c, idx) % np.uint64(5)).astype(np.int32)
            elif c == "c_name":
                out[c] = ("Customer#", key)
            elif c == "c_address":
                out[c] = ("addr-c-", key)
            elif c == "c_phone":
                out[c] = ("phone", uint_in("c_nationkey", idx, 0, 24), h64(c, idx))
            elif c == "c_comment":
                out[c] = (h64(c, idx) % np.uint64(len(COMMENTS))).astype(np.int32)
        return out

    def part(self, idx, cols):
        key = idx.astype(np.int64) + 1
        out = {}
        for c in cols:
            if c == "p_partkey":
                out[c] = key
            elif c == "p_mfgr":
                # brand is within mfgr (Brand#MN where M = mfgr number)
                out[c] = (h64("p_mfgr", idx) % np.uint64(5)).astype(np.int32)
            elif c == "p_brand":
                m = (h64("p_mfgr", idx) % np.uint64(5)).astype(np.int64)
                b = (h64("p_brand", idx) % np.uint64(5)).astype(np.int64)
                out[c] = (m * 5 + b).astype(np.int32)
            elif c == "p_type":
                out[c] = (h64(c, idx) % np.uint64(len(P_TYPES))).astype(np.int32)
            elif c == "p_size":
                out[c] = uint_in(c, idx, 1, 50)
            elif c == "p_container":
                out[c] = (h64(c, idx) % np.uint64(len(CONTAINERS))).astype(np.int32)
            elif c == "p_retailprice":
                out[c] = _retail_price_cents(key)
            elif c == "p_name":
                out[c] = ("pname", key)
            elif c == "p_comment":
                out[c] = (h64(c, idx) % np.uint64(len(COMMENTS))).astype(np.int32)
        return out

    def partsupp(self, idx, cols):
        # row i -> (part p = i//4, supplier slot i%4)
        p = (idx // 4).astype(np.int64) + 1
        slot = (idx % 4).astype(np.int64)
        out = {}
        for c in cols:
            if c == "ps_partkey":
                out[c] = p
            elif c == "ps_suppkey":
                out[c] = _ps_suppkey(p, slot, self.n["supplier"])
            elif c == "ps_availqty":
                out[c] = uint_in(c, idx, 1, 9999)
            elif c == "ps_supplycost":
                out[c] = uint_in(c, idx, 100, 100000)
            elif c == "ps_comment":
                out[c] = (h64(c, idx) % np.uint64(len(COMMENTS))).astype(np.int32)
        return out

    def orders(self, idx, cols):
        j = idx.astype(np.int64)
        out = {}
        need_status = "o_orderstatus" in cols
        odate = EPOCH_1992 + uint_in("o_orderdate", j, 0, ORDER_DATE_SPAN - 1)
        for c in cols:
            if c == "o_orderkey":
                out[c] = _orderkey(j)
            elif c == "o_custkey":
                out[c] = _custkey_for_order(j, self.n["customer"])
            elif c == "o_orderdate":
                out[c] = odate.astype(np.int32)
            elif c == "o_totalprice":
                out[c] = uint_in(c, j, 100000, 50000000)
            elif c == "o_orderpriority":
                out[c] = (h64(c, j) % np.uint64(5)).astype(np.int32)
            elif c == "o_shippriority":
                out[c] = np.zeros(len(j), dtype=np.int64)
            elif c == "o_clerk":
                nclerk = max(1, int(1000 * self.sf))
                out[c] = ("Clerk#", uint_in(c, j, 1, nclerk))
            elif c == "o_comment":
                out[c] = (h64(c, j) % np.uint64(len(COMMENTS))).astype(np.int32)
        if need_status:
            # F if every line shipped on or before CURRENT_DATE, O if none
            # did, else P — computed from the same hashes lineitem uses
            counts = _line_count(j)
            all_f = np.ones(len(j), dtype=bool)
            all_o = np.ones(len(j), dtype=bool)
            for ln in range(7):
                has = counts > ln
                ship = odate + 1 + (
                    h64("l_shipdate", j * np.int64(8) + ln) % np.uint64(121)
                ).astype(np.int64)
                f = ship <= CURRENT_DATE
                all_f &= ~has | f
                all_o &= ~has | ~f
            status = np.where(all_f, 0, np.where(all_o, 1, 2)).astype(np.int32)
            out["o_orderstatus"] = status
        return out

    # -- lineitem (rows derived from order index space) -------------
    def lineitem_for_orders(self, j: np.ndarray, cols):
        counts = _line_count(j)
        total = int(counts.sum())
        oj = np.repeat(j, counts)  # order index per line row
        starts = np.cumsum(counts) - counts
        ln = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
        lid = oj * np.int64(8) + ln  # unique per-line counter
        out = {}
        odate = EPOCH_1992 + uint_in("o_orderdate", oj, 0, ORDER_DATE_SPAN - 1)
        ship = odate + 1 + (h64("l_shipdate", lid) % np.uint64(121)).astype(np.int64)
        npart = self.n["part"]
        partkey = 1 + (h64("l_partkey", lid) % np.uint64(npart)).astype(np.int64)
        qty = uint_in("l_quantity", lid, 1, 50)
        for c in cols:
            if c == "l_orderkey":
                out[c] = _orderkey(oj)
            elif c == "l_partkey":
                out[c] = partkey
            elif c == "l_suppkey":
                slot = (h64("l_supp_slot", lid) % np.uint64(4)).astype(np.int64)
                out[c] = _ps_suppkey(partkey, slot, self.n["supplier"])
            elif c == "l_linenumber":
                out[c] = ln + 1
            elif c == "l_quantity":
                out[c] = qty * 100  # decimal(12,2) integral quantities
            elif c == "l_extendedprice":
                out[c] = qty * _retail_price_cents(partkey)
            elif c == "l_discount":
                out[c] = uint_in(c, lid, 0, 10)
            elif c == "l_tax":
                out[c] = uint_in(c, lid, 0, 8)
            elif c == "l_shipdate":
                out[c] = ship.astype(np.int32)
            elif c == "l_commitdate":
                out[c] = (odate + uint_in(c, lid, 30, 90)).astype(np.int32)
            elif c == "l_receiptdate":
                out[c] = (ship + uint_in(c, lid, 1, 30)).astype(np.int32)
            elif c == "l_returnflag":
                receipt = ship + uint_in("l_receiptdate", lid, 1, 30)
                rnd = (h64(c, lid) % np.uint64(2)).astype(np.int32)  # A or R
                out[c] = np.where(receipt <= CURRENT_DATE, rnd * 2, 1).astype(
                    np.int32
                )  # codes: A=0,N=1,R=2
            elif c == "l_linestatus":
                out[c] = (ship > CURRENT_DATE).astype(np.int32)  # F=0, O=1
            elif c == "l_shipinstruct":
                out[c] = (h64(c, lid) % np.uint64(4)).astype(np.int32)
            elif c == "l_shipmode":
                out[c] = (h64(c, lid) % np.uint64(7)).astype(np.int32)
            elif c == "l_comment":
                out[c] = (h64(c, lid) % np.uint64(len(COMMENTS))).astype(np.int32)
        return out, total


def _format_lazy(spec, schema_type) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize a lazily-specified high-cardinality string column as
    (codes, dictionary).  Formatted-key specs (Supplier#N, phone) are
    distinct so codes are arange; pname DEDUPES its dictionary and
    remaps codes (names can repeat, and code equality must equal
    string equality)."""
    if spec[0] == "pname":
        _, keys = spec
        nw = np.uint64(len(P_NAME_WORDS))
        # 5 hash-chosen words per part (dbgen draws 5 distinct; hash draws
        # may rarely repeat a word within one name — selectivity of word
        # predicates is preserved to ~0.1%).  Names can collide across
        # parts (dbgen's do too), so the dictionary is DEDUPED and codes
        # remapped — code equality must equal string equality.
        picks = [
            (h64(f"p_name_{slot}", keys) % nw).astype(np.int64)
            for slot in range(5)
        ]
        W = P_NAME_WORDS
        index: dict = {}
        entries: list = []
        codes = np.empty(len(keys), dtype=np.int32)
        for i, (a, b, c, e, f) in enumerate(zip(*picks)):
            s = " ".join((W[a], W[b], W[c], W[e], W[f]))
            code = index.get(s)
            if code is None:
                code = len(entries)
                index[s] = code
                entries.append(s)
            codes[i] = code
        return codes, np.array(entries, dtype=object)
    elif spec[0] == "phone":
        _, cc, hh = spec
        n1 = (hh >> np.uint64(10)) % np.uint64(900) + np.uint64(100)
        n2 = (hh >> np.uint64(30)) % np.uint64(900) + np.uint64(100)
        n3 = (hh >> np.uint64(45)) % np.uint64(9000) + np.uint64(1000)
        d = np.array(
            [
                f"{10 + int(c)}-{int(a)}-{int(b)}-{int(x)}"
                for c, a, b, x in zip(cc, n1, n2, n3)
            ],
            dtype=object,
        )
    else:
        prefix, keys = spec
        if prefix.endswith("#"):
            d = np.array([f"{prefix}{int(k):09d}" for k in keys], dtype=object)
        else:
            d = np.array([f"{prefix}{int(k)}" for k in keys], dtype=object)
    codes = np.arange(len(d), dtype=np.int32)
    return codes, d


def generate(
    table: str,
    sf: float,
    split: int = 0,
    num_splits: int = 1,
    columns: Optional[Sequence[str]] = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], int]:
    """Generate one split of a table.

    Returns (values by column, dictionaries by column, row_count).
    Lineitem splits partition *order index space* so each split is
    self-contained (all lines of an order stay in one split).
    """
    schema = SCHEMAS[table]
    all_cols = [c for c, _ in schema]
    cols = list(columns) if columns is not None else all_cols
    for c in cols:
        if c not in all_cols:
            raise KeyError(f"{table}.{c}")
    g = _Gen(sf)
    base = "orders" if table == "lineitem" else table
    n = g.n[base]
    lo = (n * split) // num_splits
    hi = (n * (split + 1)) // num_splits
    idx = np.arange(lo, hi, dtype=np.int64)
    if table == "lineitem":
        # native (C++) fused generator when available; numpy fallback
        from . import native_gen

        native = native_gen.gen_lineitem(
            lo, hi, g.n["part"], g.n["supplier"], len(COMMENTS)
        )
        if native is not None:
            raw = {c: native[c] for c in cols}
            count = len(native["l_orderkey"])
        else:
            raw, count = g.lineitem_for_orders(idx, cols)
    else:
        raw = getattr(g, table)(idx, cols)
        count = hi - lo
    values: Dict[str, np.ndarray] = {}
    dicts: Dict[str, np.ndarray] = {}
    types = dict(schema)
    for c in cols:
        v = raw[c]
        if isinstance(v, tuple):  # lazy high-cardinality string
            codes, d = _format_lazy(v, types[c])
            values[c], dicts[c] = codes, d
        else:
            values[c] = v
            if types[c].is_dictionary:
                dicts[c] = _VOCABS[c]
    return values, dicts, count


def rows_to_pylist(table: str, sf: float, limit: int = 10) -> list:
    """Convenience for tests: first rows of a table as python tuples."""
    values, dicts, count = generate(table, sf)
    schema = SCHEMAS[table]
    page = Page(
        [
            Column(t, values[c][:limit], None, dicts.get(c))
            for c, t in schema
        ],
        min(limit, count),
        [c for c, _ in schema],
    )
    return page.to_pylist()


# --- SPI implementation ------------------------------------------------


class TpchMetadata(ConnectorMetadata):
    def __init__(self, sf: float):
        self.sf = sf

    def list_tables(self) -> List[str]:
        return list(SCHEMAS)

    def get_table_schema(self, table: str) -> TableSchema:
        return TableSchema(
            table, tuple(ColumnSchema(c, t) for c, t in SCHEMAS[table])
        )

    def get_table_statistics(self, table: str) -> TableStatistics:
        """Mirrors TpchMetadata's statistics support (plugin/trino-tpch
        .../statistics) — row counts and NDV estimates drive join ordering
        and unique-build-side detection.  Only true primary keys report
        distinct_count == row_count.  Cached per table: the memo
        optimizer reads these once per estimate across hundreds of
        alternatives (sf is fixed per connector)."""
        cache = getattr(self, "_stats_cache", None)
        if cache is None:
            cache = self._stats_cache = {}
        if table in cache:
            return cache[table]
        counts = _counts(self.sf)
        n = counts[table]
        pk = {
            "region": "r_regionkey", "nation": "n_nationkey",
            "supplier": "s_suppkey", "customer": "c_custkey",
            "part": "p_partkey", "orders": "o_orderkey",
        }.get(table)
        # FK cardinalities (approximate dbgen NDVs)
        fk_ndv = {
            "o_custkey": counts["customer"] * 2 / 3,
            "l_orderkey": float(counts["orders"]),
            "l_partkey": float(counts["part"]),
            "l_suppkey": float(counts["supplier"]),
            "ps_partkey": float(counts["part"]),
            "ps_suppkey": float(counts["supplier"]),
            "c_nationkey": 25.0,
            "s_nationkey": 25.0,
            "n_regionkey": 5.0,
        }
        # dbgen value-domain invariants (TPC-H spec 4.2.3: date windows,
        # quantity/discount/tax ranges; stored-scale for decimal lanes) —
        # range selectivities for the CBO (FilterStatsCalculator inputs)
        okey_max = float(_orderkey(np.array([counts["orders"] - 1]))[0]) + 7
        ranges = {
            "o_orderdate": (8035.0, 10440.0),   # 1992-01-01..1998-08-02
            "l_shipdate": (8036.0, 10561.0),    # orderdate+1..121
            "l_commitdate": (8065.0, 10530.0),  # orderdate+30..90
            "l_receiptdate": (8037.0, 10591.0),  # shipdate+1..30
            "l_quantity": (100.0, 5000.0),      # 1..50 (x100 lanes)
            # qty x retail price cents: [1x90000, 50x209900] — the
            # megakernel's interval proofs need this bound
            "l_extendedprice": (90000.0, 10495000.0),
            "l_discount": (0.0, 10.0),          # 0.00..0.10 (x100)
            "l_tax": (0.0, 8.0),                # 0.00..0.08 (x100)
            "l_linenumber": (1.0, 7.0),
            "o_orderkey": (1.0, okey_max),
            "l_orderkey": (1.0, okey_max),
            "o_custkey": (1.0, float(counts["customer"])),
            "c_custkey": (1.0, float(counts["customer"])),
            "p_partkey": (1.0, float(counts["part"])),
            "l_partkey": (1.0, float(counts["part"])),
            "ps_partkey": (1.0, float(counts["part"])),
            "s_suppkey": (1.0, float(counts["supplier"])),
            "l_suppkey": (1.0, float(counts["supplier"])),
            "ps_suppkey": (1.0, float(counts["supplier"])),
            "n_nationkey": (0.0, 24.0),
            "c_nationkey": (0.0, 24.0),
            "s_nationkey": (0.0, 24.0),
            "r_regionkey": (0.0, 4.0),
            "n_regionkey": (0.0, 4.0),
        }
        cols: Dict[str, ColumnStatistics] = {}
        for c, t in SCHEMAS[table]:
            lo, hi = ranges.get(c, (None, None))
            if c == pk:
                cols[c] = ColumnStatistics(
                    distinct_count=float(n), min_value=lo, max_value=hi
                )
            elif c in fk_ndv:
                cols[c] = ColumnStatistics(
                    distinct_count=min(fk_ndv[c], n),
                    min_value=lo, max_value=hi,
                )
            elif t.is_dictionary and c in _VOCABS:
                cols[c] = ColumnStatistics(
                    distinct_count=float(len(_VOCABS[c]))
                )
            elif lo is not None:
                cols[c] = ColumnStatistics(
                    min_value=lo, max_value=hi,
                    decimal_lanes=bool(getattr(t, "is_decimal", False)),
                )
        cache[table] = TableStatistics(float(n), cols)
        return cache[table]


class TpchSplitManager(SplitManager):
    """Reference: TpchSplitManager.java:40 — nodes x splitsPerNode."""

    def __init__(self, sf: float, connector=None):
        self.sf = sf
        self.connector = connector

    def get_splits(self, table: str, desired: int, constraint=None) -> List[Split]:
        n = _counts(self.sf)["orders" if table == "lineitem" else table]
        # honor the engine's desired parallelism down to rows-per-split
        # granularity so multi-node tests exercise real split distribution
        # at tiny SF (SET SESSION <catalog>.rows-per-split overrides)
        rows = 512
        if self.connector is not None:
            rows = int(
                self.connector.get_session_property("rows_per_split")
            )
        k = max(1, min(desired, (n + rows - 1) // rows))
        return [Split(table, i, k, {"sf": self.sf}) for i in range(k)]


class TpchPageSource(PageSource):
    def __init__(self, sf, split: Split, columns: Sequence[str]):
        self.sf = sf
        self.split = split
        self.columns = list(columns)
        self._dicts: Dict[str, np.ndarray] = {}

    def pages(self):
        values, dicts, count = generate(
            self.split.table, self.sf, self.split.ordinal, self.split.total,
            self.columns,
        )
        self._dicts = dicts
        types = dict(SCHEMAS[self.split.table])
        cols = [
            Column(types[c], values[c], None, dicts.get(c)) for c in self.columns
        ]
        yield Page(cols, count, self.columns)

    def dictionaries(self) -> Dict[str, np.ndarray]:
        # fixed vocabularies are known before generation; lazy (per-split)
        # dictionaries only after pages() ran
        types = dict(SCHEMAS[self.split.table])
        out = dict(self._dicts)
        for c in self.columns:
            if types[c].is_dictionary and c in _VOCABS and c not in out:
                out[c] = _VOCABS[c]
        return out


class TpchPageSourceProvider(PageSourceProvider):
    def __init__(self, sf: float):
        self.sf = sf

    def create_page_source(self, split: Split, columns) -> TpchPageSource:
        return TpchPageSource(self.sf, split, columns)


class TpchConnector(Connector):
    def __init__(self, name: str, sf: float):
        self.name = name
        self.sf = sf

    def metadata(self):
        return TpchMetadata(self.sf)

    def split_manager(self):
        return TpchSplitManager(self.sf, self)

    def session_property_metadata(self):
        from ..config import PropertyMetadata

        return {
            "rows_per_split": PropertyMetadata(
                "rows_per_split",
                "split granularity for the generator connector",
                int, 512,
            ),
        }

    def page_source_provider(self):
        return TpchPageSourceProvider(self.sf)

    def device_generation(self, table: str, cols, splits) -> Optional[dict]:
        """On-device generation spec for a set of splits, or None when any
        requested column needs host formatting (connectors/tpch_device.py,
        the in-process row generation of TpchPageSourceProvider made on
        the device).  Splits that are not contiguous (a worker's
        round-robin share) generate one range per contiguous run, in
        split order: ``ranges`` is [(lo, hi, count)].  Its dictionaries
        are the host path's vocabularies."""
        from . import tpch_device

        if not splits or not tpch_device.supports(table, cols):
            return None
        tot = splits[0].total
        if any(s.total != tot for s in splits):
            return None
        ords = sorted(s.ordinal for s in splits)
        runs = []
        for o in ords:
            if runs and runs[-1][1] == o:
                runs[-1][1] = o + 1
            else:
                runs.append([o, o + 1])
        base = "orders" if table == "lineitem" else table
        nb = _counts(self.sf)[base]
        ranges = []
        for a, b in runs:
            lo, hi = (nb * a) // tot, (nb * b) // tot
            n = tpch_device.lineitem_count(lo, hi) if table == "lineitem" else hi - lo
            ranges.append((lo, hi, n))
        types = dict(SCHEMAS[table])
        dicts = {
            c: _VOCABS[c]
            for c in cols
            if types[c].is_dictionary and c in _VOCABS
        }
        widths = {c: 4 if types[c].is_dictionary or types[c].name == "date"
                  else 8 for c in cols}
        return {
            "table": table, "ranges": ranges, "sf": self.sf,
            "count": sum(n for _lo, _hi, n in ranges),
            "dicts": dicts, "widths": widths,
        }


class TpchConnectorFactory(ConnectorFactory):
    """Reference: TpchConnectorFactory — config key tpch.scale-factor."""

    name = "tpch"

    def create(self, catalog_name: str, config: dict) -> TpchConnector:
        sf = float(config.get("tpch.scale-factor", 0.01))
        return TpchConnector(catalog_name, sf)
