"""TPC-DS generator connector (subset).

Counterpart of trino_tpu/connectors/tpcds.py: the port's own copy, so
nothing of the JAX package is imported; the hashing helpers come from the
port's connectors/tpch.py.  Every table generates the same arrays,
validity and dictionaries as the JAX package's.  Reference parity:
plugin/trino-tpcds (TpcdsConnectorFactory, TpcdsMetadata,
TpcdsSplitManager/TpcdsRecordSetProvider over io.trino.tpcds dsdgen).

Same counter-based (splitmix64) design as the tpch connector: every
attribute is a pure function of (table, column, row index), vectorized in
numpy; splits generate independently.  Covers the star-schema tables used
by the benchmark configs (TPC-DS Q3/Q7) and common derived queries:
store_sales + date_dim, item, customer_demographics, promotion, store.

Unlike TPC-H, TPC-DS fact-table foreign keys are nullable (~4%), which
exercises the engine's null-key join semantics.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
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
from .tpch import h64, mix64, uint_in

DEC = T.decimal(7, 2)

GENDERS = ["M", "F"]
MARITAL = ["M", "S", "D", "W", "U"]
EDUCATION = [
    "Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
    "Advanced Degree", "Unknown",
]
CATEGORIES = [
    "Books", "Children", "Electronics", "Home", "Jewelry", "Men",
    "Music", "Shoes", "Sports", "Women",
]
CLASSES = [f"class#{i}" for i in range(1, 17)]
YN = ["N", "Y"]

DATE_DIM_ROWS = 73049  # 1900-01-02 .. 2100-01-01 (dsdgen fixed)
DATE_SK_BASE = 2415022  # julian day of 1900-01-02
EPOCH_OFFSET = -25567  # days from 1970-01-01 back to 1900-01-02


def _counts(sf: float) -> Dict[str, int]:
    """dsdgen cardinalities (TPC-DS spec table 3-2): facts scale
    linearly, dimensions by ~sf^(1/2..2/3), several are fixed."""
    dim = max(1.0, sf) ** 0.5
    return {
        "date_dim": DATE_DIM_ROWS,
        "time_dim": 86_400,
        "item": max(10, int(18_000 * dim)),
        "store": max(2, int(12 * dim)),
        "promotion": max(5, int(300 * dim)),
        "warehouse": max(1, int(5 * dim)),
        "ship_mode": 20,
        "reason": max(5, int(35 * dim)),
        "income_band": 20,
        "household_demographics": 7_200,
        "customer_demographics": 1_920_800 if sf >= 0.1 else 19_208,
        "customer": max(
            100,
            int(100_000 * (sf ** (2.0 / 3.0) if sf >= 1 else sf)),
        ),
        "customer_address": max(
            50,
            int(50_000 * (sf ** (2.0 / 3.0) if sf >= 1 else sf)),
        ),
        "store_sales": max(10, int(2_880_404 * sf)),
        "catalog_sales": max(10, int(1_441_548 * sf)),
        "web_sales": max(10, int(719_384 * sf)),
    }


SCHEMAS: Dict[str, List[Tuple[str, T.Type]]] = {
    "date_dim": [
        ("d_date_sk", T.BIGINT),
        ("d_date", T.DATE),
        ("d_year", T.BIGINT),
        ("d_moy", T.BIGINT),
        ("d_dom", T.BIGINT),
        ("d_qoy", T.BIGINT),
    ],
    "item": [
        ("i_item_sk", T.BIGINT),
        ("i_item_id", T.VARCHAR),
        ("i_brand_id", T.BIGINT),
        ("i_brand", T.VARCHAR),
        ("i_manufact_id", T.BIGINT),
        ("i_manager_id", T.BIGINT),
        ("i_category_id", T.BIGINT),
        ("i_category", T.VARCHAR),
        ("i_class_id", T.BIGINT),
        ("i_class", T.VARCHAR),
        ("i_current_price", DEC),
    ],
    "store": [
        ("s_store_sk", T.BIGINT),
        ("s_store_id", T.VARCHAR),
        ("s_store_name", T.VARCHAR),
        ("s_number_employees", T.BIGINT),
        ("s_city", T.VARCHAR),
        ("s_county", T.VARCHAR),
        ("s_state", T.VARCHAR),
        ("s_gmt_offset", T.decimal(5, 2)),
    ],
    "promotion": [
        ("p_promo_sk", T.BIGINT),
        ("p_promo_id", T.VARCHAR),
        ("p_channel_email", T.VARCHAR),
        ("p_channel_event", T.VARCHAR),
    ],
    "customer_demographics": [
        ("cd_demo_sk", T.BIGINT),
        ("cd_gender", T.VARCHAR),
        ("cd_marital_status", T.VARCHAR),
        ("cd_education_status", T.VARCHAR),
    ],
    "store_sales": [
        ("ss_sold_date_sk", T.BIGINT),
        ("ss_sold_time_sk", T.BIGINT),
        ("ss_item_sk", T.BIGINT),
        ("ss_customer_sk", T.BIGINT),
        ("ss_cdemo_sk", T.BIGINT),
        ("ss_hdemo_sk", T.BIGINT),
        ("ss_addr_sk", T.BIGINT),
        ("ss_store_sk", T.BIGINT),
        ("ss_promo_sk", T.BIGINT),
        ("ss_ticket_number", T.BIGINT),
        ("ss_quantity", T.BIGINT),
        ("ss_wholesale_cost", DEC),
        ("ss_list_price", DEC),
        ("ss_sales_price", DEC),
        ("ss_ext_sales_price", DEC),
        ("ss_ext_discount_amt", DEC),
        ("ss_ext_wholesale_cost", DEC),
        ("ss_ext_list_price", DEC),
        ("ss_coupon_amt", DEC),
        ("ss_net_paid", DEC),
        ("ss_net_profit", DEC),
    ],
    "catalog_sales": [
        ("cs_sold_date_sk", T.BIGINT),
        ("cs_sold_time_sk", T.BIGINT),
        ("cs_ship_date_sk", T.BIGINT),
        ("cs_bill_customer_sk", T.BIGINT),
        ("cs_bill_cdemo_sk", T.BIGINT),
        ("cs_bill_hdemo_sk", T.BIGINT),
        ("cs_bill_addr_sk", T.BIGINT),
        ("cs_ship_mode_sk", T.BIGINT),
        ("cs_warehouse_sk", T.BIGINT),
        ("cs_item_sk", T.BIGINT),
        ("cs_promo_sk", T.BIGINT),
        ("cs_order_number", T.BIGINT),
        ("cs_quantity", T.BIGINT),
        ("cs_wholesale_cost", DEC),
        ("cs_list_price", DEC),
        ("cs_sales_price", DEC),
        ("cs_ext_sales_price", DEC),
        ("cs_ext_discount_amt", DEC),
        ("cs_coupon_amt", DEC),
        ("cs_net_paid", DEC),
        ("cs_net_profit", DEC),
    ],
    "web_sales": [
        ("ws_sold_date_sk", T.BIGINT),
        ("ws_sold_time_sk", T.BIGINT),
        ("ws_ship_date_sk", T.BIGINT),
        ("ws_item_sk", T.BIGINT),
        ("ws_bill_customer_sk", T.BIGINT),
        ("ws_bill_cdemo_sk", T.BIGINT),
        ("ws_bill_hdemo_sk", T.BIGINT),
        ("ws_bill_addr_sk", T.BIGINT),
        ("ws_web_page_sk", T.BIGINT),
        ("ws_warehouse_sk", T.BIGINT),
        ("ws_promo_sk", T.BIGINT),
        ("ws_order_number", T.BIGINT),
        ("ws_quantity", T.BIGINT),
        ("ws_wholesale_cost", DEC),
        ("ws_list_price", DEC),
        ("ws_sales_price", DEC),
        ("ws_ext_sales_price", DEC),
        ("ws_ext_discount_amt", DEC),
        ("ws_coupon_amt", DEC),
        ("ws_net_paid", DEC),
        ("ws_net_profit", DEC),
    ],
    "customer": [
        ("c_customer_sk", T.BIGINT),
        ("c_customer_id", T.VARCHAR),
        ("c_current_cdemo_sk", T.BIGINT),
        ("c_current_hdemo_sk", T.BIGINT),
        ("c_current_addr_sk", T.BIGINT),
        ("c_first_name", T.VARCHAR),
        ("c_last_name", T.VARCHAR),
        ("c_preferred_cust_flag", T.VARCHAR),
        ("c_birth_year", T.BIGINT),
        ("c_birth_month", T.BIGINT),
        ("c_birth_country", T.VARCHAR),
        ("c_email_address", T.VARCHAR),
        ("c_first_sales_date_sk", T.BIGINT),
        ("c_first_shipto_date_sk", T.BIGINT),
    ],
    "customer_address": [
        ("ca_address_sk", T.BIGINT),
        ("ca_address_id", T.VARCHAR),
        ("ca_street_number", T.VARCHAR),
        ("ca_city", T.VARCHAR),
        ("ca_county", T.VARCHAR),
        ("ca_state", T.VARCHAR),
        ("ca_zip", T.VARCHAR),
        ("ca_country", T.VARCHAR),
        ("ca_gmt_offset", T.decimal(5, 2)),
        ("ca_location_type", T.VARCHAR),
    ],
    "household_demographics": [
        ("hd_demo_sk", T.BIGINT),
        ("hd_income_band_sk", T.BIGINT),
        ("hd_buy_potential", T.VARCHAR),
        ("hd_dep_count", T.BIGINT),
        ("hd_vehicle_count", T.BIGINT),
    ],
    "time_dim": [
        ("t_time_sk", T.BIGINT),
        ("t_time_id", T.VARCHAR),
        ("t_time", T.BIGINT),
        ("t_hour", T.BIGINT),
        ("t_minute", T.BIGINT),
        ("t_second", T.BIGINT),
        ("t_am_pm", T.VARCHAR),
        ("t_meal_time", T.VARCHAR),
    ],
    "warehouse": [
        ("w_warehouse_sk", T.BIGINT),
        ("w_warehouse_name", T.VARCHAR),
        ("w_warehouse_sq_ft", T.BIGINT),
        ("w_city", T.VARCHAR),
        ("w_state", T.VARCHAR),
        ("w_country", T.VARCHAR),
    ],
    "ship_mode": [
        ("sm_ship_mode_sk", T.BIGINT),
        ("sm_ship_mode_id", T.VARCHAR),
        ("sm_type", T.VARCHAR),
        ("sm_carrier", T.VARCHAR),
    ],
    "reason": [
        ("r_reason_sk", T.BIGINT),
        ("r_reason_id", T.VARCHAR),
        ("r_reason_desc", T.VARCHAR),
    ],
    "income_band": [
        ("ib_income_band_sk", T.BIGINT),
        ("ib_lower_bound", T.BIGINT),
        ("ib_upper_bound", T.BIGINT),
    ],
}

# dsdgen value domains for the columns the benchmark queries test
# (TPC-DS spec appendix: cities/buy-potential/meal-times are the
# highest-frequency dsdgen values the published queries filter on)
BUY_POTENTIAL = [
    "0-500", "501-1000", "1001-5000", "5001-10000", ">10000", "Unknown",
]
CITIES = [
    "Midway", "Fairview", "Oak Grove", "Five Points", "Oakland",
    "Riverside", "Sunnyside", "Bethel", "Pleasant Hill", "Centerville",
    "Liberty", "Salem", "Union", "Greenville", "Franklin", "Springdale",
    "Glendale", "Marion", "Highland", "Antioch",
]
STATES = [
    "AL", "AK", "AZ", "AR", "CA", "CO", "CT", "DE", "FL", "GA", "HI",
    "ID", "IL", "IN", "IA", "KS", "KY", "LA", "ME", "MD", "MA", "MI",
    "MN", "MS", "MO", "MT", "NE", "NV", "NH", "NJ", "NM", "NY", "NC",
    "ND", "OH", "OK", "OR", "PA", "RI", "SC", "SD", "TN", "TX", "UT",
    "VT", "VA", "WA", "WV", "WI", "WY",
]
COUNTRIES = [
    "United States", "Canada", "Mexico", "Germany", "France", "Japan",
    "United Kingdom", "Brazil", "India", "China",
]
FIRST_NAMES = [
    "James", "Mary", "John", "Patricia", "Robert", "Jennifer",
    "Michael", "Linda", "William", "Elizabeth", "David", "Barbara",
    "Richard", "Susan", "Joseph", "Jessica", "Thomas", "Sarah",
]
LAST_NAMES = [
    "Smith", "Johnson", "Williams", "Brown", "Jones", "Garcia",
    "Miller", "Davis", "Rodriguez", "Martinez", "Hernandez", "Lopez",
    "Gonzalez", "Wilson", "Anderson", "Thomas", "Taylor", "Moore",
]
MEALS = ["breakfast", "lunch", "dinner"]
AMPM = ["AM", "PM"]
SHIP_TYPES = ["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR", "TWO DAY"]
CARRIERS = [
    "UPS", "FEDEX", "AIRBORNE", "USPS", "DHL", "TBS", "ZHOU", "MSC",
    "LATVIAN", "ALLIANCE", "ORIENTAL", "BARIAN", "BOXBUNDLES", "ZOUROS",
    "GERMA", "DIAMOND", "RUPEKSA", "GREAT EASTERN", "HARMSTORF", "PRIVATECARRIER",
]

_VOCABS = {
    "cd_gender": np.array(GENDERS, dtype=object),
    "cd_marital_status": np.array(MARITAL, dtype=object),
    "cd_education_status": np.array(EDUCATION, dtype=object),
    "i_category": np.array(CATEGORIES, dtype=object),
    "i_class": np.array(CLASSES, dtype=object),
    "p_channel_email": np.array(YN, dtype=object),
    "p_channel_event": np.array(YN, dtype=object),
    "hd_buy_potential": np.array(BUY_POTENTIAL, dtype=object),
    "ca_city": np.array(CITIES, dtype=object),
    "ca_state": np.array(STATES, dtype=object),
    "ca_country": np.array(COUNTRIES[:1], dtype=object),
    "c_birth_country": np.array(COUNTRIES, dtype=object),
    "c_first_name": np.array(FIRST_NAMES, dtype=object),
    "c_last_name": np.array(LAST_NAMES, dtype=object),
    "c_preferred_cust_flag": np.array(YN, dtype=object),
    "t_am_pm": np.array(AMPM, dtype=object),
    "t_meal_time": np.array(MEALS, dtype=object),
    "sm_type": np.array(SHIP_TYPES, dtype=object),
    "sm_carrier": np.array(CARRIERS, dtype=object),
    "w_state": np.array(STATES, dtype=object),
    "w_country": np.array(COUNTRIES[:1], dtype=object),
    "ca_location_type": np.array(
        ["apartment", "condo", "single family"], dtype=object
    ),
}

BRANDS = np.array(
    [f"brand#{i}" for i in range(1, 1001)], dtype=object
)


def _id_dict(keys, fmt="AAAAAAAA{:08X}"):
    """(codes, dictionary) for a per-row business-key string column."""
    d = np.array([fmt.format(int(k)) for k in keys], dtype=object)
    return np.arange(len(d), dtype=np.int32), d


def _vocab_codes(key: str, idx, vocab_name: str):
    """(codes, dictionary) drawn uniformly from a shared vocabulary."""
    vocab = _VOCABS[vocab_name]
    return (
        (h64(key, idx) % np.uint64(len(vocab))).astype(np.int32), vocab
    )


_GMT_OFFSETS = np.array([-500, -600, -700, -800, -1000])


def _gmt_offset(key: str, idx):
    """Scaled decimal(5,2) US GMT offsets -5..-8 (plus -10 HI)."""
    return _GMT_OFFSETS[(h64(key, idx) % np.uint64(5)).astype(np.int64)]


def _county_codes(key: str, idx):
    return (h64(key, idx) % np.uint64(120)).astype(np.int32), _COUNTIES


def _nullable(key: str, idx, values, frac_pct: int = 4):
    """~frac% NULL foreign keys (dsdgen's nullable FK behavior)."""
    nulls = (h64(key + "$null", idx) % np.uint64(100)).astype(np.int64) < frac_pct
    return values, ~nulls


def generate(
    table: str,
    sf: float,
    split: int = 0,
    num_splits: int = 1,
    columns: Optional[Sequence[str]] = None,
):
    schema = SCHEMAS[table]
    all_cols = [c for c, _ in schema]
    cols = list(columns) if columns is not None else all_cols
    counts = _counts(sf)
    n = counts[table]
    lo = (n * split) // num_splits
    hi = (n * (split + 1)) // num_splits
    idx = np.arange(lo, hi, dtype=np.int64)
    values: Dict[str, np.ndarray] = {}
    validity: Dict[str, np.ndarray] = {}
    dicts: Dict[str, np.ndarray] = {}

    if table == "date_dim":
        days = idx + EPOCH_OFFSET  # days since 1970-01-01
        # derive civil fields host-side (vectorized numpy datetime)
        dates = np.datetime64("1970-01-01") + days
        years = dates.astype("datetime64[Y]").astype(int) + 1970
        months = dates.astype("datetime64[M]").astype(int) % 12 + 1
        doms = (dates - dates.astype("datetime64[M]")).astype(int) + 1
        for c in cols:
            if c == "d_date_sk":
                values[c] = idx + DATE_SK_BASE
            elif c == "d_date":
                values[c] = days.astype(np.int32)
            elif c == "d_year":
                values[c] = years.astype(np.int64)
            elif c == "d_moy":
                values[c] = months.astype(np.int64)
            elif c == "d_dom":
                values[c] = doms.astype(np.int64)
            elif c == "d_qoy":
                values[c] = ((months - 1) // 3 + 1).astype(np.int64)
    elif table == "item":
        for c in cols:
            if c == "i_item_sk":
                values[c] = idx + 1
            elif c == "i_item_id":
                d = np.array(
                    [f"AAAAAAAA{int(k):08d}" for k in idx + 1], dtype=object
                )
                values[c] = np.arange(len(d), dtype=np.int32)
                dicts[c] = d
            elif c == "i_brand_id":
                values[c] = uint_in(c, idx, 1, 1000)
            elif c == "i_brand":
                values[c] = (uint_in("i_brand_id", idx, 1, 1000) - 1).astype(np.int32)
                dicts[c] = BRANDS
            elif c == "i_manufact_id":
                values[c] = uint_in(c, idx, 1, 1000)
            elif c == "i_manager_id":
                values[c] = uint_in(c, idx, 1, 100)
            elif c == "i_category_id":
                values[c] = uint_in(c, idx, 1, 10)
            elif c == "i_category":
                values[c] = (uint_in("i_category_id", idx, 1, 10) - 1).astype(np.int32)
                dicts[c] = _VOCABS["i_category"]
            elif c == "i_class_id":
                values[c] = uint_in(c, idx, 1, 16)
            elif c == "i_class":
                values[c] = (uint_in("i_class_id", idx, 1, 16) - 1).astype(np.int32)
                dicts[c] = _VOCABS["i_class"]
            elif c == "i_current_price":
                values[c] = uint_in(c, idx, 100, 9999)
    elif table == "store":
        for c in cols:
            if c == "s_store_sk":
                values[c] = idx + 1
            elif c == "s_store_id":
                d = np.array([f"S{int(k):08d}" for k in idx + 1], dtype=object)
                values[c] = np.arange(len(d), dtype=np.int32)
                dicts[c] = d
            elif c == "s_store_name":
                d = np.array([f"store {int(k)}" for k in idx + 1], dtype=object)
                values[c] = np.arange(len(d), dtype=np.int32)
                dicts[c] = d
            elif c == "s_number_employees":
                values[c] = uint_in(c, idx, 200, 300)
            elif c == "s_city":
                values[c], dicts[c] = _vocab_codes(c, idx, "ca_city")
            elif c == "s_county":
                values[c], dicts[c] = _county_codes(c, idx)
            elif c == "s_state":
                values[c], dicts[c] = _vocab_codes(c, idx, "ca_state")
            elif c == "s_gmt_offset":
                values[c] = _gmt_offset(c, idx)
    elif table == "promotion":
        for c in cols:
            if c == "p_promo_sk":
                values[c] = idx + 1
            elif c == "p_promo_id":
                d = np.array([f"P{int(k):08d}" for k in idx + 1], dtype=object)
                values[c] = np.arange(len(d), dtype=np.int32)
                dicts[c] = d
            elif c in ("p_channel_email", "p_channel_event"):
                values[c] = (h64(c, idx) % np.uint64(2)).astype(np.int32)
                dicts[c] = _VOCABS[c]
    elif table == "customer_demographics":
        # index decomposes into the demographics cross product
        for c in cols:
            if c == "cd_demo_sk":
                values[c] = idx + 1
            elif c == "cd_gender":
                values[c] = (idx % 2).astype(np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "cd_marital_status":
                values[c] = ((idx // 2) % 5).astype(np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "cd_education_status":
                values[c] = ((idx // 10) % 7).astype(np.int32)
                dicts[c] = _VOCABS[c]
    elif table in ("store_sales", "catalog_sales", "web_sales"):
        _gen_sales(table, idx, cols, counts, values, validity, dicts)
    elif table == "customer":
        for c in cols:
            if c == "c_customer_sk":
                values[c] = idx + 1
            elif c == "c_customer_id":
                values[c], dicts[c] = _id_dict(idx + 1)
            elif c == "c_current_cdemo_sk":
                v = 1 + (
                    h64(c, idx) % np.uint64(counts["customer_demographics"])
                ).astype(np.int64)
                values[c], validity[c] = _nullable(c, idx, v)
            elif c == "c_current_hdemo_sk":
                v = 1 + (
                    h64(c, idx) % np.uint64(counts["household_demographics"])
                ).astype(np.int64)
                values[c], validity[c] = _nullable(c, idx, v)
            elif c == "c_current_addr_sk":
                values[c] = 1 + (
                    h64(c, idx) % np.uint64(counts["customer_address"])
                ).astype(np.int64)
            elif c == "c_first_name":
                values[c] = (
                    h64(c, idx) % np.uint64(len(FIRST_NAMES))
                ).astype(np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "c_last_name":
                values[c] = (
                    h64(c, idx) % np.uint64(len(LAST_NAMES))
                ).astype(np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "c_preferred_cust_flag":
                values[c] = (h64(c, idx) % np.uint64(2)).astype(np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "c_birth_year":
                values[c] = uint_in(c, idx, 1924, 1992)
            elif c == "c_birth_month":
                values[c] = uint_in(c, idx, 1, 12)
            elif c == "c_birth_country":
                values[c] = (
                    h64(c, idx) % np.uint64(len(COUNTRIES))
                ).astype(np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "c_email_address":
                d = np.array(
                    [f"c{int(k)}@example.com" for k in idx + 1], dtype=object
                )
                values[c] = np.arange(len(d), dtype=np.int32)
                dicts[c] = d
            elif c in ("c_first_sales_date_sk", "c_first_shipto_date_sk"):
                v = DATE_SK_BASE + _SALES_DATE_LO + (
                    h64(c, idx) % np.uint64(_SALES_NDATES)
                ).astype(np.int64)
                values[c], validity[c] = _nullable(c, idx, v)
    elif table == "customer_address":
        for c in cols:
            if c == "ca_address_sk":
                values[c] = idx + 1
            elif c == "ca_address_id":
                values[c], dicts[c] = _id_dict(idx + 1)
            elif c == "ca_street_number":
                d = np.array(
                    [str(int(k)) for k in h64(c, idx) % np.uint64(1000)],
                    dtype=object,
                )
                values[c] = np.arange(len(d), dtype=np.int32)
                dicts[c] = d
            elif c == "ca_city":
                values[c], dicts[c] = _vocab_codes(c, idx, "ca_city")
            elif c == "ca_county":
                values[c], dicts[c] = _county_codes(c, idx)
            elif c == "ca_state":
                values[c], dicts[c] = _vocab_codes(c, idx, "ca_state")
            elif c == "ca_zip":
                d = np.array(
                    [f"{int(k):05d}" for k in h64(c, idx) % np.uint64(100000)],
                    dtype=object,
                )
                values[c] = np.arange(len(d), dtype=np.int32)
                dicts[c] = d
            elif c == "ca_country":
                values[c] = np.zeros(len(idx), dtype=np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "ca_gmt_offset":
                values[c] = _gmt_offset(c, idx)
            elif c == "ca_location_type":
                values[c] = (h64(c, idx) % np.uint64(3)).astype(np.int32)
                dicts[c] = _VOCABS[c]
    elif table == "household_demographics":
        # 7200 = income_band(20) x buy_potential(6) x dep(10) x vehicle(6)
        for c in cols:
            if c == "hd_demo_sk":
                values[c] = idx + 1
            elif c == "hd_income_band_sk":
                values[c] = (idx % 20) + 1
            elif c == "hd_buy_potential":
                values[c] = ((idx // 20) % 6).astype(np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "hd_dep_count":
                values[c] = (idx // 120) % 10
            elif c == "hd_vehicle_count":
                values[c] = ((idx // 1200) % 6) - 1
    elif table == "time_dim":
        hours = idx // 3600
        for c in cols:
            if c == "t_time_sk":
                values[c] = idx
            elif c == "t_time_id":
                values[c], dicts[c] = _id_dict(idx)
            elif c == "t_time":
                values[c] = idx
            elif c == "t_hour":
                values[c] = hours
            elif c == "t_minute":
                values[c] = (idx // 60) % 60
            elif c == "t_second":
                values[c] = idx % 60
            elif c == "t_am_pm":
                values[c] = (hours >= 12).astype(np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "t_meal_time":
                meal = np.where(
                    (hours >= 6) & (hours < 9), 0,
                    np.where(
                        (hours >= 11) & (hours < 14), 1,
                        np.where((hours >= 17) & (hours < 21), 2, 0),
                    ),
                ).astype(np.int32)
                values[c] = meal
                validity[c] = (
                    ((hours >= 6) & (hours < 9))
                    | ((hours >= 11) & (hours < 14))
                    | ((hours >= 17) & (hours < 21))
                )
                dicts[c] = _VOCABS[c]
    elif table == "warehouse":
        for c in cols:
            if c == "w_warehouse_sk":
                values[c] = idx + 1
            elif c == "w_warehouse_name":
                d = np.array(
                    [f"Warehouse {int(k)}" for k in idx + 1], dtype=object
                )
                values[c] = np.arange(len(d), dtype=np.int32)
                dicts[c] = d
            elif c == "w_warehouse_sq_ft":
                values[c] = uint_in(c, idx, 50_000, 990_000)
            elif c == "w_city":
                values[c], dicts[c] = _vocab_codes(c, idx, "ca_city")
            elif c == "w_state":
                values[c], dicts[c] = _vocab_codes(c, idx, "ca_state")
            elif c == "w_country":
                values[c] = np.zeros(len(idx), dtype=np.int32)
                dicts[c] = _VOCABS[c]
    elif table == "ship_mode":
        for c in cols:
            if c == "sm_ship_mode_sk":
                values[c] = idx + 1
            elif c == "sm_ship_mode_id":
                values[c], dicts[c] = _id_dict(idx + 1)
            elif c == "sm_type":
                values[c] = (idx % 5).astype(np.int32)
                dicts[c] = _VOCABS[c]
            elif c == "sm_carrier":
                values[c] = (idx % 20).astype(np.int32)
                dicts[c] = _VOCABS[c]
    elif table == "reason":
        for c in cols:
            if c == "r_reason_sk":
                values[c] = idx + 1
            elif c == "r_reason_id":
                values[c], dicts[c] = _id_dict(idx + 1)
            elif c == "r_reason_desc":
                d = np.array(
                    [f"reason {int(k)}" for k in idx + 1], dtype=object
                )
                values[c] = np.arange(len(d), dtype=np.int32)
                dicts[c] = d
    elif table == "income_band":
        for c in cols:
            if c == "ib_income_band_sk":
                values[c] = idx + 1
            elif c == "ib_lower_bound":
                values[c] = idx * 10_000
            elif c == "ib_upper_bound":
                values[c] = idx * 10_000 + 9_999
    else:
        raise KeyError(table)
    return values, validity, dicts, hi - lo


# dsdgen draws sales dates from [1998-01-02, 2003-01-02]
# (d_date_sk 2450816..2452643) — the window the benchmark queries'
# d_year predicates (1998..2002, e.g. Q7's d_year = 2000) target
_SALES_NDATES = 1827
_SALES_DATE_LO = 2450816 - DATE_SK_BASE
_COUNTIES = np.array(
    [f"{c} County" for c in (
        "Williamson", "Walker", "Ziebach", "Daviess", "Barrow",
        "Fairfield", "Luce", "Richland", "Bronx", "Maverick",
        "Mobile", "Huron", "Kittitas", "Jackson", "Mesa",
    )] + [f"County {i}" for i in range(15, 120)],
    dtype=object,
)

# per-channel column prefixes and line-grouping (several fact rows share
# one ticket/order whose customer/date/store attributes agree — Q68/Q79
# group by ss_ticket_number, Q94-ish count distinct order numbers)
_SALES_SPEC = {
    "store_sales": ("ss", 12, "ss_ticket_number"),
    "catalog_sales": ("cs", 10, "cs_order_number"),
    "web_sales": ("ws", 12, "ws_order_number"),
}


def _gen_sales(table, idx, cols, counts, values, validity, dicts):
    """Shared generator for the three sales channels: per-GROUP (ticket/
    order) foreign keys so grouped queries see realistic co-occurrence,
    per-ROW item/quantity/pricing with consistent arithmetic
    (ext = unit x quantity, profit = paid - wholesale).  Pricing hashes
    are memoized and computed only when a pricing column is requested —
    pruned key-only scans (Q96's count(*)) skip them entirely."""
    pre, per_group, group_col = _SALES_SPEC[table]
    grp = idx // per_group

    def fk(col, base_idx, count, nullable=True):
        v = 1 + (h64(col, base_idx) % np.uint64(count)).astype(np.int64)
        if nullable:
            return _nullable(col, base_idx, v)
        return v, None

    def put(col, v, ok=None):
        values[col] = v
        if ok is not None:
            validity[col] = ok

    _price = {}

    def price(name):
        if name not in _price:
            _price["qty"] = uint_in(f"{pre}_quantity", idx, 1, 100)
            lp = uint_in(f"{pre}_list_price", idx, 100, 20000)
            disc = (
                h64(f"{pre}_sales_price", idx) % np.uint64(100)
            ).astype(np.int64)
            _price["lp"] = lp
            _price["sp"] = (lp * (100 - disc)) // 100
            _price["wc"] = uint_in(f"{pre}_wholesale_cost", idx, 100, 10000)
        return _price[name]

    for c in cols:
        suffix = c[len(pre) + 1:]
        if c == group_col:
            put(c, grp + 1)
        elif suffix == "sold_date_sk":
            v = DATE_SK_BASE + _SALES_DATE_LO + (
                h64(c, grp) % np.uint64(_SALES_NDATES)
            ).astype(np.int64)
            put(c, *_nullable(c, grp, v))
        elif suffix == "ship_date_sk":
            sold = DATE_SK_BASE + _SALES_DATE_LO + (
                h64(f"{pre}_sold_date_sk", grp) % np.uint64(_SALES_NDATES)
            ).astype(np.int64)
            v = sold + 2 + (h64(c, grp) % np.uint64(90)).astype(np.int64)
            put(c, *_nullable(c, grp, v))
        elif suffix == "sold_time_sk":
            put(c, *_nullable(
                c, grp,
                (h64(c, grp) % np.uint64(86_400)).astype(np.int64),
            ))
        elif suffix == "item_sk":
            put(c, *fk(c, idx, counts["item"], nullable=False))
        elif suffix in ("customer_sk", "bill_customer_sk"):
            put(c, *fk(c, grp, counts["customer"]))
        elif suffix in ("cdemo_sk", "bill_cdemo_sk"):
            put(c, *fk(c, grp, counts["customer_demographics"]))
        elif suffix in ("hdemo_sk", "bill_hdemo_sk"):
            put(c, *fk(c, grp, counts["household_demographics"]))
        elif suffix in ("addr_sk", "bill_addr_sk"):
            put(c, *fk(c, grp, counts["customer_address"]))
        elif suffix == "store_sk":
            put(c, *fk(c, grp, counts["store"]))
        elif suffix == "warehouse_sk":
            put(c, *fk(c, grp, counts["warehouse"]))
        elif suffix == "ship_mode_sk":
            put(c, *fk(c, grp, counts["ship_mode"]))
        elif suffix == "web_page_sk":
            put(c, *fk(c, grp, 60))
        elif suffix == "promo_sk":
            put(c, *fk(c, idx, counts["promotion"]))
        elif suffix == "quantity":
            put(c, price("qty"))
        elif suffix == "wholesale_cost":
            put(c, price("wc"))
        elif suffix == "list_price":
            put(c, price("lp"))
        elif suffix == "sales_price":
            put(c, price("sp"))
        elif suffix == "ext_sales_price":
            put(c, price("sp") * price("qty"))
        elif suffix == "ext_list_price":
            put(c, price("lp") * price("qty"))
        elif suffix == "ext_wholesale_cost":
            put(c, price("wc") * price("qty"))
        elif suffix == "ext_discount_amt":
            put(c, (price("lp") - price("sp")) * price("qty"))
        elif suffix == "coupon_amt":
            put(c, np.where(
                (h64(c, idx) % np.uint64(10)).astype(np.int64) == 0,
                uint_in(c, idx, 100, 50000),
                0,
            ))
        elif suffix == "net_paid":
            put(c, price("sp") * price("qty"))
        elif suffix == "net_profit":
            put(c, (price("sp") - price("wc")) * price("qty"))
        else:
            raise KeyError(c)


# --- SPI ---------------------------------------------------------------


class TpcdsMetadata(ConnectorMetadata):
    def __init__(self, sf: float):
        self.sf = sf

    def list_tables(self):
        return list(SCHEMAS)

    def get_table_schema(self, table):
        return TableSchema(
            table, tuple(ColumnSchema(c, t) for c, t in SCHEMAS[table])
        )

    def get_table_statistics(self, table):
        counts = _counts(self.sf)
        n = counts[table]
        pk = {
            "date_dim": "d_date_sk", "item": "i_item_sk",
            "store": "s_store_sk", "promotion": "p_promo_sk",
            "customer_demographics": "cd_demo_sk",
            "customer": "c_customer_sk",
            "customer_address": "ca_address_sk",
            "household_demographics": "hd_demo_sk",
            "time_dim": "t_time_sk", "warehouse": "w_warehouse_sk",
            "ship_mode": "sm_ship_mode_sk", "reason": "r_reason_sk",
            "income_band": "ib_income_band_sk",
        }.get(table)
        # NDVs of the generator's bounded-domain columns (TpchMetadata-style
        # statistics): missing ndv makes the CBO assume ndv = row_count,
        # which balloons group-by capacities to the scan size
        ndv = {
            "d_year": 201, "d_moy": 12, "d_dom": 31, "d_qoy": 4,
            "i_brand_id": 1000, "i_brand": len(BRANDS),
            "i_manufact_id": 1000, "i_manager_id": 100,
            "i_category_id": 10, "i_category": 10,
            "i_class_id": 16, "i_class": 16, "i_current_price": 9900,
            "cd_gender": 2, "cd_marital_status": 5,
            "cd_education_status": 7,
            "p_channel_email": 2, "p_channel_event": 2,
            "s_store_name": counts["store"],
            "s_store_id": counts["store"],
            "i_item_id": counts["item"],
            "t_hour": 24, "t_minute": 60, "t_second": 60,
            "t_am_pm": 2, "t_meal_time": 3,
            "hd_income_band_sk": 20, "hd_buy_potential": 6,
            "hd_dep_count": 10, "hd_vehicle_count": 6,
            "ca_city": len(CITIES), "ca_state": len(STATES),
            "ca_county": len(_COUNTIES), "ca_country": 1,
            "ca_gmt_offset": 5,
            "c_first_name": len(FIRST_NAMES),
            "c_last_name": len(LAST_NAMES),
            "c_birth_year": 69, "c_birth_month": 12,
            "c_birth_country": len(COUNTRIES),
            "sm_type": 5, "sm_carrier": 20,
            "w_state": len(STATES),
        }
        # the three sales channels share FK-domain NDVs by suffix
        for pre, grp_col, grp_div in (
            ("ss", "ss_ticket_number", 12),
            ("cs", "cs_order_number", 10),
            ("ws", "ws_order_number", 12),
        ):
            fact = {"ss": "store_sales", "cs": "catalog_sales",
                    "ws": "web_sales"}[pre]
            groups = max(1, counts[fact] // grp_div)
            ndv.update({
                f"{pre}_quantity": 100,
                f"{pre}_item_sk": counts["item"],
                f"{pre}_promo_sk": counts["promotion"],
                f"{pre}_store_sk": counts["store"],
                f"{pre}_warehouse_sk": counts["warehouse"],
                f"{pre}_ship_mode_sk": counts["ship_mode"],
                f"{pre}_web_page_sk": 60,
                f"{pre}_customer_sk": min(counts["customer"], groups),
                f"{pre}_bill_customer_sk": min(counts["customer"], groups),
                f"{pre}_cdemo_sk": min(
                    counts["customer_demographics"], groups),
                f"{pre}_bill_cdemo_sk": min(
                    counts["customer_demographics"], groups),
                f"{pre}_hdemo_sk": min(
                    counts["household_demographics"], groups),
                f"{pre}_bill_hdemo_sk": min(
                    counts["household_demographics"], groups),
                f"{pre}_addr_sk": min(counts["customer_address"], groups),
                f"{pre}_bill_addr_sk": min(
                    counts["customer_address"], groups),
                f"{pre}_sold_date_sk": _SALES_NDATES,
                f"{pre}_ship_date_sk": _SALES_NDATES + 91,
                f"{pre}_sold_time_sk": 86_400,
                grp_col: groups,
            })
        # value ranges for selectivity estimation (date windows, years)
        rng = {
            "d_year": (1900.0, 2100.0), "d_moy": (1.0, 12.0),
            "d_dom": (1.0, 31.0), "d_qoy": (1.0, 4.0),
            "d_date_sk": (float(DATE_SK_BASE),
                          float(DATE_SK_BASE + DATE_DIM_ROWS - 1)),
            "t_hour": (0.0, 23.0), "t_minute": (0.0, 59.0),
            "c_birth_year": (1924.0, 1992.0),
            "hd_dep_count": (0.0, 9.0), "hd_vehicle_count": (-1.0, 4.0),
            "i_manufact_id": (1.0, 1000.0), "i_manager_id": (1.0, 100.0),
            "i_brand_id": (1.0, 1000.0), "i_category_id": (1.0, 10.0),
        }
        for pre in ("ss", "cs", "ws"):
            lo = float(DATE_SK_BASE + _SALES_DATE_LO)
            rng[f"{pre}_sold_date_sk"] = (lo, lo + _SALES_NDATES - 1)
            rng[f"{pre}_quantity"] = (1.0, 100.0)
        cols = {}
        for c, t in SCHEMAS[table]:
            lohi = rng.get(c, (None, None))
            if c == pk:
                cols[c] = ColumnStatistics(
                    distinct_count=float(n),
                    min_value=lohi[0], max_value=lohi[1],
                )
            elif c in ndv or lohi[0] is not None:
                cols[c] = ColumnStatistics(
                    distinct_count=(
                        float(min(ndv[c], n)) if c in ndv else None
                    ),
                    min_value=lohi[0], max_value=lohi[1],
                )
        return TableStatistics(float(n), cols)


class TpcdsSplitManager(SplitManager):
    def __init__(self, sf):
        self.sf = sf

    def get_splits(self, table, desired, constraint=None):
        n = _counts(self.sf)[table]
        k = max(1, min(desired, (n + 65535) // 65536))
        return [Split(table, i, k) for i in range(k)]


class TpcdsPageSource(PageSource):
    def __init__(self, sf, split, columns):
        self.sf = sf
        self.split = split
        self.columns = list(columns)
        self._dicts: Dict[str, np.ndarray] = {}

    def pages(self):
        from ..page import Column, Page

        values, validity, dicts, count = generate(
            self.split.table, self.sf, self.split.ordinal, self.split.total,
            self.columns,
        )
        self._dicts = dicts
        types = dict(SCHEMAS[self.split.table])
        cols = [
            Column(types[c], values[c], validity.get(c), dicts.get(c))
            for c in self.columns
        ]
        yield Page(cols, count, self.columns)

    def dictionaries(self):
        out = dict(self._dicts)
        types = dict(SCHEMAS[self.split.table])
        for c in self.columns:
            if types[c].is_dictionary and c in _VOCABS and c not in out:
                out[c] = _VOCABS[c]
        return out


class TpcdsPageSourceProvider(PageSourceProvider):
    def __init__(self, sf):
        self.sf = sf

    def create_page_source(self, split, columns):
        return TpcdsPageSource(self.sf, split, columns)


class TpcdsConnector(Connector):
    def __init__(self, name: str, sf: float):
        self.name = name
        self.sf = sf

    def metadata(self):
        return TpcdsMetadata(self.sf)

    def split_manager(self):
        return TpcdsSplitManager(self.sf)

    def page_source_provider(self):
        return TpcdsPageSourceProvider(self.sf)


class TpcdsConnectorFactory(ConnectorFactory):
    name = "tpcds"

    def create(self, catalog_name: str, config: dict) -> TpcdsConnector:
        sf = float(config.get("tpcds.scale-factor", 0.01))
        return TpcdsConnector(catalog_name, sf)
