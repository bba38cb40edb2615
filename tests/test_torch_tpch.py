"""All 22 TPC-H queries through the port against the JAX package.

Both engines run the same SQL text (tests/tpch_sql.py) over the same
generated data through their own `tpch_session`; the output pages must
be byte-identical (trino_tpu_torch/convert.py) and agree with the sqlite
oracle at the tolerance tests/test_tpch_suite.py uses.  The port runs on
the CPU (device="cpu"), i.e. with its kernels' plain versions.

SF 0.038 is the smallest scale, in steps of 0.001, at which every query
returns rows: Q18 (orders whose lines sum to more than 300 units) is
empty up to SF 0.037.  The oracle gets indexes on the join keys and
ANALYZE statistics, so its correlated subqueries (Q4, Q17, Q20-Q22)
run as index searches.
"""
import sqlite3

import pytest

from oracle import assert_rows_match, load_tpch
from tpch_sql import QUERIES, oracle_dialect
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch import convert
from trino_tpu_torch.session import tpch_session as torch_session

SF = 0.038
TABLES = ["region", "nation", "customer", "orders", "lineitem", "supplier",
          "part", "partsupp"]
ORACLE_INDEXES = ["lineitem(l_orderkey)", "lineitem(l_partkey, l_suppkey)",
                  "orders(o_orderkey)", "orders(o_custkey)",
                  "partsupp(ps_partkey)", "part(p_partkey)",
                  "supplier(s_suppkey)", "customer(c_custkey)"]


@pytest.fixture(scope="module")
def sessions():
    return (jax_session(SF, result_cache=False),
            torch_session(SF, device="cpu"))


@pytest.fixture(scope="module")
def oracle_conn():
    conn = sqlite3.connect(":memory:")
    load_tpch(conn, SF, TABLES)
    for i, ix in enumerate(ORACLE_INDEXES):
        conn.execute(f"create index oracle_ix{i} on {ix}")
    conn.execute("analyze")
    return conn


@pytest.mark.parametrize("qnum", sorted(QUERIES))
def test_tpch_query_byte_identical_and_matches_oracle(sessions, oracle_conn, qnum):
    sql, oracle_sql, ordered, skip = QUERIES[qnum]
    assert skip is None
    js, ts = sessions
    a = js.execute(sql)
    b = ts.execute(sql)
    convert.assert_pages_identical(a, b)
    assert b.count > 0
    expected = oracle_conn.execute(oracle_sql or oracle_dialect(sql)).fetchall()
    assert_rows_match(b.to_pylist(), expected, tol=2e-2, ordered=ordered)
