"""The port's GROUPING SETS, ROLLUP, CUBE and grouping() against the JAX
package.

Every SELECT of tests/test_grouping_sets.py, and statements over
selective filters, empty inputs, three-key cubes and the newer
aggregates, run through both packages' `tpch_session` (the port on the
CPU).  The pages must be byte-identical (trino_tpu_torch/convert.py):
the port gathers the selected rows before it copies them once per
grouping set, where the JAX package tiles whole padded lanes, and the
row order it keeps makes the pages the same.
"""
import pytest

from chip_smoke import sql_statements
from test_torch_aggregates import assert_same_pages
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch.exec import local
from trino_tpu_torch.session import tpch_session as torch_session

SF = 0.001

STATEMENTS = sql_statements("test_grouping_sets.py")
STATEMENTS.update({
    "cube_three_keys_grouping":
        "select l_returnflag, l_linestatus, l_shipinstruct, "
        "grouping(l_returnflag, l_linestatus, l_shipinstruct) g, count(*), "
        "sum(l_extendedprice) from lineitem "
        "group by cube(l_returnflag, l_linestatus, l_shipinstruct)",
    "rollup_selective_filter":
        "select o_orderpriority, o_orderstatus, count(*), max(o_totalprice) "
        "from orders where o_custkey < 8 "
        "group by rollup(o_orderpriority, o_orderstatus)",
    "rollup_empty_input":
        "select o_orderpriority, count(*), sum(o_totalprice) from orders "
        "where o_orderkey < 0 group by rollup(o_orderpriority)",
    "rollup_bigint_keys_hash_sort":
        "select o_custkey, o_shippriority, count(*), min(o_orderdate) from orders "
        "group by rollup(o_custkey, o_shippriority) order by 1, 2",
    "grouping_sets_new_aggregates":
        "select l_returnflag, l_linestatus, stddev_samp(l_quantity), "
        "approx_percentile(l_discount, 0.5), max_by(l_orderkey, l_extendedprice), "
        "bitwise_or_agg(l_linenumber), checksum(l_partkey) from lineitem "
        "group by grouping sets ((l_returnflag), (l_linestatus), ())",
    "rollup_distinct_and_join":
        "select n_name, c_mktsegment, count(distinct c_nationkey), "
        "sum(c_acctbal) from customer, nation where c_nationkey = n_nationkey "
        "group by rollup(n_name, c_mktsegment) order by 1, 2",
    "having_grouping_and_order":
        "select l_returnflag, l_linestatus, grouping(l_linestatus) gl, "
        "count(*) c from lineitem group by cube(l_returnflag, l_linestatus) "
        "having count(*) > 100 order by gl, l_returnflag, l_linestatus",
})


@pytest.fixture(scope="module")
def sessions():
    return (jax_session(SF, result_cache=False),
            torch_session(SF, device="cpu"))


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_grouping_sets_statements_match_jax(sessions, name):
    assert_same_pages(sessions, STATEMENTS[name])


def test_groupid_copies_only_selected_rows(sessions, monkeypatch):
    """The GroupId lanes hold sets x selected rows, not sets x scanned
    rows: a filter keeping 7 of the 1,500 orders gives 3 x 7 rows."""
    seen = []
    real = local._TraceCtx._visit_groupid

    def spy(self, node):
        b = real(self, node)
        seen.append((len(node.sets), b.sel.shape[0], int(b.sel.sum())))
        return b

    monkeypatch.setattr(local._TraceCtx, "_visit_groupid", spy)
    _, ts = sessions
    page = ts.execute(
        "select o_orderstatus, o_orderpriority, count(*) from orders "
        "where o_orderkey < 30 group by rollup(o_orderstatus, o_orderpriority)")
    n = ts.execute("select count(*) from orders where o_orderkey < 30").to_pylist()[0][0]
    assert seen == [(3, 3 * n, 3 * n)]
    assert page.count > 0 and n < 30
