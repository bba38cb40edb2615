"""The port's spill (out-of-core) paths and dynamic filtering against the
JAX package.

Every statement of tests/test_spill_df.py runs through both packages'
sessions with the same memory limit (the JAX side with
device_generation=False); the pages must be byte-identical, float64
columns at relative 1e-12, and the limit errors the same.  Where the
gate prefers streaming or the in-memory run, each spill executor is
also driven directly on both packages (join, aggregation).  The
dynamic-filter tests run the port's FragmentExecutor with the port's
collect_dynamic_filters against the JAX package's.
"""
import pytest

from trino_tpu import types as JT
from test_torch_streaming import decision
from trino_tpu.exec import spill as jax_spill
from trino_tpu.exec import streaming as jax_streaming
from trino_tpu.exec.dynamic_filter import collect_dynamic_filters as jax_collect
from trino_tpu.exec.fragment_exec import FragmentExecutor as JaxFragmentExecutor
from trino_tpu.page import page_from_pydict as jax_page
from trino_tpu.plan import nodes as JP
from trino_tpu.session import tpch_session as _jax_session
from trino_tpu.utils.memory import ExceededMemoryLimitError as JaxLimitError
from trino_tpu_torch import convert
from trino_tpu_torch import types as TT
from trino_tpu_torch.exec import spill as torch_spill
from trino_tpu_torch.exec import streaming as torch_streaming
from trino_tpu_torch.exec.dynamic_filter import collect_dynamic_filters
from trino_tpu_torch.exec.fragment_exec import FragmentExecutor
from trino_tpu_torch.page import page_from_pydict
from trino_tpu_torch.plan import nodes as TP
from trino_tpu_torch.session import tpch_session as _torch_session
from trino_tpu_torch.utils.memory import ExceededMemoryLimitError

RTOL = 1e-12
SF = 0.001

Q1ISH = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sq, "
    "count(*) as c, avg(l_extendedprice) as ae, min(l_tax) as mn, "
    "max(l_discount) as mx from lineitem "
    "where l_shipdate <= date '1998-09-02' "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
)


def jax_session(sf, **props):
    return _jax_session(sf, device_generation=False, result_cache=False, **props)


def torch_session(sf, **props):
    # host generation, as jax_session's: the out-of-core gate counts the
    # on-device generator's temporaries (tests/test_torch_tpch_device.py
    # holds the gates with it on)
    return _torch_session(sf, device="cpu", device_generation=False, **props)


# name: (sf, limit, sql, the port's path: None = in memory); the
# spilled page must also give the rows of a session with room for it,
# but for the wide-decimal DISTINCT, which only the spill can answer
IN_MEMORY_REFUSES = ("global_multi_distinct_wide",)
STATEMENTS = {
    "q1ish": (SF, 100_000, Q1ISH, "stream"),
    "join_aggregate": (0.01, 400_000,
                       "select c.c_mktsegment, count(*), sum(o.o_totalprice) "
                       "from orders o join customer c on o.o_custkey = c.c_custkey "
                       "where o.o_totalprice > 1000 "
                       "group by c.c_mktsegment order by c.c_mktsegment", None),
    "join_rows": (0.01, 100_000,
                  "select o_orderkey, c_name, o_totalprice from orders join customer "
                  "on o_custkey = c_custkey where o_totalprice > 100000 "
                  "order by o_orderkey", "join-spill"),
    "sort": (0.01, 300_000, "select o_orderkey, o_totalprice from orders "
             "order by o_totalprice desc, o_orderkey", None),
    "sort_tight": (0.01, 100_000, "select o_orderkey, o_totalprice from orders "
                   "order by o_totalprice desc, o_orderkey", "sort-spill"),
    "window": (0.01, 300_000,
               "select o_custkey, o_orderkey, row_number() over (partition by "
               "o_custkey order by o_orderdate, o_orderkey) rn from orders "
               "order by o_custkey, rn limit 50", "window-spill"),
    "window_running_sum": (0.01, 300_000,
                           "select count(*), sum(s), min(s), max(s) from (select "
                           "sum(o_totalprice) over (partition by o_custkey order by "
                           "o_orderkey) s from orders)", "window-spill"),
    "grouped_distinct": (SF, 100_000,
                         "select l_returnflag, count(distinct l_suppkey) c, "
                         "approx_percentile(l_extendedprice, 0.5) p from lineitem "
                         "group by l_returnflag order by l_returnflag",
                         "distinct-spill"),
    "grouped_distinct_varchar": (SF, 100_000,
                                 "select l_returnflag, count(distinct l_shipmode) m "
                                 "from lineitem group by l_returnflag "
                                 "order by l_returnflag", None),
    "global_multi_distinct_wide": (SF, 100_000,
                                   "select count(distinct cast(l_quantity as "
                                   "decimal(25,4))) a, count(distinct l_suppkey) b, "
                                   "count(*) c from lineitem", "distinct-spill"),
    "sort_varchar_dictionaries": (0.01, 300_000,
                                  "select o_orderkey, o_clerk from orders "
                                  "order by o_totalprice desc, o_orderkey",
                                  "sort-spill"),
    "sort_varchar_key": (0.01, 300_000,
                         "select o_clerk, o_orderkey from orders "
                         "order by o_clerk desc, o_orderkey limit 40", None),
}


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_spill_statements_match_jax(name):
    sf, limit, sql, path = STATEMENTS[name]
    ts = torch_session(sf, query_max_memory_bytes=limit)
    b = ts.execute(sql)
    js = jax_session(sf, query_max_memory_bytes=limit)
    a = js.execute(sql)
    convert.assert_pages_match(a, b, RTOL)
    assert ts.last_kernel_profile.get("outOfCore") == path
    # the same path, partitions and batches as the JAX package's gate
    want = decision(jax_spill, jax_streaming, js, sql, limit)
    assert decision(torch_spill, torch_streaming, ts, sql, limit) == want
    assert want[0] == (path or "memory")
    if name not in IN_MEMORY_REFUSES:
        # the rows of a session with room for the query (a spilled sort's
        # merged dictionaries number their strings another way)
        assert torch_session(sf).execute(sql).to_pylist() == b.to_pylist()


def test_sort_spill_desc_int64_min():
    """The host merge of spilled sort runs reverses integer keys with ~v
    (negation wraps at INT64_MIN)."""
    lo, hi = -(2**63), 2**63 - 1
    vals = [lo, hi, 0, -1, 7] * 400
    pages = []
    for make in (jax_session, torch_session):
        s = make(0.01, query_max_memory_bytes=8_000)
        s.create_catalog("memory", "memory", {})
        s.execute("create table memory.default.ext (v bigint)")
        s.execute("insert into memory.default.ext values "
                  + ", ".join(f"({v})" for v in vals))
        pages.append(s.execute("select v from memory.default.ext order by v desc"))
    convert.assert_pages_identical(*pages)
    assert [r[0] for r in pages[1].to_pylist()] == sorted(vals, reverse=True)
    assert s.last_kernel_profile["outOfCore"] == "sort-spill"


@pytest.mark.parametrize("limit,props", [
    (50_000, {}),  # a bare projection has nothing to stage out of core
    (100_000, {"spill_enabled": False}),
])
def test_limit_errors_match_jax(limit, props):
    sql = "select l_orderkey, l_partkey from lineitem" if not props else Q1ISH
    with pytest.raises(JaxLimitError) as je:
        jax_session(SF, query_max_memory_bytes=limit, **props).execute(sql)
    ts = torch_session(SF, query_max_memory_bytes=limit, **props)
    with pytest.raises(ExceededMemoryLimitError) as te:
        ts.execute(sql)
    assert str(te.value) == str(je.value)
    assert ts.memory_manager.general.reserved == 0


def test_spill_plan_detection():
    s = torch_session(SF)
    plan = s.plan(Q1ISH)
    ex = s._executor()
    sp = torch_spill.plan_spill(ex, plan, 100_000)
    assert sp is not None
    agg, scan, splits, batch = sp
    assert scan.table == "lineitem" and len(splits) > 1
    j = jax_session(SF)
    want = jax_spill.plan_spill(j._executor(), j.plan(Q1ISH), 100_000)
    assert (len(splits), batch) == (len(want[2]), want[3])
    assert torch_spill.plan_spill(ex, plan, 8 << 30) is None


@pytest.mark.parametrize("kind", ["aggregation", "join"])
def test_spill_executors_driven_directly_match_jax(kind):
    """The aggregation and join spills, which the gate reaches only when
    streaming refuses, run directly on both packages."""
    if kind == "aggregation":
        sf, limit, sql = SF, 100_000, Q1ISH
        plan_fn, run_fn = "plan_spill", "execute_spilled_aggregation"
    else:
        sf, limit = 0.01, 200_000
        sql = STATEMENTS["join_aggregate"][2]
        plan_fn, run_fn = "plan_join_spill", "execute_spilled_join"
    pages = []
    for make, mod in ((jax_session, jax_spill), (torch_session, torch_spill)):
        s = make(sf, query_max_memory_bytes=limit)
        ex, plan = s._executor(), s.plan(sql)
        if mod is jax_spill and kind == "aggregation":
            # the JAX package's batches keep the session's manager and
            # refuse their device reservation (ROADMAP.md, C); a task
            # without one is where its aggregation spill runs
            with pytest.raises(JaxLimitError, match="device \\(HBM\\)"):
                mod.execute_spilled_aggregation(ex, plan, *getattr(mod, plan_fn)(
                    ex, plan, limit))
            ex.config.pop("memory_manager")
        sp = getattr(mod, plan_fn)(ex, plan, limit)
        assert sp is not None
        pages.append(getattr(mod, run_fn)(ex, plan, *sp))
    convert.assert_pages_match(pages[0], pages[1], RTOL)
    convert.assert_pages_match(torch_session(sf).execute(sql), pages[1], RTOL)


# ---------------------------------------------------------------------------
# dynamic filtering


def _probe_plan(session, P, T):
    """lineitem(l_partkey, l_quantity) inner-joined to a remote build side
    of part keys: the worker-side shape of a broadcast join fragment."""
    schema = session.catalogs.get("tpch").metadata().get_table_schema("lineitem")
    scan = P.TableScan(
        "tpch", "lineitem",
        (("l_partkey", "l_partkey"), ("l_quantity", "l_quantity")),
        (("l_partkey", schema.column_type("l_partkey")),
         ("l_quantity", schema.column_type("l_quantity"))),
    )
    rs = P.RemoteSource(7, ("p_partkey",), (("p_partkey", T.BIGINT),))
    join = P.Join("inner", scan, rs, (("l_partkey", "p_partkey"),))
    syms = tuple(join.output_symbols())
    return P.Output(join, syms, syms)


@pytest.mark.parametrize("keys", [[1, 2, 3], []], ids=["three_keys", "empty_build"])
def test_dynamic_filter_pruning_matches_jax(keys):
    out = []
    for make, P, T, mkpage, collect, FE in (
        (jax_session, JP, JT, jax_page, jax_collect, JaxFragmentExecutor),
        (torch_session, TP, TT, page_from_pydict, collect_dynamic_filters,
         FragmentExecutor),
    ):
        s = make(SF)
        plan = _probe_plan(s, P, T)
        remote = {7: [mkpage([("p_partkey", T.BIGINT)], {"p_partkey": keys})]}
        dfs = collect(plan, remote)
        assert (0, "l_partkey") in dfs
        splits = s.catalogs.get("tpch").split_manager().get_splits("lineitem", 1)
        cfg = {"device_generation": False} if FE is JaxFragmentExecutor else {
            "device": "cpu", "device_generation": False}
        ex = FE(s.catalogs, cfg, {0: splits}, remote, dfs)
        page = ex.execute(plan)
        unpruned = FE(s.catalogs, dict(cfg), {0: splits}, remote)
        assert sorted(page.to_pylist()) == sorted(unpruned.execute(plan).to_pylist())
        assert unpruned.df_rows_pruned == 0
        out.append((page, ex.df_rows_pruned))
    (a, pa), (b, pb) = out
    convert.assert_pages_identical(a, b)
    assert pa == pb > 0
    assert {r[0] for r in b.to_pylist()} <= set(keys)


def test_dynamic_filter_not_applied_to_left_join():
    s = torch_session(SF)
    plan = _probe_plan(s, TP, TT)
    join = plan.source
    left = TP.Output(TP.Join("left", join.left, join.right, join.criteria),
                     plan.names, plan.symbols)
    build = page_from_pydict([("p_partkey", TT.BIGINT)], {"p_partkey": [1]})
    assert collect_dynamic_filters(left, {7: [build]}) == {}
