"""The port's session statements against the JAX package's.

The statements of tests/test_session_features.py, test_views.py,
test_prepared.py and test_stats.py whose machinery the port has run
through both packages' sessions (the port on the CPU, the JAX package
with its result cache off) with tests/test_torch_dml.py's replay: each
page must be byte-identical, or both must raise the same exception type
with the same message.  Statements whose pages differ on purpose are
compared otherwise, and named in CHANGES.md:
  - SHOW SESSION lists the port's properties: the rows of the names both
    packages know must agree (name, value, default);
  - a query after `SET SESSION distributed = true`: both packages run it
    on their mesh (the port's of num_devices = 0 is one CPU shard, the
    JAX package's all 8 virtual devices), and the pages are identical;
  - EXPLAIN ANALYZE prints timings (tests/test_torch_opstats.py compares
    its operator rows).
Beside the replays: SET/SHOW SESSION of a property both packages have,
the event listener, the tracer's spans, the memory context, ANALYZE's
statistics against the JAX package's, and a stats-fed plan flip.
"""
import pytest

import trino_tpu.session as jsession
import trino_tpu_torch.session as tsession
from test_torch_dml import assert_same_outcome, replay_events, replayed_tests
from trino_tpu_torch import convert
from trino_tpu_torch.utils.events import EventListener
from trino_tpu_torch.utils.memory import (
    ExceededMemoryLimitError,
    MemoryContext,
    MemoryPool,
)
from trino_tpu_torch.utils.metrics import counter

SHOW_SESSION_COLUMNS = ["name", "value", "default", "description"]


def _check(a, b):
    """Pages identical, SHOW SESSION by the rows both packages know."""
    if a.names == SHOW_SESSION_COLUMNS:
        port = {r[0]: r[1:3] for r in b.to_pylist()}
        jax = {r[0]: r[1:3] for r in a.to_pylist() if r[0] in port}
        assert len(jax) > 20 and jax == {k: v for k, v in port.items() if k in jax}
        return
    convert.assert_pages_identical(a, b)


def _differs_on_purpose(sql):
    return sql.strip().lower().startswith("explain analyze")


def _sessions(kind, arg):
    """Both packages' sessions, result caches off (SHOW SESSION then
    agrees on every shared property)."""
    if kind == "tpch_session":
        return (jsession.tpch_session(arg, result_cache=False),
                tsession.tpch_session(arg, device="cpu", result_cache=False))
    return (jsession.Session(config={"result_cache": False}),
            tsession.Session(config={"result_cache": False}, device="cpu"))


def replay_statements(filename, test):
    """Replay one JAX test's session events; statements that differ on
    purpose run in the port alone (it must answer or raise as noted)."""
    pairs, ran = {}, 0
    for kind, name, arg in replay_events(filename, test):
        if kind == "new":
            pairs[name] = _sessions(*arg)
        elif kind == "catalog":
            for s in pairs[name]:
                s.create_catalog(*arg)
        elif kind == "table":
            raise AssertionError("memory tables replay in test_torch_dml.py")
        elif name in pairs:
            assert arg is not None, f"{test}: a session statement's text is computed"
            if _differs_on_purpose(arg):
                _port_alone(pairs[name], arg)
            else:
                assert_same_outcome(pairs[name], arg, _check)
            ran += 1
    return ran


def _port_alone(pair, sql):
    _js, ts = pair
    page = ts.execute(sql)
    text = "\n".join(r[0] for r in page.to_pylist())
    assert "rows=" in text and "wall=" in text and "output rows" in text


SESSION_SKIP = (
    "test_set_show_session",  # group_capacity: no capacity ladder here
    "test_memory_connector", "test_tablesample", "test_tablesample_after_alias",
    "test_datetime_constants",  # now() differs by the clock
    "test_http_event_listener",  # the HTTP listener waits for the server
)
SESSION_TESTS = replayed_tests("test_session_features.py", SESSION_SKIP)
VIEW_TESTS = replayed_tests("test_views.py")
PREPARED_TESTS = replayed_tests("test_prepared.py")


@pytest.mark.parametrize("test", SESSION_TESTS)
def test_session_feature_statements_match_jax(test):
    assert replay_statements("test_session_features.py", test) > 0


@pytest.mark.parametrize("test", VIEW_TESTS)
def test_view_statements_match_jax(test):
    assert replay_statements("test_views.py", test) > 0


@pytest.mark.parametrize("test", PREPARED_TESTS)
def test_prepared_statements_match_jax(test):
    assert replay_statements("test_prepared.py", test) > 0


def test_the_replays_reach_the_statements():
    assert {"test_show_stats", "test_use_statement", "test_transaction_control",
            "test_per_catalog_session_properties",
            "test_catalog_property_validation_and_show",
            "test_explain_distributed"} <= set(SESSION_TESTS)
    assert len(VIEW_TESTS) == 9 and len(PREPARED_TESTS) >= 10


# -- statements the replays cannot reach -------------------------------------


def test_set_show_session():
    js, ts = _sessions("tpch_session", 0.001)
    for sql in ("set session double_buffer_depth = 2",
                "set session megakernels = 'off'",
                "set session tpch.rows_per_split = 2048"):
        assert_same_outcome((js, ts), sql)
    assert ts.properties.get("double_buffer_depth") == 2
    assert_same_outcome((js, ts), "show session", _check)
    rows = {r[0]: r[1] for r in ts.execute("show session").to_pylist()}
    assert rows["megakernels"] == "off" and rows["tpch.rows_per_split"] == "2048"
    # a property whose machinery the port does not have stays unknown
    with pytest.raises(KeyError, match="unknown session property: group_capacity"):
        ts.execute("set session group_capacity = 8192")


def test_reprepare_invalidates_the_plan_cache():
    ts = tsession.tpch_session(0.001, device="cpu", result_cache=False)
    ts.execute("prepare rp from select count(*) from orders where o_custkey < ?")
    a = ts.execute("execute rp using 99").to_pylist()
    assert "execute rp using 99" in ts._plan_cache
    ts.execute("prepare rp from select count(*) from orders where o_custkey > ?")
    assert not ts._plan_cache
    b = ts.execute("execute rp using 99").to_pylist()
    n = ts.execute("select count(*) from orders").to_pylist()[0][0]
    assert a[0][0] + b[0][0] == n  # no order has custkey 99 (keys % 3 != 0)


def test_event_listener_receives_lifecycle():
    s = tsession.tpch_session(0.001, device="cpu")
    events = []

    class L(EventListener):
        def query_created(self, ev):
            events.append(("created", ev.query_id))

        def query_completed(self, ev):
            events.append(("completed", ev.state, ev.output_rows))

        def cache_event(self, ev):
            events.append(("cache", ev.tier, ev.op))

    s.events.add(L())
    s.execute("select count(*) from nation")
    assert events[0][0] == "created"
    assert ("cache", "result", "miss") in events and ("cache", "result", "put") in events
    assert events[-1] == ("completed", "FINISHED", 1)
    with pytest.raises(Exception):
        s.execute("select bogus from nation")
    assert events[-1][1] == "FAILED"


def test_tracing_spans():
    s = tsession.tpch_session(0.001, device="cpu")
    s.tracer.clear()
    s.execute("select count(*) from region")
    names = [sp.name for sp in s.tracer.spans]
    assert {"parse", "analyze_plan", "optimize", "execute", "query"} <= set(names)
    q = [sp for sp in s.tracer.spans if sp.name == "query"][0]
    children = [sp for sp in s.tracer.spans if sp.parent_id == q.span_id]
    assert len(children) >= 2


def test_memory_pool_accounting():
    pool = MemoryPool(1000)
    root = MemoryContext("query", pool=pool, query_id="q1")
    op = root.new_child("op")
    op.set_bytes(400)
    assert pool.reserved == 400
    with pytest.raises(ExceededMemoryLimitError):
        root.new_child("op2").set_bytes(700)
    root.close()
    assert pool.reserved == 0


# -- ANALYZE and SHOW STATS (tests/test_stats.py) -----------------------------


def _memory_pair():
    pair = _sessions("Session", None)
    for s in pair:
        s.create_catalog("mem", "memory", {})
    return pair


def _assert_same_stats(pair, catalog, table):
    a, b = (s.metadata.table_statistics(catalog, table) for s in pair)
    assert a.row_count == b.row_count
    assert sorted(a.columns) == sorted(b.columns)
    for c, ca in a.columns.items():
        cb = b.columns[c]
        assert (ca.distinct_count, ca.null_fraction, ca.min_value, ca.max_value) == (
            cb.distinct_count, cb.null_fraction, cb.min_value, cb.max_value), c
        assert (ca.histogram is None) == (cb.histogram is None)
        if ca.histogram is not None:
            assert tuple(map(tuple, ca.histogram)) == tuple(map(tuple, cb.histogram))


STATS_SEQUENCES = {
    "roundtrip": [
        "create table mem.default.t (x bigint, y double, v varchar)",
        "insert into mem.default.t values "
        "(1, 1.5, 'a'), (2, 2.5, 'b'), (3, null, 'b'), (4, 4.5, null)",
        "analyze mem.default.t", "show stats for mem.default.t",
    ],
    "column_subset_merges": [
        "create table mem.default.t (a bigint, b bigint)",
        "insert into mem.default.t values (1, 10), (2, 20), (3, 30)",
        "analyze mem.default.t (a)", "show stats for mem.default.t",
        "analyze mem.default.t (b)", "show stats for mem.default.t",
        "analyze mem.default.t (nope)",
    ],
    "dml_invalidates": [
        "create table mem.default.d (x bigint)",
        "insert into mem.default.d values (1), (2), (3)",
        "analyze mem.default.d", "insert into mem.default.d values (4)",
        "show stats for mem.default.d", "analyze mem.default.d",
        "show stats for mem.default.d",
    ],
}


@pytest.mark.parametrize("name", sorted(STATS_SEQUENCES))
def test_analyze_sequences_match_jax(name):
    pair = _memory_pair()
    before = counter("trino_tpu_stats_analyze_total").value()
    for sql in STATS_SEQUENCES[name]:
        assert_same_outcome(pair, sql)
    table = "d" if name == "dml_invalidates" else "t"
    _assert_same_stats(pair, "mem", table)
    analyzes = sum(s.startswith("analyze") and "nope" not in s
                   for s in STATS_SEQUENCES[name])
    assert counter("trino_tpu_stats_analyze_total").value() == before + analyzes


def test_stats_counters_serve_and_miss():
    """As tests/test_stats.py: statistics of the analyzed version are
    served; after a write they are stale, dropped and counted a miss."""
    (_, s) = _memory_pair()
    s.execute("create table mem.default.d (x bigint)")
    s.execute("insert into mem.default.d values (1), (2), (3)")
    s.execute("analyze mem.default.d")
    served = counter("trino_tpu_stats_served_total").value()
    assert s.metadata.table_statistics("mem", "d").columns["x"].distinct_count == 3.0
    assert counter("trino_tpu_stats_served_total").value() == served + 1
    missed = counter("trino_tpu_stats_missed_total").value()
    s.execute("insert into mem.default.d values (4)")
    st = s.metadata.table_statistics("mem", "d")
    assert st.columns == {} and st.row_count == 4.0
    assert counter("trino_tpu_stats_missed_total").value() > missed


def test_analyze_tpch_column_matches_jax():
    """ANALYZE over a generated table (the NDV sketch of l_partkey, the
    histogram of l_shipdate) stores the JAX package's statistics."""
    pair = (jsession.tpch_session(0.01, result_cache=False),
            tsession.tpch_session(0.01, device="cpu"))
    assert_same_outcome(pair, "analyze lineitem (l_partkey, l_shipdate)")
    _assert_same_stats(pair, "tpch", "lineitem")
    exact = pair[1].execute("select count(distinct l_partkey) from lineitem").to_pylist()[0][0]
    ndv = pair[1].metadata.table_statistics("tpch", "lineitem").columns["l_partkey"].distinct_count
    assert abs(ndv - exact) / exact < 0.15


def test_stats_flip_join_distribution_like_jax():
    """test_stats.py's acceptance bar at a smaller scale: ANALYZE of the
    memory copies changes a join's distribution in EXPLAIN, and both
    packages print the same plans before and after."""
    q3m = """
    select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue, o_orderdate
    from mem.default.customer, mem.default.orders, mem.default.lineitem
    where c_mktsegment = 'BUILDING'
      and c_custkey = o_custkey and l_orderkey = o_orderkey
      and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
    group by l_orderkey, o_orderdate
    order by revenue desc, o_orderdate limit 10
    """
    sf, threshold = 0.02, 12000
    pair = (jsession.tpch_session(sf, result_cache=False,
                                  broadcast_join_threshold_rows=threshold),
            tsession.tpch_session(sf, device="cpu",
                                  broadcast_join_threshold_rows=threshold))
    for s in pair:
        s.create_catalog("mem", "memory", {})
    for sql in ("create table mem.default.customer as select c_custkey, c_mktsegment "
                "from customer",
                "create table mem.default.orders as select o_orderkey, o_custkey, "
                "o_orderdate from orders",
                "create table mem.default.lineitem as select l_orderkey, l_extendedprice, "
                "l_discount, l_quantity, l_shipdate from lineitem"):
        assert_same_outcome(pair, sql)
    before = assert_same_outcome(pair, "explain " + q3m)
    for t in ("customer", "orders", "lineitem"):
        assert_same_outcome(pair, f"analyze mem.default.{t}")
    after = assert_same_outcome(pair, "explain " + q3m)
    text = ["\n".join(r[0] for r in p.to_pylist()) for p in (before, after)]
    assert "dist=broadcast" in text[0] and "dist=partitioned" not in text[0]
    assert "dist=partitioned" in text[1]
    assert_same_outcome(pair, q3m)
