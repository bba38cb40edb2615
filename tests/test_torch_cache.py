"""The port's plan signatures and result cache against the JAX package's.

The signature and result-cache tests of tests/test_cache.py:58-306 on
the port: a plan's canonical digest is invariant under aliases, symbol
names and literal values and sensitive to everything else, and equals
the JAX package's digest of the same SQL; nondeterministic plans are
refused; the result cache evicts by recency within its byte budget,
spills cold entries as checksummed page frames (a corrupt frame is a
miss and a heal), rejects oversized entries and is invalidated by
writes; end to end a repeated query is served without running (no
kernel launched, nothing scanned) and relabeled with its own aliases.
The statements over system.runtime.* wait for the system connector
(the cache's counters are read directly).
"""
import os
import tempfile

import pytest

from trino_tpu.cache import plan_signature as jax_signature
from trino_tpu.session import tpch_session as jax_session
from trino_tpu.utils.faults import FaultInjector
from trino_tpu_torch import convert
from trino_tpu_torch import types as T
from trino_tpu_torch.cache import plan_signature
from trino_tpu_torch.cache.result_cache import FragmentResultCache
from trino_tpu_torch.ops import kernels as kn
from trino_tpu_torch.page import page_from_pydict
from trino_tpu_torch.serde import PageIntegrityError, deserialize_page, serialize_page
from trino_tpu_torch.session import Session
from trino_tpu_torch.session import tpch_session as _torch_session

SF = 0.001

Q6 = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1995-01-01'
  and l_discount between 0.05 and 0.07
  and l_quantity < 24
"""


def tpch_session(sf, **props):
    return _torch_session(sf, device="cpu", **props)


def _mem_session(**props):
    s = Session(config=props or None, device="cpu")
    s.create_catalog("mem", "memory", {})
    s.catalogs.get("mem").create_table(
        "t", [("x", T.BIGINT), ("y", T.BIGINT)],
        {"x": [1, 2, 3], "y": [10, 20, 30]},
    )
    return s


# --- plan signatures -----------------------------------------------------

SIGNED = [
    "select sum(n_nationkey) as a from nation",
    "select t.k from (select n_nationkey as k from nation) t",
    "select * from nation where n_regionkey = 1",
    "select * from nation where n_regionkey < 1",
    "select n_name from nation join region on n_regionkey = r_regionkey",
    Q6,
]


@pytest.mark.parametrize("i", range(len(SIGNED)))
def test_signature_equals_the_jax_packages(i):
    ts, js = tpch_session(SF), jax_session(SF, result_cache=False)
    a, b = plan_signature(ts.plan(SIGNED[i])), jax_signature(js.plan(SIGNED[i]))
    assert (a.digest, a.params, a.tables, a.deterministic) == (
        b.digest, b.params, b.tables, b.deterministic)


def test_signature_alias_invariant():
    s = tpch_session(SF)
    a = plan_signature(s.plan("select sum(n_nationkey) as a from nation"))
    b = plan_signature(s.plan("select sum(n_nationkey) as b from nation"))
    assert a.digest == b.digest


def test_signature_symbol_rename_invariant():
    s = tpch_session(SF)
    a = plan_signature(s.plan("select t.k from (select n_nationkey as k from nation) t"))
    b = plan_signature(s.plan("select u.m from (select n_nationkey as m from nation) u"))
    assert a.digest == b.digest


def test_signature_literal_parameterized():
    s = tpch_session(SF)
    a = plan_signature(s.plan("select * from nation where n_regionkey = 1"))
    b = plan_signature(s.plan("select * from nation where n_regionkey = 3"))
    assert a.digest == b.digest and a.params != b.params


def test_signature_semantics_not_aliased():
    s = tpch_session(SF)
    a = plan_signature(s.plan("select * from nation where n_regionkey = 1"))
    b = plan_signature(s.plan("select * from nation where n_regionkey < 1"))
    c = plan_signature(s.plan("select * from region where r_regionkey = 1"))
    assert a.digest != b.digest and a.digest != c.digest


def test_signature_join_order_sensitive():
    s = tpch_session(SF)
    a = plan_signature(s.plan(
        "select n_name from nation join region on n_regionkey = r_regionkey",
        optimized=False))
    b = plan_signature(s.plan(
        "select n_name from region join nation on n_regionkey = r_regionkey",
        optimized=False))
    assert a.digest != b.digest


def test_signature_tables_collected():
    sig = plan_signature(tpch_session(SF).plan(
        "select n_name from nation join region on n_regionkey = r_regionkey"))
    assert ("tpch", "nation") in sig.tables and ("tpch", "region") in sig.tables


def test_nondeterministic_plans_refused():
    s = tpch_session(SF)
    for q in ("select now() as t", "select rand() as r from nation",
              "select n_name from nation where rand() < 0.5"):
        sig = plan_signature(s.plan(q))
        assert not sig.deterministic and sig.reason, q


# --- nondeterministic functions at run time --------------------------------


def test_rand_executes_and_differs_per_query():
    s = _mem_session()
    vals1 = s.execute("select rand() as r from mem.t").to_pylist()
    vals2 = s.execute("select rand() as r from mem.t").to_pylist()
    assert all(0.0 <= v < 1.0 for (v,) in vals1)
    assert vals1 != vals2 and len(set(vals1)) == 3
    assert s.caches.result_cache.puts == 0  # never admitted


def test_now_not_stale_across_queries():
    s = tpch_session(SF)
    a = s.execute("select now() as t").columns[0].values[0]
    b = s.execute("select now() as t").columns[0].values[0]
    assert a != b and s.caches.result_cache.puts == 0


# --- the result cache: unit level -----------------------------------------


def _page(n=100):
    return page_from_pydict([("x", T.BIGINT)], {"x": list(range(n))})


def test_page_frames_round_trip_and_detect_corruption():
    page = page_from_pydict([("x", T.BIGINT), ("v", T.VARCHAR), ("d", T.decimal(12, 2))],
                            {"x": [1, None, 3], "v": ["a", None, "b"],
                             "d": ["1.50", "-2.25", None]})
    frame = serialize_page(page)
    convert.assert_pages_identical(page, deserialize_page(frame))
    bad = bytearray(frame)
    bad[-1] ^= 0xFF
    with pytest.raises(PageIntegrityError):
        deserialize_page(bytes(bad))


def test_result_cache_lru_eviction_spills():
    with tempfile.TemporaryDirectory() as d:
        rc = FragmentResultCache(max_bytes=1000, spill_dir=d, max_entry_fraction=1.0)
        rc.put(("k1",), _page())  # 800 bytes
        rc.put(("k2",), _page())  # over budget: k1 (oldest) spills
        st = rc.stats()
        assert st["evictions"] == 1 and rc.spills == 1 and st["bytes"] <= 1000
        assert len(os.listdir(d)) == 1
        back = rc.get(("k1",))
        assert back is not None and back.count == 100 and rc.spill_hits == 1
        convert.assert_pages_identical(back, _page())


def test_result_cache_lru_recency():
    rc = FragmentResultCache(max_bytes=1700, max_entry_fraction=1.0)
    rc.put(("k1",), _page())
    rc.put(("k2",), _page())
    assert rc.get(("k1",)) is not None  # touch k1: k2 becomes oldest
    rc.put(("k3",), _page())
    assert rc.evictions == 1
    spill_hits = rc.spill_hits
    assert rc.get(("k1",)) is not None and rc.spill_hits == spill_hits
    assert rc.get(("k2",)) is not None and rc.spill_hits == spill_hits + 1


def test_result_cache_rejects_oversized():
    rc = FragmentResultCache(max_bytes=1000)  # entry cap = 500
    assert not rc.put(("k",), _page())
    assert rc.rejected == 1 and rc.stats()["entries"] == 0


def test_result_cache_invalidate_by_table():
    rc = FragmentResultCache(max_bytes=1 << 20)
    rc.put(("k1",), _page(10), tables=(("mem", "a"),))
    rc.put(("k2",), _page(10), tables=(("mem", "b"),))
    assert rc.invalidate("mem", "a") == 1
    assert rc.get(("k1",)) is None and rc.get(("k2",)) is not None
    assert rc.stats()["invalidations"] == 1


def test_result_cache_corrupt_spill_is_miss_and_heal():
    """The JAX package's fault injector corrupts the spilled frame at the
    cache_read site: a miss and a heal, never an error."""
    with tempfile.TemporaryDirectory() as d:
        rc = FragmentResultCache(max_bytes=1000, spill_dir=d, max_entry_fraction=1.0)
        rc.put(("k1",), _page())
        rc.put(("k2",), _page())  # spills k1
        inj = FaultInjector.from_spec({"seed": 7, "cache_read": {"nth": 1}})
        assert rc.get(("k1",), injector=inj) is None
        assert rc.heals == 1 and os.listdir(d) == []
        assert rc.get(("k1",), injector=inj) is None and rc.heals == 1


# --- the result cache: end to end -------------------------------------------


def test_warm_q6_skips_execution():
    s = tpch_session(SF)
    kn.reset_counts()
    r1 = s.execute(Q6)
    assert s.last_scan_bytes > 0 and s.last_kernel_profile is not None
    launches = dict(kn.LAUNCHES)
    r2 = s.execute(Q6)
    convert.assert_pages_identical(r1, r2)
    assert s.last_scan_bytes == 0 and s.last_kernel_profile is None
    assert kn.LAUNCHES == launches
    st = s.caches.result_cache.stats()
    assert (st["hits"], st["misses"], st["puts"]) == (1, 1, 1)


def test_result_cache_alias_hit_relabeled():
    s = tpch_session(SF)
    s.execute("select sum(n_nationkey) as a from nation")
    page = s.execute("select sum(n_nationkey) as b from nation")
    assert s.caches.result_cache.hits == 1 and page.names == ["b"]


def test_insert_invalidates_cached_result():
    s = _mem_session()
    q = "select sum(x) as s from mem.t"
    assert s.execute(q).to_pylist() == [(6,)]
    assert s.execute(q).to_pylist() == [(6,)]
    assert s.caches.result_cache.hits == 1
    s.execute("insert into mem.t values (10, 100)")
    assert s.execute(q).to_pylist() == [(16,)]
    assert s.caches.result_cache.stats()["invalidations"] >= 1


def test_drop_table_invalidates_cached_result():
    s = _mem_session()
    s.execute("create table mem.u as select x from mem.t")
    s.execute("select count(*) from mem.u")
    assert s.caches.result_cache.stats()["entries"] == 1
    s.execute("drop table mem.u")
    assert s.caches.result_cache.stats()["entries"] == 0


def test_writes_evict_the_tables_scans():
    s = _mem_session(result_cache=False)
    s.execute("select sum(x) as s from mem.t")
    cached = lambda: [k for k in s._scan_cache.entries if k[:2] == ("mem", "t")]
    assert cached()
    s.execute("insert into mem.t values (10, 100)")
    assert not cached() and s._scan_cache.bytes == 0
    assert s.execute("select sum(x) as s from mem.t").to_pylist() == [(16,)]


def test_memory_data_version_per_table():
    s = _mem_session()
    conn = s.catalogs.get("mem")
    conn.create_table("u", [("z", T.BIGINT)], {"z": [5]})
    v_t, v_u = conn.data_version("t"), conn.data_version("u")
    s.execute("insert into mem.u values (6)")
    assert conn.data_version("u") > v_u and conn.data_version("t") == v_t
    q = "select sum(x) as s from mem.t"
    s.execute(q)
    s.execute("insert into mem.u values (7)")
    s.execute(q)
    assert s.caches.result_cache.hits == 1


def test_session_property_disables_result_cache():
    s = tpch_session(SF, result_cache=False)
    s.execute(Q6)
    s.execute(Q6)
    st = s.caches.result_cache.stats()
    assert st["puts"] == 0 and st["hits"] == 0


def test_result_cache_budget_follows_the_property():
    s = tpch_session(SF)
    s.execute("set session result_cache_max_bytes = 100")
    s.execute("select n_name, n_regionkey from nation")  # > 50 bytes: rejected
    assert s.caches.result_cache.max_bytes == 100
    assert s.caches.result_cache.rejected == 1


# --- the scan cache: keyed by the data a scan reads, lanes by column ------

SCAN_SF = 0.01

Q3_AT = """select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
o_orderdate, o_shippriority from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey and l_orderkey = o_orderkey
and o_orderdate < date '{date}' and l_shipdate > date '{date}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10"""


@pytest.fixture(scope="module")
def uncached():
    """The answers of a session that caches no scan."""
    s = tpch_session(SCAN_SF, result_cache=False, scan_cache_enabled=False)
    return lambda sql: s.execute(sql)


def _scan_session():
    s = tpch_session(SCAN_SF, result_cache=False)
    s.tracer.clear()
    return s


def _spans(s, name):
    return [sp for sp in s.tracer.spans if sp.name == name]


def _entries(s, table):
    return {k: e for k, e in s._scan_cache.entries.items() if k[1] == table}


def _resident_bytes(cache):
    from trino_tpu_torch.exec.scan import lane_bytes

    return sum(lane_bytes(e.columns) for e in cache.entries.values())


def test_another_q3_date_hits_every_scan(uncached):
    s = _scan_session()
    s.execute(Q3_AT.format(date="1995-03-15"))
    h0, m0 = s._scan_cache.hits, s._scan_cache.misses
    page = s.execute(Q3_AT.format(date="1995-03-22"))
    assert (s._scan_cache.hits - h0, s._scan_cache.misses - m0) == (3, 0)
    loads = _spans(s, "scan_load")[-3:]
    assert [sp.attributes["cache"] for sp in loads] == ["hit"] * 3
    convert.assert_pages_identical(uncached(Q3_AT.format(date="1995-03-22")), page)


def test_q6_q3_q1_share_one_lineitem_entry(uncached):
    """Q3 and Q1 make only the lineitem columns Q6 did not: one entry,
    one line count per lineitem range, and every answer exact."""
    from tpch_sql import QUERIES

    s = _scan_session()
    sqls = [QUERIES[6][0], Q3_AT.format(date="1995-03-15"), QUERIES[1][0]]
    pages = []
    for i, sql in enumerate(sqls):
        gens = len(_spans(s, "scan_generate"))
        pages.append(s.execute(sql))
        if i == 1:
            li = [g for g in _spans(s, "scan_generate")[gens:]
                  if g.attributes["table"] == "lineitem"]
            assert [g.attributes["columns"] for g in li] == ["l_orderkey"]
    (entry,) = _entries(s, "lineitem").values()
    assert set(entry.columns) == {
        "l_quantity", "l_extendedprice", "l_discount", "l_shipdate", "l_orderkey",
        "l_returnflag", "l_linestatus", "l_tax"}
    assert len(_spans(s, "scan_count")) == len(entry.spec["ranges"]) == 1
    # l_orderkey for Q3; l_returnflag, l_linestatus and l_tax for Q1
    assert s._scan_cache.stats()["column_fills"] == 4
    filled = [sp.attributes.get("filled") for sp in _spans(s, "scan_load")
              if sp.attributes["table"] == "lineitem"]
    assert filled == [None, 1, 3]
    for sql, page in zip(sqls, pages):
        convert.assert_pages_identical(uncached(sql), page)
    assert s._scan_cache.bytes == _resident_bytes(s._scan_cache)


def test_extending_an_entry_evicts_the_others_oldest_first(uncached):
    s = _scan_session()
    cache = s._scan_cache
    for sql in ("select sum(l_quantity) from lineitem",
                "select sum(o_totalprice) from orders",
                "select sum(c_acctbal) from customer"):
        s.execute(sql)
    (li,), (orders,), (customer,) = (list(_entries(s, t)) for t in
                                     ("lineitem", "orders", "customer"))
    assert list(cache.entries) == [li, orders, customer]
    # room for l_extendedprice once orders (the oldest but lineitem) goes
    rows = cache.entries[li].rows
    cache.max_bytes = cache.bytes + 8 * rows - cache.entries[orders].nbytes
    sql = "select sum(l_quantity), sum(l_extendedprice) from lineitem"
    page = s.execute(sql)
    assert list(cache.entries) == [li, customer] and cache.evictions == 1
    assert cache.bytes == _resident_bytes(cache) <= cache.max_bytes
    convert.assert_pages_identical(uncached(sql), page)
    # a budget nothing fits: every other entry goes, never the one extended
    cache.max_bytes = 1
    sql = "select sum(l_discount) from lineitem"
    page = s.execute(sql)
    assert list(cache.entries) == [li] and cache.evictions == 2
    assert cache.bytes == _resident_bytes(cache) == cache.entries[li].nbytes
    assert cache.stats()["column_fills"] == 2
    convert.assert_pages_identical(uncached(sql), page)


def test_a_column_only_the_host_makes_replaces_a_generated_entry(uncached):
    """o_clerk is formatted on the host: an orders entry generated on the
    device is read anew on the host for it, and later columns are then
    read on the host into that entry."""
    s = _scan_session()
    sqls = ["select sum(o_totalprice) from orders",
            "select count(*), min(o_clerk) from orders",
            "select max(o_clerk), sum(o_totalprice) from orders"]
    pages = [s.execute(sql) for sql in sqls[:2]]
    (entry,) = _entries(s, "orders").values()
    assert entry.spec is None and set(entry.columns) == {"o_clerk"}
    assert s.last_kernel_profile["hostGeneratedScans"] == 1
    pages.append(s.execute(sqls[2]))
    (entry,) = _entries(s, "orders").values()
    assert set(entry.columns) == {"o_clerk", "o_totalprice"}
    assert [sp.attributes["cache"] for sp in _spans(s, "scan_load")] == ["miss"] * 3
    assert s._scan_cache.stats()["column_fills"] == 1
    for sql, page in zip(sqls, pages):
        convert.assert_pages_identical(uncached(sql), page)
    assert s._scan_cache.bytes == _resident_bytes(s._scan_cache)


def test_a_host_read_entry_grows_by_column():
    s = _mem_session(result_cache=False)
    assert s.execute("select sum(x) from mem.t").to_pylist() == [(6,)]
    assert s.execute("select sum(y), max(x) from mem.t").to_pylist() == [(60, 3)]
    (entry,) = [e for k, e in s._scan_cache.entries.items() if k[:2] == ("mem", "t")]
    assert set(entry.columns) == {"x", "y"} and entry.spec is None
    assert s._scan_cache.stats()["column_fills"] == 1
    assert s.execute("select sum(x + y) from mem.t").to_pylist() == [(66,)]
    assert s._scan_cache.hits == 1
