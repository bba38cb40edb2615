"""The port's hive connector against the JAX package's.

The tests of tests/test_hive.py on the port: both packages' sessions read
the same parquet / ORC / CSV / JSON files, and every page must be
byte-identical (trino_tpu_torch/convert.py) besides the reference's own
assertions.  The warehouse of the shared tests is written by the port's
`write_parquet_table`; the JAX package's writer makes the same arrow
tables (held here) and its files read identically through the port.
`test_distributed_hive_scan` runs under `distributed = true` on two
shards in both packages (the reference uses two workers).  The
optimizer's IN-list row-group pruning test
(tests/test_optimizer.py::test_hive_in_list_row_group_pruning) runs
through the port too.
"""
import glob
import os
from decimal import Decimal

import numpy as np
import pytest

import trino_tpu.session as jsession
import trino_tpu_torch.session as tsession
from trino_tpu import page as jpage
from trino_tpu import types as JT
from trino_tpu.connectors.hive import write_parquet_table as jax_write
from trino_tpu_torch import convert
from trino_tpu_torch import types as T
from trino_tpu_torch.connectors.hive import HivePageSink, write_parquet_table
from trino_tpu_torch.exec.partitioner import SkewedPartitionRebalancer
from trino_tpu_torch.page import Page, column_from_pylist, page_from_pydict
from trino_tpu_torch.plan import nodes as P

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

N = 4000
EVENTS = {
    "id": list(range(N)),
    "category": [["alpha", "beta", "gamma", None][i % 4] for i in range(N)],
    "amount": [round(i * 0.25, 2) for i in range(N)],
    "ts_day": [f"1995-{1 + (i % 12):02d}-{1 + (i % 28):02d}" for i in range(N)],
    "score": [float(i % 97) / 7.0 for i in range(N)],
}


def _events_schema(types):
    return [("id", types.BIGINT), ("category", types.VARCHAR),
            ("amount", types.decimal(12, 2)), ("ts_day", types.DATE),
            ("score", types.DOUBLE)]


def _pair(warehouse, catalog="hive"):
    js = jsession.Session()
    ts = tsession.Session(device="cpu")
    for s in (js, ts):
        s.create_catalog(catalog, "hive", {"hive.warehouse-dir": str(warehouse)})
    return js, ts


def both(pair, sql):
    """Run `sql` through both sessions: identical pages; the port's rows."""
    js, ts = pair
    a = js.execute(sql)
    b = ts.execute(sql)
    convert.assert_pages_identical(a, b)
    return b.to_pylist()


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    wh = str(tmp_path_factory.mktemp("warehouse"))
    # events: 4 row groups of 1000 rows, id ascending (prunable)
    page = page_from_pydict(_events_schema(T), EVENTS)
    write_parquet_table(wh, "events", page, rows_per_group=1000)
    return wh


@pytest.fixture(scope="module")
def pair(warehouse):
    return _pair(warehouse)


def test_schema_discovery(pair):
    rows = both(pair, "show columns from events")
    assert ("id", "bigint") in rows
    assert ("category", "varchar") in rows
    assert ("amount", "decimal(12,2)") in rows
    assert ("ts_day", "date") in rows


def test_scan_and_aggregate(pair):
    rows = both(pair, "select category, count(*) c, sum(amount) s from events "
                      "group by category order by category")
    by_cat = {r[0]: r for r in rows}
    assert by_cat["alpha"][1] == 1000
    assert by_cat[None][1] == 1000
    assert both(pair, "select count(*) from events") == [(4000,)]


def test_decimal_and_double_roundtrip(pair):
    rows = both(pair, "select sum(amount), min(score), max(score) from events")
    expected_sum = round(sum(i * 0.25 for i in range(4000)), 2)
    assert abs(float(rows[0][0]) - expected_sum) < 0.01
    assert rows[0][1] == 0.0


def test_row_group_pruning_via_constraint(pair):
    js, ts = pair
    sm = ts.catalogs.get("hive").split_manager()
    assert len(sm.get_splits("events", 8)) == 4  # one per row group
    pruned = sm.get_splits("events", 8, (("id", 2500.0, None),))
    assert len(pruned) == 2  # row groups [2000,3000) and [3000,4000)
    jsm = js.catalogs.get("hive").split_manager()
    assert [s.info for s in pruned] == [
        s.info for s in jsm.get_splits("events", 8, (("id", 2500.0, None),))]
    plan = ts.plan("select count(*) from events where id >= 2500")
    scans = []
    P.visit_plan(plan, lambda n, d: scans.append(n) if isinstance(n, P.TableScan) else None)
    assert scans and scans[0].constraint == (("id", 2500.0, None),)
    assert both(pair, "select count(*) from events where id >= 2500") == [(1500,)]


def test_pruned_split_lists_are_scan_cache_entries_of_their_own(warehouse):
    """The scan cache keys by the splits a scan reads, not by its
    constraint: constraints that prune different row groups are two
    entries, and one that prunes nothing shares the unconstrained scan's."""
    cached = tsession.Session(device="cpu", config={"result_cache": False})
    plain = tsession.Session(device="cpu", config={"result_cache": False,
                                                   "scan_cache_enabled": False})
    for s in (cached, plain):
        s.create_catalog("hive", "hive", {"hive.warehouse-dir": warehouse})
    cache = cached._scan_cache

    def run(where):
        sql = f"select count(*), sum(amount), min(id) from events {where}"
        page = cached.execute(sql)
        convert.assert_pages_identical(plain.execute(sql), page)
        return page.to_pylist()

    def entries():
        return [k for k in cache.entries if k[:2] == ("hive", "events")]

    assert run("where id >= 2500")[0][0] == 1500
    assert run("where id < 1500")[0][0] == 1500
    assert len(entries()) == 2
    assert run("")[0][0] == N
    assert len(entries()) == 3
    hits = cache.hits
    assert run("where id >= 0")[0][0] == N
    assert cache.hits == hits + 1 and len(entries()) == 3


def test_date_filter_pruning_correctness(pair):
    rows = both(pair, "select count(*) from events where ts_day >= date '1995-06-01' "
                      "and ts_day < date '1995-07-01'")
    assert rows == [(sum(1 for i in range(4000) if (i % 12) == 5),)]


def test_distributed_hive_scan(warehouse):
    """The reference runs this scan on two workers; here both packages
    run it under `distributed = true` over two shards (the port's mesh,
    the JAX package's 2-device mesh), the row groups spread over them."""
    sql = ("select category, count(*) c from events "
           "where category is not null group by category order by category")
    pages = []
    for s in (jsession.Session(config={"distributed": True, "num_devices": 2}),
              tsession.Session(device="cpu", config={"distributed": True,
                                                     "num_devices": 2})):
        s.create_catalog("hive", "hive", {"hive.warehouse-dir": warehouse})
        pages.append(s.execute(sql))
    jpage_, tpage = pages
    assert tpage.to_pylist() == jpage_.to_pylist() == [
        ("alpha", 1000), ("beta", 1000), ("gamma", 1000)]
    convert.assert_pages_identical(jpage_, tpage)


def test_fractional_literal_constraint_is_conservative(pair):
    assert both(pair, "select count(*) from events where id > 2500.5") == [(1499,)]
    assert both(pair, "select count(*) from events "
                      "where id >= 999.5 and id < 1000.5") == [(1,)]


def test_divergent_row_group_dictionaries_merge(tmp_path):
    """Row groups with disjoint string dictionaries merge through the
    executor's per-split dictionary merge."""
    page = page_from_pydict([("s", T.VARCHAR), ("x", T.BIGINT)],
                            {"s": ["aaa", "bbb", "ccc", "ddd"], "x": [1, 2, 3, 4]})
    write_parquet_table(str(tmp_path), "t", page, rows_per_group=2)
    pair = _pair(tmp_path, "hive2")
    assert both(pair, "select s, x from t order by x") == [
        ("aaa", 1), ("bbb", 2), ("ccc", 3), ("ddd", 4)]
    assert both(pair, "select count(*) from t where s = 'ccc'") == [(1,)]


def test_hive_statistics(pair):
    js, ts = pair
    stats = ts.catalogs.get("hive").metadata().get_table_statistics("events")
    assert stats.row_count == 4000
    assert stats.columns["id"].min_value == 0
    assert stats.columns["id"].max_value == 3999
    jstats = js.catalogs.get("hive").metadata().get_table_statistics("events")
    assert {k: (c.min_value, c.max_value, c.null_fraction)
            for k, c in stats.columns.items()} == {
        k: (c.min_value, c.max_value, c.null_fraction)
        for k, c in jstats.columns.items()}


def test_hive_orc_csv_json_formats(tmp_path):
    from pyarrow import orc as paorc

    wh = str(tmp_path)
    os.makedirs(f"{wh}/events")
    paorc.write_table(pa.table({"id": [1, 2, 3], "name": ["x", "y", "z"]}),
                      f"{wh}/events/part0.orc")
    os.makedirs(f"{wh}/logs")
    with open(f"{wh}/logs/a.csv", "w") as f:
        f.write("ts,msg\n1,hello\n2,world\n")
    os.makedirs(f"{wh}/js")
    with open(f"{wh}/js/a.json", "w") as f:
        f.write('{"a": 1, "b": "q"}\n{"a": 2, "b": "r"}\n')
    pair = _pair(wh)
    assert both(pair, "show tables") == [("events",), ("js",), ("logs",)]
    assert both(pair, "select * from events order by id") == [
        (1, "x"), (2, "y"), (3, "z")]
    assert both(pair, "select sum(ts), max(msg) from logs") == [(3, "world")]
    assert both(pair, "select a, b from js order by a") == [(1, "q"), (2, "r")]


def test_scan_cache_invalidates_on_file_change(tmp_path):
    """Hive scans are cacheable with a filesystem-fingerprint version:
    warm repeats skip the parquet decode; a new file invalidates."""
    wh = str(tmp_path)
    (tmp_path / "t").mkdir()
    pq.write_table(pa.table({"x": [1, 2, 3]}), f"{wh}/t/part0.parquet")
    s = tsession.Session(device="cpu")
    s.create_catalog("hive", "hive", {"hive.warehouse-dir": wh})
    conn = s.catalogs.get("hive")
    assert conn.cacheable
    v0 = conn.data_version()
    assert s.execute("select sum(x) from t").to_pylist() == [(6,)]
    assert conn.data_version() == v0
    assert any(k[0] == "hive" for k in s._scan_cache.entries), "scan not cached"
    assert s.execute("select sum(x) from t").to_pylist() == [(6,)]
    pq.write_table(pa.table({"x": [10]}), f"{wh}/t/part1.parquet")
    assert conn.data_version() != v0
    assert s.execute("select sum(x) from t").to_pylist() == [(16,)]


def test_scaled_writers_split_output_files(tmp_path):
    """The writer pool is sized from the observed bytes: a big CTAS
    writes parallel part files, a small one a single file."""
    wh = str(tmp_path)
    s = tsession.tpch_session(0.01, device="cpu", result_cache=False)
    s.create_catalog("hive", "hive",
                     {"hive.warehouse-dir": wh, "hive.writer-target-bytes": 200_000})
    s.execute("create table hive.default.li as select l_orderkey, l_quantity, "
              "l_extendedprice from lineitem")
    assert len(glob.glob(f"{wh}/li/part-*.parquet")) > 1
    got = s.execute("select count(*), sum(l_quantity) from hive.default.li").to_pylist()
    assert got == s.execute("select count(*), sum(l_quantity) from lineitem").to_pylist()
    # the JAX package reads the port's part files to the same page
    js = jsession.Session()
    js.create_catalog("hive", "hive", {"hive.warehouse-dir": wh})
    sql = "select l_orderkey, l_quantity, l_extendedprice from hive.default.li " \
          "order by l_orderkey, l_extendedprice, l_quantity"
    convert.assert_pages_identical(js.execute(sql), s.execute(sql))
    s.execute("create table hive.default.tiny as select 1 as x")
    assert len(glob.glob(f"{wh}/tiny/part-*.parquet")) == 1


def test_skewed_partition_rebalancer():
    reb = SkewedPartitionRebalancer(4, skew_factor=1.5, rebalance_interval=10_000)
    rng = np.random.default_rng(0)
    for _ in range(8):
        keys = np.where(rng.random(20_000) < 0.9, 7, rng.integers(0, 1000, 20_000))
        page = Page([column_from_pylist(T.BIGINT, keys.tolist())], len(keys), ["k"])
        reb.partition_page(page, ["k"])
    assert reb.scaled_partitions(), "hot partition never scaled"
    assert reb.bucket_rows.max() / reb.bucket_rows.sum() < 0.55, reb.bucket_rows


def test_skewed_write_spreads_hot_key(tmp_path):
    rng = np.random.default_rng(1)
    n = 200_000
    keys = np.where(rng.random(n) < 0.9, 7, rng.integers(0, 10_000, n))
    page = Page([column_from_pylist(T.BIGINT, keys.tolist()),
                 column_from_pylist(T.BIGINT, list(range(n)))], n, ["k", "x"])
    sink = HivePageSink(str(tmp_path), "sk", ["k", "x"], overwrite=False,
                        writer_target_bytes=400_000)
    sink.append(page)
    assert sink.finish() == n
    assert len(glob.glob(f"{tmp_path}/sk/part-*.parquet")) > 2
    assert sink.rebalancer.scaled_partitions(), "skew never detected"
    sizes = sink.rebalancer.bucket_rows
    assert sizes.max() / sizes.sum() < 0.55, sizes


def test_wide_decimal_parquet_roundtrip(tmp_path):
    wh = str(tmp_path)
    s = tsession.Session(device="cpu")
    s.create_catalog("hive", "hive", {"hive.warehouse-dir": wh})
    s.execute("create table hive.default.wd (v decimal(30,4))")
    s.execute("insert into hive.default.wd values (123456789012345678901.2345), "
              "(-0.0001), (null)")
    assert s.execute("select v from hive.default.wd order by v").to_pylist() == [
        (Decimal("-0.0001"),), (Decimal("123456789012345678901.2345"),), (None,)]
    (tot,) = s.execute("select sum(v) from hive.default.wd").to_pylist()[0]
    assert tot == Decimal("123456789012345678901.2344")
    pair = _pair(wh)
    both(pair, "select v from wd order by v")


WRITER_CASES = {
    "events": (lambda t: _events_schema(t), EVENTS, 1000),
    "nulls_and_narrow_ints": (
        lambda t: [("i", t.INTEGER), ("b", t.BOOLEAN), ("d", t.DOUBLE),
                   ("s", t.VARCHAR), ("n", t.BIGINT)],
        {"i": [1, None, -3, 2**31 - 1], "b": [True, None, False, True],
         "d": [0.5, -1e300, None, 2.25], "s": [None, "x", "x", ""],
         "n": [None, None, None, None]}, 2),
    "decimals": (
        lambda t: [("a", t.decimal(18, 4)), ("w", t.decimal(30, 4)),
                   ("z", t.decimal(10, 0)), ("day", t.DATE)],
        {"a": [1234567890.1234, -0.0001, None, 12345678901234.5678],
         "w": [Decimal("123456789012345678901.2345"), None, Decimal("-0.0001"),
               Decimal("0")],
         "z": [-9999999999, 0, None, 42],
         "day": ["1970-01-01", None, "1998-12-01", "1900-03-04"]}, 3),
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_parquet_writer_matches_jax(tmp_path, case):
    """The port's vectorized writer makes the arrow table the JAX
    package's Python-value writer makes, and each package reads the
    other's file to the same page."""
    schema, data, rows_per_group = WRITER_CASES[case]
    jax_write(str(tmp_path / "j"), "t",
              jpage.page_from_pydict(schema(JT), data), rows_per_group)
    write_parquet_table(str(tmp_path / "p"), "t", page_from_pydict(schema(T), data),
                        rows_per_group)
    a = pq.read_table(f"{tmp_path}/j/t/part-0.parquet")
    b = pq.read_table(f"{tmp_path}/p/t/part-0.parquet")
    assert a.schema == b.schema and a.equals(b)
    names = ", ".join(n for n, _ in schema(T))
    for side in ("j", "p"):
        pair = _pair(tmp_path / side)
        if any(v is not None for v in data.get("n", [0])):
            both(pair, f"select {names} from t")
            continue
        # an all-NULL column is written with arrow's null type, which
        # neither package reads
        for s in pair:
            with pytest.raises(NotImplementedError, match="null"):
                s.execute(f"select {names} from t")


def test_hive_in_list_row_group_pruning(tmp_path):
    """tests/test_optimizer.py's IN-list pruning through the port."""
    wh = str(tmp_path)
    page = page_from_pydict([("x", T.BIGINT)], {"x": list(range(1, 31))})
    write_parquet_table(wh, "t", page, rows_per_group=10)
    pair = _pair(wh)
    sm = pair[1].catalogs.get("hive").split_manager()
    in_splits = sm.get_splits("t", 4, (("x", 10.0, 21.0, (10.0, 21.0)),))
    assert len(sm.get_splits("t", 4)) == 3
    assert len(sm.get_splits("t", 4, (("x", 10.0, 21.0),))) == 3
    assert len(in_splits) == 2
    assert both(pair, "select count(*) from t where x in (10, 21)") == [(2,)]


# -- the fused aggregate over a written table's decimal statistics -----------

Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from {table}
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""
Q1_COLS = ("l_quantity, l_extendedprice, l_discount, l_tax, l_returnflag, "
           "l_linestatus, l_shipdate")


@pytest.mark.parametrize("store", ["hive", "lake"])
def test_fused_q1_over_written_decimal_stats(tmp_path, store):
    """Parquet footers and ANALYZE give decimal bounds in value units
    (l_tax 0.00..0.08), the tpch connector in the lanes' units (0..8).
    The fused aggregate's proofs read lanes, so over a hive table (its
    decimals' bounds from the footers; ANALYZE gives the group keys and
    the date the statistics the fused gate needs) or a lakehouse table after ANALYZE,
    Q1 fuses into the same page as the unfused run, whose rows are Q1's
    over tpch."""
    s = tsession.tpch_session(0.01, device="cpu", result_cache=False)
    s.create_catalog("hive", "hive", {"hive.warehouse-dir": str(tmp_path / "hive")})
    s.create_catalog("lake", "lakehouse", {"lake.warehouse-dir": str(tmp_path / "lake")})
    if store == "hive":
        write_parquet_table(str(tmp_path / "hive"), "lineitem",
                            s.execute(f"select {Q1_COLS} from lineitem"),
                            rows_per_group=16384)
        table = "hive.default.lineitem"
        s.execute(f"analyze {table} (l_returnflag, l_linestatus, l_shipdate)")
    else:
        table = "lake.default.lineitem"
        s.execute(f"create table {table} as select {Q1_COLS} from lineitem")
        s.execute(f"analyze {table}")
    pages = {}
    for mode in ("on", "off"):
        s.properties.set("megakernels", mode)
        pages[mode] = s.execute(Q1.format(table=table))
        fused = s.last_kernel_profile.get("fusedAggregates") or 0
        assert bool(fused) == (mode == "on"), (mode, s.last_kernel_profile.get(
            "lastFusionReject"))
    convert.assert_pages_identical(pages["on"], pages["off"])
    assert pages["off"].to_pylist() == s.execute(Q1.format(table="lineitem")).to_pylist()
