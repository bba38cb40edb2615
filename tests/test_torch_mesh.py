"""The port's mesh executor against the JAX package's, on 8 CPU shards.

Every case of tests/test_mesh.py on the port: each statement runs through
the JAX package's MeshExecutor over its 8 virtual CPU devices and through
the port's MeshExecutor over 8 logical CPU shards, and the pages must be
equal: every value byte for byte, float aggregates to the reference's
relative 1e-9 (the JAX package sums across devices in XLA's order, the
port in shard order).  The reference's spies (the window's and the
distinct's hash repartition, the range exchange, the partitioned semi
join) spy on the port's own functions.  The skew-hint case holds the
port to one run of the retry ladder (its all_to_all has no fixed chunk
to size, so there is no hint to measure).

Unit tests of the port's shuffle (bucket_of, range_buckets,
repartition), its collectives, the task-timeline merge and the
straggler detector of obs/opstats.py, and compile_filter_project,
against the JAX package's functions on seeded numpy inputs, follow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trino_tpu.session as jsession
from trino_tpu.parallel import mesh_executor as JMX
from trino_tpu.parallel import shuffle as jshuffle
from trino_tpu_torch.parallel import collectives as C
from trino_tpu_torch.parallel import mesh_executor as MX
from trino_tpu_torch.parallel import shuffle
from trino_tpu_torch.session import Session, tpch_session

SF = 0.001
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _jax_compile_cache_of_its_own():
    """The JAX package's compiled fragments stay this module's (its
    process-global compile cache swapped for a fresh one meanwhile)."""
    import trino_tpu.cache.compile_cache as jax_compile_cache

    saved = jax_compile_cache._SHARED
    jax_compile_cache._SHARED = None
    yield
    jax_compile_cache._SHARED = saved


@pytest.fixture(scope="module")
def jax_session():
    return jsession.tpch_session(SF)


@pytest.fixture(scope="module")
def jax_mesh(jax_session):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return JMX.MeshExecutor(jax_session.catalogs, JMX.default_mesh(8))


@pytest.fixture(scope="module")
def session():
    return tpch_session(SF, device="cpu", result_cache=False)


@pytest.fixture(scope="module")
def mesh_exec(session):
    return MX.MeshExecutor(session.catalogs, MX.default_mesh(8, "cpu"))


def _approx_eq(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == pytest.approx(b, rel=1e-9, abs=1e-12)
    return a == b


def same_rows(got, want, ordered=True):
    if not ordered:
        got, want = sorted(map(repr, got)), sorted(map(repr, want))
        assert got == want
        return
    assert len(got) == len(want), (got[:5], want[:5])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(map(_approx_eq, g, w)), (g, w)


def run_both(pair, sql, ordered=True):
    """The statement through the JAX mesh and the port's mesh."""
    (jax_session, jax_mesh), (session, mesh_exec) = pair
    want = jax_mesh.execute(jax_session.plan(sql)).to_pylist()
    got = mesh_exec.execute(session.plan(sql)).to_pylist()
    same_rows(got, want, ordered)
    return got


@pytest.fixture(scope="module")
def pair(jax_session, jax_mesh, session, mesh_exec):
    return (jax_session, jax_mesh), (session, mesh_exec)


def test_global_agg_psum(pair):
    run_both(pair, "select count(*), sum(o_totalprice) from orders")


def test_direct_group_by_psum(pair):
    run_both(pair, "select o_orderpriority, count(*) from orders "
                   "group by o_orderpriority order by o_orderpriority")


def test_sort_based_group_partial_final(pair):
    run_both(pair, "select o_custkey, count(*), sum(o_totalprice) from orders "
                   "group by o_custkey order by o_custkey limit 25")


def test_q6_distributed(pair):
    run_both(pair, """select sum(l_extendedprice * l_discount) as revenue
           from lineitem
           where l_shipdate >= date '1994-01-01'
             and l_shipdate < date '1995-01-01'
             and l_discount between 0.05 and 0.07 and l_quantity < 24""")


def test_q1_distributed(pair):
    run_both(pair, """select l_returnflag, l_linestatus, sum(l_quantity), count(*)
           from lineitem
           where l_shipdate <= date '1998-09-02'
           group by l_returnflag, l_linestatus
           order by l_returnflag, l_linestatus""")


def test_q3_distributed_broadcast_join(pair):
    run_both(pair, """select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
                  o_orderdate, o_shippriority
           from customer, orders, lineitem
           where c_mktsegment = 'BUILDING'
             and c_custkey = o_custkey and l_orderkey = o_orderkey
             and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
           group by l_orderkey, o_orderdate, o_shippriority
           order by revenue desc, o_orderdate limit 10""")


def test_semijoin_distributed(pair):
    run_both(pair, "select count(*) from orders where o_custkey in "
                   "(select c_custkey from customer where c_mktsegment = 'BUILDING')")


def test_scalar_subquery_distributed(pair):
    run_both(pair, "select count(*) from orders "
                   "where o_totalprice > (select avg(o_totalprice) from orders)")


def test_plain_scan_gather(pair):
    run_both(pair, "select n_name from nation where n_regionkey = 3 order by n_name")


def test_limit_distributed(pair):
    # no ORDER BY: the first 9 rows in shard order, the JAX mesh's rows
    rows = run_both(pair, "select o_orderkey from orders limit 9")
    assert len(rows) == 9


def test_distinct_distributed(pair):
    run_both(pair, "select distinct o_orderpriority from orders order by 1")


def test_window_gathering_exchange(pair):
    run_both(pair, "select o_custkey, o_orderkey, "
                   "row_number() over (partition by o_custkey order by o_orderkey) rn, "
                   "sum(o_totalprice) over (partition by o_custkey) tot "
                   "from orders order by o_custkey, o_orderkey limit 50")


def test_stddev_corr_distributed(pair):
    # moment accumulators merge by psum across shards
    run_both(pair, "select stddev_samp(o_totalprice), var_pop(o_totalprice), "
                   "corr(o_totalprice, o_custkey) from orders")


def test_min_by_distributed(pair):
    # no collective merges min_by / max_by / bitwise: the gather path
    run_both(pair, "select min_by(o_orderkey, o_totalprice), "
                   "max_by(o_orderkey, o_totalprice), bitwise_or_agg(o_orderkey) "
                   "from orders")


def test_grouped_new_aggs_distributed(pair):
    run_both(pair, "select o_orderpriority, stddev_samp(o_totalprice), "
                   "count_if(o_totalprice > 100000) from orders "
                   "group by o_orderpriority order by o_orderpriority")


def test_approx_percentile_distributed(pair):
    # non-decomposable aggregates: the raw rows gathered to one place
    run_both(pair, "select approx_percentile(o_totalprice, 0.5), "
                   "approx_distinct(o_custkey) from orders")


def test_rollup_distributed(pair):
    run_both(pair, "select o_orderpriority, count(*), sum(o_totalprice) from orders "
                   "group by rollup(o_orderpriority) order by o_orderpriority")


def test_grouping_sets_distributed(pair):
    run_both(pair, "select o_orderpriority, o_orderstatus, "
                   "grouping(o_orderpriority, o_orderstatus), count(*) from orders "
                   "group by grouping sets ((o_orderpriority), (o_orderstatus), ()) "
                   "order by 3, 1, 2")


def test_many_to_many_join_mesh(pair):
    # duplicate build keys: the expansion join on every shard
    run_both(pair, "select l.l_orderkey, count(*) from lineitem l "
                   "join orders o on l.l_orderkey = o.o_orderkey "
                   "join lineitem l2 on l2.l_orderkey = o.o_orderkey "
                   "group by l.l_orderkey order by l.l_orderkey limit 20")


def test_left_outer_join_mesh(pair):
    run_both(pair, "select c.c_custkey, o.o_orderkey from customer c "
                   "left join orders o on o.o_custkey = c.c_custkey "
                   "order by c.c_custkey, o.o_orderkey limit 30")


def test_multikey_join_mesh(pair):
    run_both(pair, "select count(*), sum(ps.ps_availqty) from lineitem l "
                   "join partsupp ps on l.l_partkey = ps.ps_partkey "
                   "and l.l_suppkey = ps.ps_suppkey")


def test_mesh_divergent_split_dictionaries(tmp_path):
    # parquet row groups with disjoint dictionaries on different shards:
    # codes remapped into one union dictionary
    pytest.importorskip("pyarrow")
    from trino_tpu import types as JT
    from trino_tpu.connectors.hive import write_parquet_table as jax_write
    from trino_tpu.page import page_from_pydict as jax_page
    from trino_tpu_torch import types as T
    from trino_tpu_torch.connectors.hive import write_parquet_table
    from trino_tpu_torch.page import page_from_pydict

    data = {"s": ["aa", "bb", "cc", "dd", "ee", "ff", "gg", "hh"],
            "x": [1, 2, 3, 4, 5, 6, 7, 8]}
    jwh, twh = tmp_path / "jax", tmp_path / "torch"
    jax_write(str(jwh), "t", jax_page([("s", JT.VARCHAR), ("x", JT.BIGINT)], data),
              rows_per_group=2)
    write_parquet_table(str(twh), "t", page_from_pydict(
        [("s", T.VARCHAR), ("x", T.BIGINT)], data), rows_per_group=2)
    sql = "select s, x from t where s <> 'aa' order by x"
    js = jsession.Session()
    js.create_catalog("hive", "hive", {"hive.warehouse-dir": str(jwh)})
    want = JMX.MeshExecutor(js.catalogs, JMX.default_mesh(8)).execute(js.plan(sql))
    s = Session(device="cpu")
    s.create_catalog("hive", "hive", {"hive.warehouse-dir": str(twh)})
    me = MX.MeshExecutor(s.catalogs, MX.default_mesh(8, "cpu"))
    got = me.execute(s.plan(sql)).to_pylist()
    assert got == want.to_pylist() == [
        ("bb", 2), ("cc", 3), ("dd", 4), ("ee", 5), ("ff", 6), ("gg", 7), ("hh", 8)]
    assert me._remaps, "the shards' dictionaries were not remapped"


PARTITIONED_SQL = [
    "select count(*), sum(l_extendedprice) from lineitem l "
    "join orders o on l.l_orderkey = o.o_orderkey",
    "select o.o_orderpriority, count(*) from lineitem l "
    "join orders o on l.l_orderkey = o.o_orderkey "
    "where o.o_totalprice > 1000 group by o.o_orderpriority "
    "order by o.o_orderpriority",
    # left outer, unmatched probe rows included
    "select c.c_custkey, o.o_orderkey from customer c "
    "left join orders o on o.o_custkey = c.c_custkey "
    "order by c.c_custkey, o.o_orderkey limit 25",
    # multi-key partitioned
    "select count(*) from lineitem l join partsupp ps "
    "on l.l_partkey = ps.ps_partkey and l.l_suppkey = ps.ps_suppkey",
]


def test_partitioned_join_mesh():
    # HASH-HASH distribution: both sides all_to_all on the join key
    js = jsession.tpch_session(SF, join_distribution_type="partitioned")
    jme = JMX.MeshExecutor(js.catalogs, JMX.default_mesh(8), dict(js._executor().config))
    s = tpch_session(SF, device="cpu", join_distribution_type="partitioned")
    me = MX.MeshExecutor(s.catalogs, MX.default_mesh(8, "cpu"), dict(s._executor().config))
    before = C.CALLS["all_to_all"]
    for sql in PARTITIONED_SQL:
        same_rows(me.execute(s.plan(sql)).to_pylist(),
                  jme.execute(js.plan(sql)).to_pylist())
    assert C.CALLS["all_to_all"] > before


def test_sketched_aggs_grouped_mesh(pair):
    # keyed approx_distinct merges its HLL registers by pmax: within the
    # declared error of the exact local count, and equal to the JAX mesh
    sql = ("select o_orderpriority, approx_distinct(o_custkey) from orders "
           "group by o_orderpriority")
    (js, _), (s, _) = pair
    local = dict(s.execute(sql).to_pylist())
    dist = dict(run_both(pair, sql, ordered=False))
    assert set(dist) == set(local)
    for k, est in dist.items():
        assert abs(est - local[k]) <= max(0.2 * local[k], 4), (k, est, local[k])


def test_partitioned_window_no_gather(pair, monkeypatch):
    """PARTITION BY windows hash-repartition instead of gathering."""
    calls = []
    orig = MX._MeshTraceCtx._hash_repartition

    def spy(self, b, keys):
        calls.append(tuple(keys))
        return orig(self, b, keys)

    monkeypatch.setattr(MX._MeshTraceCtx, "_hash_repartition", spy)
    run_both(pair, "select o_custkey, o_orderkey, "
                   "row_number() over (partition by o_custkey "
                   "order by o_orderdate, o_orderkey) rn "
                   "from orders order by o_custkey, rn, o_orderkey")
    assert ("o_custkey",) in calls, "window did not hash-repartition"


def test_range_partitioned_order_by(pair, monkeypatch):
    """ORDER BY is a RANGE exchange plus a sort on each shard: the shards
    in order are the total order, with no global sort."""
    calls = []
    orig = shuffle.range_buckets

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(shuffle, "range_buckets", spy)
    run_both(pair, "select o_orderkey, o_totalprice from orders "
                   "order by o_totalprice desc, o_orderkey")
    run_both(pair, "select l_orderkey, l_shipdate from lineitem "
                   "order by l_shipdate, l_orderkey")
    assert calls, "distributed sort did not range-partition"


def test_partitioned_distinct_stays_distributed(pair):
    run_both(pair, "select distinct o_custkey from orders order by o_custkey")


def test_mesh_intersect_except(pair):
    run_both(pair, "select o_custkey from orders where o_totalprice > 100000 "
                   "intersect select o_custkey from orders where o_orderdate < "
                   "date '1996-01-01' order by o_custkey")
    run_both(pair, "select o_custkey from orders "
                   "except select c_custkey from customer where c_acctbal < 0 "
                   "order by o_custkey")


def test_partitioned_semijoin(pair, monkeypatch):
    """Large filtering sides repartition both semi join sides."""
    calls = []
    orig = MX._MeshTraceCtx._partitioned_semijoin

    def spy(self, *a):
        calls.append(1)
        return orig(self, *a)

    monkeypatch.setattr(MX._MeshTraceCtx, "_partitioned_semijoin", spy)
    (_, jme), (_, me) = pair
    for ex in (jme, me):
        monkeypatch.setitem(ex.config, "broadcast_join_threshold_rows", 1)
    run_both(pair, "select o_orderkey from orders where o_custkey in "
                   "(select c_custkey from customer where c_acctbal > 0) "
                   "order by o_orderkey limit 50")
    run_both(pair, "select o_orderkey from orders where o_custkey not in "
                   "(select c_custkey from customer where c_acctbal > 5000) "
                   "order by o_orderkey limit 50")
    assert calls, "partitioned semi join never engaged"


def _memory_pair(setup):
    out = []
    for s in (jsession.Session(config={"join_distribution_type": "partitioned"}),
              Session(device="cpu", config={"join_distribution_type": "partitioned"})):
        s.create_catalog("memory", "memory", {})
        for sql in setup:
            s.execute(sql)
        out.append(s)
    return out


def test_skew_hints_size_shuffle_without_ladder():
    """A heavily skewed join key (90% of rows on one key), partitioned:
    one run of the retry ladder (the port's all_to_all sends each bucket
    at its size, so no chunk overflows and no re-run sizes one)."""
    rows = ", ".join(f"({1 if i % 10 else i}, {i})" for i in range(2000))
    js, s = _memory_pair([
        "create table skewed (k bigint, v bigint)",
        f"insert into skewed values {rows}",
        "create table dim (k bigint, name bigint)",
        "insert into dim values " + ", ".join(f"({i}, {i * 2})" for i in range(2000)),
    ])
    sql = "select count(*), sum(d.name) from skewed f, dim d where f.k = d.k"
    local = s.execute(sql).to_pylist()
    jme = JMX.MeshExecutor(js.catalogs, JMX.default_mesh(8), {
        "jit_fragments": True, "broadcast_join_threshold_rows": 1})
    me = MX.MeshExecutor(s.catalogs, MX.default_mesh(8, "cpu"),
                         {"broadcast_join_threshold_rows": 1})
    before = C.CALLS["all_to_all"]
    dist = me.execute(s.plan(sql)).to_pylist()
    assert dist == local == jme.execute(js.plan(sql)).to_pylist()
    assert C.CALLS["all_to_all"] > before, "the join was not partitioned"
    (run,) = [k for k in me.kernel_profile["kernels"] if k["mode"] == "mesh"]
    assert run["digest"] == "mesh:8/eager-0" and run["executions"] == 1


def test_partitioned_full_join_on_mesh():
    """FULL JOIN (left join plus the null-extended anti union), both sides
    hash-partitioned; NULL keys route to a stable shard and still emit."""
    js, s = _memory_pair([
        "create table fa (k bigint, a bigint)",
        "create table fb (k bigint, b bigint)",
        "insert into fa values " + ", ".join(f"({i}, {i})" for i in range(0, 1500, 2)),
        "insert into fb values " + ", ".join(f"({i}, {i * 3})" for i in range(0, 1500, 3)),
    ])
    sql = "select fa.k, fb.k, a, b from fa full join fb on fa.k = fb.k"
    local = sorted(map(repr, s.execute(sql).to_pylist()))
    jme = JMX.MeshExecutor(js.catalogs, JMX.default_mesh(8), {
        "jit_fragments": True, "broadcast_join_threshold_rows": 1})
    me = MX.MeshExecutor(s.catalogs, MX.default_mesh(8, "cpu"),
                         {"broadcast_join_threshold_rows": 1})
    dist = sorted(map(repr, me.execute(s.plan(sql)).to_pylist()))
    assert dist == local == sorted(map(repr, jme.execute(js.plan(sql)).to_pylist()))


def test_tablesample_positions_are_a_shards(pair):
    """TABLESAMPLE masks each shard's rows by their positions in the
    shard (as the JAX mesh's devices do), so its sample is the JAX
    mesh's, not the one-device sample."""
    run_both(pair, "select count(*), sum(l_quantity) from lineitem tablesample bernoulli (10)")


# --- beyond the reference's cases: the port's mesh against its one device ---


@pytest.fixture(scope="module")
def sf01():
    return (tpch_session(0.01, device="cpu", result_cache=False),
            tpch_session(0.01, device="cpu", result_cache=False,
                         distributed=True, num_devices=8))


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_query_over_eight_shards_equals_one_device(sf01, q):
    """Every TPC-H query over 8 CPU shards: the one-device page, byte for
    byte (SF 0.01, where every table spans several shards)."""
    from tpch_sql import QUERIES
    from trino_tpu_torch import convert

    one, mesh = sf01
    sql = QUERIES[q][0]
    convert.assert_pages_identical(one.execute(sql), mesh.execute(sql))


@pytest.mark.parametrize("sql", [
    "select c_custkey, w from customer cross join unnest(split(c_mktsegment, 'U')) t(w) "
    "order by 1, 2",
    "select w, count(*) from customer cross join unnest(split(c_mktsegment, 'U')) t(w) "
    "group by w order by 1",
    "select o_custkey, array_agg(o_orderstatus) from orders group by o_custkey "
    "order by o_custkey",
    "select o_orderpriority, listagg(o_orderstatus, ',') from orders "
    "where o_orderkey < 300 group by o_orderpriority order by 1",
])
def test_dictionaries_built_per_shard_are_unified(sf01, sql):
    """UNNEST's element dictionary and array_agg's / listagg's values are
    built from each shard's rows: the mesh unifies them into one
    dictionary, so the rows are the one-device rows.  (The JAX mesh
    cannot run the UNNEST: its host staging meets traced arrays.)"""
    one, mesh = sf01
    assert mesh.execute(sql).to_pylist() == one.execute(sql).to_pylist()


# --- the shuffle, the collectives ------------------------------------------


def _lanes(rng, n, dtype=np.int64, lo=-(1 << 40), hi=1 << 40):
    v = rng.integers(lo, hi, n).astype(dtype)
    ok = rng.random(n) > 0.1
    return v, ok


@pytest.mark.parametrize("ndev", [2, 7, 8])
@pytest.mark.parametrize("force_hash,ncols", [(False, 1), (True, 1), (False, 2)])
def test_bucket_of_matches_jax(ndev, force_hash, ncols):
    rng = np.random.default_rng(13 + ndev + ncols)
    n = 3000
    cols = [_lanes(rng, n) for _ in range(ncols)]
    sel = rng.random(n) > 0.2
    jb, jok = jshuffle.bucket_of([(jnp.asarray(v), jnp.asarray(o)) for v, o in cols],
                                 jnp.asarray(sel), ndev, force_hash)
    tb, tok = shuffle.bucket_of([(torch.from_numpy(v), torch.from_numpy(o)) for v, o in cols],
                                torch.from_numpy(sel), ndev, force_hash)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(np.asarray(jok), tok.numpy())
    assert tb.dtype == torch.int32 and set(tb.tolist()) <= set(range(ndev))
    if ncols == 1 and not force_hash:
        # the host mirror the JAX package measures skew with agrees
        assert np.array_equal(jshuffle.mix64_np(cols[0][0]).view(np.int64),
                              shuffle._mix64(torch.from_numpy(cols[0][0])).numpy())


@pytest.mark.parametrize("ascending,nulls_first", [(True, False), (False, True)])
def test_range_buckets_match_jax(ascending, nulls_first):
    """Bucket per row on 4 shards against the JAX function run under a
    shard_map over 4 devices (equal samples, equal splitters)."""
    from trino_tpu.ops.sort import SortKey as JKey
    from trino_tpu_torch.ops.sort import SortKey

    ndev, n = 4, 500
    rng = np.random.default_rng(5)
    v = rng.integers(0, 300, (ndev, n)).astype(np.int64)
    ok = rng.random((ndev, n)) > 0.05
    sel = rng.random((ndev, n)) > 0.3
    jkey = JKey("k", ascending, nulls_first)

    def body(v, ok, sel):
        b = jshuffle.range_buckets((v[0], ok[0]), jkey, sel[0], ndev, JMX.AXIS)
        return b[None]

    fn = JMX._shard_map(body, JMX.default_mesh(ndev), (JMX.P_(JMX.AXIS),) * 3,
                        JMX.P_(JMX.AXIS))
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(ok), jnp.asarray(sel)))
    got = shuffle.range_buckets(
        [(torch.from_numpy(v[d]), torch.from_numpy(ok[d])) for d in range(ndev)],
        SortKey("k", ascending, nulls_first), [torch.from_numpy(sel[d]) for d in range(ndev)],
        ndev, [CPU] * ndev, CPU)
    for d in range(ndev):
        live = sel[d]
        assert np.array_equal(got[d].numpy()[live], want[d][live]), d


def test_repartition_matches_jax():
    """Each destination receives the JAX all_to_all's rows, in its order
    (the JAX chunks' dead slots dropped), wide decimal limbs included."""
    ndev, n, chunk = 4, 64, 64
    rng = np.random.default_rng(11)
    a = rng.integers(-1000, 1000, (ndev, n)).astype(np.int64)
    w = rng.integers(-(1 << 60), 1 << 60, (ndev, n, 2)).astype(np.int64)
    f = rng.random((ndev, n))
    ok = rng.random((ndev, n)) > 0.2
    bucket = rng.integers(0, ndev, (ndev, n)).astype(np.int32)
    keep = rng.random((ndev, n)) > 0.25

    def body(a, w, f, ok, bucket, keep):
        lanes = {"a": (a[0], ok[0]), "w": (w[0], ok[0]), "f": (f[0], ok[0])}
        out, sel, _ = jshuffle.repartition(lanes, keep[0], bucket[0], keep[0], ndev,
                                           chunk, JMX.AXIS)
        return tuple(out[s][0][None] for s in ("a", "w", "f")) + (
            out["a"][1][None], sel[None])

    fn = JMX._shard_map(body, JMX.default_mesh(ndev), (JMX.P_(JMX.AXIS),) * 6,
                        (JMX.P_(JMX.AXIS),) * 5)
    ja, jw, jf, jok, jsel = (np.asarray(x) for x in fn(
        *(jnp.asarray(x) for x in (a, w, f, ok, bucket, keep))))
    parts = [({"a": (torch.from_numpy(a[d]), torch.from_numpy(ok[d])),
               "w": (torch.from_numpy(w[d]), torch.from_numpy(ok[d])),
               "f": (torch.from_numpy(f[d]), torch.from_numpy(ok[d]))},
              torch.from_numpy(bucket[d]), torch.from_numpy(keep[d]))
             for d in range(ndev)]
    before = C.CALLS["all_to_all"]
    lanes, matrix = shuffle.repartition(parts, [CPU] * ndev, lambda m: m.tolist())
    assert C.CALLS["all_to_all"] - before == 3  # one a dtype: int64, float64, bool
    for d in range(ndev):
        live = jsel[d]
        assert sum(row[d] for row in matrix) == live.sum()
        assert np.array_equal(lanes[d]["a"][0].numpy(), ja[d][live])
        assert np.array_equal(lanes[d]["w"][0].numpy(), jw[d][live])
        assert np.array_equal(lanes[d]["f"][0].numpy(), jf[d][live])
        assert np.array_equal(lanes[d]["a"][1].numpy(), jok[d][live])


def test_collectives_fold_in_shard_order():
    parts = [torch.tensor([1.0, -2.0]), torch.tensor([3.0, 5.0]), torch.tensor([-1.0, 0.5])]
    before = dict(C.CALLS)
    assert C.psum(parts, CPU).tolist() == [3.0, 3.5]
    assert C.pmin(parts, CPU).tolist() == [-1.0, -2.0]
    assert C.pmax(parts, CPU).tolist() == [3.0, 5.0]
    assert C.all_gather(parts, CPU).tolist() == [1.0, -2.0, 3.0, 5.0, -1.0, 0.5]
    send = [torch.arange(6).reshape(2, 3), torch.arange(10, 14).reshape(2, 2)]
    recv = C.all_to_all(send, [[1, 2], [2, 0]], [CPU, CPU])
    assert recv[0].tolist() == [[0, 10, 11], [3, 12, 13]]
    assert recv[1].tolist() == [[1, 2], [4, 5]]
    assert {k: C.CALLS[k] - before[k] for k in C.CALLS} == {
        "all_gather": 1, "psum": 1, "pmin": 1, "pmax": 1, "all_to_all": 1}


def test_default_mesh_places_shards():
    assert MX.default_mesh(8, "cpu") == [CPU] * 8
    assert MX.default_mesh(0, "cpu") == [CPU]
    if not torch.cuda.is_available():
        # no quiet CPU mesh
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MX.default_mesh(8)


# --- the timeline merge and the straggler detector --------------------------


def _tasks():
    frames = [
        {"operatorId": 0, "planNodeId": "0", "operatorType": "TableScan",
         "inputRows": 100, "outputRows": 100, "wallS": 0.5, "estimatedRows": 90},
        {"operatorId": 1, "planNodeId": "1", "operatorType": "Aggregate",
         "inputRows": 100, "outputRows": 4, "wallS": 0.25, "estimatedRows": None},
    ]
    walls = [1.0, 1.1, 0.9, 1.05, 6.0]
    return [{"taskId": "q1.%d.%d" % (i % 2, i), "nodeId": "node-%d" % i,
             "operatorStats": {"operators": [dict(f, wallS=f["wallS"] * w) for f in frames],
                               "wallS": w, "outputRows": 4 + i,
                               "blockedExchangeS": 0.01 * i, "blockedMemoryS": 0.0}}
            for i, w in enumerate(walls)]


def test_timeline_from_tasks_matches_jax():
    from trino_tpu.obs import opstats as jops
    from trino_tpu_torch.obs import opstats

    jdet, det = jops.StragglerDetector(factor=2.0), opstats.StragglerDetector(factor=2.0)
    want = jops.timeline_from_tasks(_tasks(), detector=jdet)
    got = opstats.timeline_from_tasks(_tasks(), detector=det)
    assert got == want
    assert det.flags == jdet.flags and det.flags[0]["task"] == "q1.0.4"
    assert opstats.task_rollup([]) == jops.task_rollup([])
    assert opstats.merge_frames([]) == jops.merge_frames([])


def test_straggler_detector_matches_jax():
    from trino_tpu.obs import opstats as jops
    from trino_tpu_torch.obs import opstats

    for factor, min_s in ((2.0, 0.5), (1.0, 0.0), (3.5, 2.0)):
        j = jops.StragglerDetector(factor=factor, min_s=min_s)
        t = opstats.StragglerDetector(factor=factor, min_s=min_s)
        sib = [1.0, 1.2, 0.8, 1.1]
        for elapsed in (0.2, 1.0, 1.5, 2.4, 9.0):
            assert t.score(elapsed, sib) == j.score(elapsed, sib)
            assert t.should_hedge(elapsed, sib) == j.should_hedge(elapsed, sib)
        assert t.score(1.0, []) == j.score(1.0, []) == 0.0
        a = t.record_hedge("1", "q9.1.3", "http://w", 4.0, sib)
        b = j.record_hedge("1", "q9.1.3", "http://w", 4.0, sib)
        assert a == b
        assert t.observe_node_gone("w-1", ["q9.1.3"]) == j.observe_node_gone("w-1", ["q9.1.3"])
        tasks = [{"taskId": "q9.1.%d" % i, "nodeId": "n", "wallS": w}
                 for i, w in enumerate([1.0, 1.1, 0.9, 7.0])]
        assert t.observe_stage("1", tasks) == j.observe_stage("1", tasks)
        assert t.flags == j.flags


def test_compile_filter_project_matches_jax():
    from trino_tpu.expr import ir as jir
    from trino_tpu.ops.filter_project import compile_filter_project as jcfp
    from trino_tpu import types as JT
    from trino_tpu_torch.expr import ir
    from trino_tpu_torch.ops.filter_project import compile_filter_project
    from trino_tpu_torch import types as T

    rng = np.random.default_rng(3)
    n = 200
    a, aok = rng.integers(-50, 50, n), rng.random(n) > 0.1
    b = rng.integers(0, 9, n)
    sel = rng.random(n) > 0.2

    def exprs(ir, t):
        col = lambda c: ir.ColumnRef(t.BIGINT, c)  # noqa: E731
        pred = ir.Comparison(">", col("a"), ir.Constant(t.BIGINT, 0))
        return pred, [("s", ir.Call(t.BIGINT, "add", (col("a"), col("b")))), ("b", col("b"))]

    jp, jproj = exprs(jir, JT)
    tp, tproj = exprs(ir, T)
    jcols = {"a": (jnp.asarray(a), jnp.asarray(aok)),
             "b": (jnp.asarray(b), jnp.ones(n, bool))}
    tcols = {"a": (torch.from_numpy(a), torch.from_numpy(aok)),
             "b": (torch.from_numpy(b), torch.ones(n, dtype=torch.bool))}
    for f_j, f_t in ((jp, tp), (None, None)):
        jout, jsel = jcfp(f_j, jproj)(jcols, jnp.asarray(sel))
        tout, tsel = compile_filter_project(f_t, tproj)(tcols, torch.from_numpy(sel))
        assert np.array_equal(np.asarray(jsel), tsel.numpy())
        for k in ("s", "b"):
            assert np.array_equal(np.asarray(jout[k][0]), tout[k][0].numpy())
            assert np.array_equal(np.asarray(jout[k][1]), tout[k][1].numpy())


def test_shard_scans_generated_on_the_device_equal_the_host_splits():
    """Each shard's TPC-H scan generated on the device (its one split, a
    contiguous range) holds the host generator's lanes for that split,
    bit for bit, dictionaries included."""
    from trino_tpu_torch.exec.local import _TraceCtx
    from trino_tpu_torch.plan import nodes as P

    s = tpch_session(0.01, device="cpu")
    plan = s.plan("select l_orderkey, l_quantity, l_shipdate, l_returnflag, "
                  "l_extendedprice from lineitem")
    scan = plan
    while not isinstance(scan, P.TableScan):
        scan = scan.sources[0]
    lanes = {}
    for gen in (True, False):
        me = MX.MeshExecutor(s.catalogs, MX.default_mesh(8, "cpu"),
                             {"device_generation": gen})
        scans = me._load_sharded_scans(plan)
        me.dicts = scans.dicts
        ctx = me._new_ctx(scans)
        lanes[gen] = ([_TraceCtx._visit_tablescan(c, scan).lanes for c in ctx.shards],
                      scans.dicts, me.kernel_profile)
    assert lanes[True][2].get("deviceGeneratedScans") == 8
    assert lanes[False][2].get("deviceGeneratedScans") is None
    for d in lanes[True][1]:
        assert np.array_equal(lanes[True][1][d], lanes[False][1][d])
    for a, b in zip(lanes[True][0], lanes[False][0]):
        assert set(a) == set(b) and next(iter(a.values()))[0].shape[0] > 0
        for sym in a:
            assert torch.equal(a[sym][0], b[sym][0]) and torch.equal(a[sym][1], b[sym][1])
