"""The port's streaming (bounded-working-set) execution against the JAX
package.

Every statement of tests/test_streaming.py runs through both packages'
sessions with the same properties (the JAX side with
device_generation=False: the port has no on-device generator); the
pages must be byte-identical, float64 columns at relative 1e-12.  The
out-of-core gate must take the JAX package's decisions (in memory, which
spill, or streaming, with the same fragment count and tiles per source
fragment) for the 22 TPC-H queries planned at SF10 under the default
8 GiB limit and for the statements of chip_smoke.py's out-of-core phase
under 1 GiB and 256 MiB; that part plans only and generates no data.
The port runs on the CPU (device="cpu").
"""
import math

import pytest
import torch

import chip_smoke
from tpch_sql import QUERIES
from trino_tpu.exec import spill as jax_spill
from trino_tpu.exec import streaming as jax_streaming
from trino_tpu.session import tpch_session as _jax_session
from trino_tpu.utils.memory import ExceededMemoryLimitError as JaxLimitError
from trino_tpu_torch import convert
from trino_tpu_torch.exec import local as torch_local
from trino_tpu_torch.exec import scan
from trino_tpu_torch.exec import spill as torch_spill
from trino_tpu_torch.exec import streaming as torch_streaming
from trino_tpu_torch.session import tpch_session as _torch_session
from trino_tpu_torch.utils.memory import ExceededMemoryLimitError

RTOL = 1e-12
Q = {n: QUERIES[n][0] for n in (1, 3, 6)}
COUNT_DISTINCT_SUPP = "select count(distinct l_suppkey) from lineitem"
PURE_SORT = ("select l_orderkey, l_extendedprice from lineitem "
             "order by l_extendedprice desc, l_orderkey")


def jax_session(sf, **props):
    return _jax_session(sf, device_generation=False, result_cache=False, **props)


def torch_session(sf, **props):
    # host generation, as jax_session's: the out-of-core gate counts the
    # on-device generator's temporaries (tests/test_torch_tpch_device.py
    # holds the gates with it on)
    return _torch_session(sf, device="cpu", device_generation=False, **props)


def run_both(sf, sql, **props):
    """The page of each package, the port's session beside its page."""
    ts = torch_session(sf, **props)
    b = ts.execute(sql)
    a = jax_session(sf, **props).execute(sql)
    convert.assert_pages_match(a, b, RTOL)
    return ts, b


# ---------------------------------------------------------------------------
# statements of tests/test_streaming.py


STREAMED = {
    # name: (sf, limit, sql, extra properties, path the port takes)
    "q6": (0.05, 3_000_000, Q[6], {}, "stream"),
    "q1": (0.05, 3_000_000, Q[1], {}, "stream"),
    "q3": (0.05, 3_000_000, Q[3], {}, "stream"),
    "count_distinct_rewritten": (0.05, 1_000_000, COUNT_DISTINCT_SUPP, {}, "stream"),
    "count_distinct_spilled": (0.05, 1_000_000, COUNT_DISTINCT_SUPP,
                               {"distinct_agg_rewrite": False}, "distinct-spill"),
    "global_count_distinct": (0.05, 1 << 20,
                              "select count(distinct l_orderkey) from lineitem", {},
                              "stream"),
    "pure_sort_spills": (0.01, 600_000, PURE_SORT, {}, "sort-spill"),
}


@pytest.mark.parametrize("name", sorted(STREAMED))
def test_streamed_statements_match_jax(name):
    sf, limit, sql, props, path = STREAMED[name]
    ts, _ = run_both(sf, sql, query_max_memory_bytes=limit, **props)
    prof = ts.last_kernel_profile
    assert prof.get("outOfCore") == path
    js = jax_session(sf, query_max_memory_bytes=limit, **props)
    want = decision(jax_spill, jax_streaming, js, sql, limit)
    assert decision(torch_spill, torch_streaming, ts, sql, limit) == want
    assert want[0] == path
    if path == "stream":
        assert max(prof["streamedTiles"].values()) > 1, prof["streamedTiles"]
    assert not prof.get("forcedStreaming")


def test_streamed_pages_equal_the_in_memory_pages():
    """Q6 and Q1 give the in-memory page when streamed (Q1's avg and
    wide-decimal sums merge across tiles exactly)."""
    free = torch_session(0.05)
    for n in (6, 1):
        tight = torch_session(0.05, query_max_memory_bytes=3_000_000)
        convert.assert_pages_identical(free.execute(Q[n]), tight.execute(Q[n]))
        assert tight.last_kernel_profile["outOfCore"] == "stream"


def test_count_distinct_refused_alike_without_spill():
    props = dict(query_max_memory_bytes=1_000_000, distinct_agg_rewrite=False,
                 spill_enabled=False)
    with pytest.raises(JaxLimitError) as je:
        jax_session(0.05, **props).execute(COUNT_DISTINCT_SUPP)
    with pytest.raises(ExceededMemoryLimitError) as te:
        torch_session(0.05, **props).execute(COUNT_DISTINCT_SUPP)
    assert str(te.value) == str(je.value)


def test_count_distinct_rewrite_plan_shape_and_parity():
    sql = "select count(distinct l_suppkey) c from lineitem where l_quantity < 10"
    a = torch_session(0.01).execute(sql)
    b = torch_session(0.01, distinct_agg_rewrite=False).execute(sql)
    convert.assert_pages_identical(a, b)
    assert "Distinct" in torch_session(0.01).explain(sql)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_double_buffer_depth_keeps_the_page(depth):
    ts, page = run_both(0.05, Q[1], query_max_memory_bytes=3_000_000,
                        double_buffer_depth=depth)
    prof = ts.last_kernel_profile
    assert prof["outOfCore"] == "stream"
    assert prof["preuploads"] == sum(prof["streamedTiles"].values())


def test_session_accepts_the_memory_properties():
    ts = torch_session(0.01, query_max_memory_bytes=1 << 30, spill_enabled=False,
                       memory_blocked_timeout_s=0.5, double_buffer_depth=2)
    assert ts.memory_manager.general.size == 1 << 30
    ex = ts._executor()
    assert ex.config["memory_limit_bytes"] == 1 << 30
    assert ex.config["spill_enabled"] is False
    assert ex.config["memory_blocked_timeout_s"] == 0.5
    assert ex.config["double_buffer_depth"] == 2
    assert torch_session(0.01).properties.get("query_max_memory_bytes") == 8 << 30


# ---------------------------------------------------------------------------
# the memory signals that force streaming


def test_out_of_memory_error_forces_streaming(monkeypatch):
    """A torch.OutOfMemoryError inside an in-memory run re-runs the plan
    streamed: the page is the streamed one, counted once."""
    ref = torch_session(0.01).execute(Q[1])
    real = torch_local.LocalExecutor._run_plan
    fired = []

    def once(self, *a, **k):
        if not fired:
            fired.append(1)
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(self, *a, **k)

    monkeypatch.setattr(torch_local.LocalExecutor, "_run_plan", once)
    ts = torch_session(0.01)
    page = ts.execute(Q[1])
    convert.assert_pages_identical(ref, page)
    assert fired and ts.last_kernel_profile["forcedStreaming"] == 1
    assert "outOfCore" not in ts.last_kernel_profile  # the gate kept it in memory


def test_out_of_memory_error_without_a_tileable_plan_propagates(monkeypatch):
    def boom(self, *a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(torch_local.LocalExecutor, "_run_plan", boom)
    with pytest.raises(torch.OutOfMemoryError):
        torch_session(0.01).execute("select n_name from nation")


def test_other_errors_never_force_streaming(monkeypatch):
    def boom(self, *a, **k):
        raise RuntimeError("not a memory signal")

    monkeypatch.setattr(torch_local.LocalExecutor, "_run_plan", boom)
    ts = torch_session(0.01)
    with pytest.raises(RuntimeError, match="not a memory signal"):
        ts.execute(Q[6])


def test_device_tier_refusal_forces_streaming():
    """The device-tier reservation failing (the pool smaller than the
    estimate) streams the query instead of running it."""
    ref = torch_session(0.01).execute(Q[6])
    ts = torch_session(0.01)
    ts.memory_manager.device.size = 1_000
    page = ts.execute(Q[6])
    convert.assert_pages_identical(ref, page)
    assert ts.last_kernel_profile["forcedStreaming"] == 1
    assert ts.memory_manager.device.reserved == 0
    assert ts.memory_manager.general.reserved == 0


# ---------------------------------------------------------------------------
# the gate's decisions against the JAX package's (planning only)


def decision(spill, streaming, session, sql, limit):
    """The out-of-core path a package's gate takes for one statement:
    ("memory",), a spill with its partition or batch count, or
    ("stream", fragments, ((table, tiles), ...))."""
    ex = session._executor()
    plan = session.plan(sql)
    sp = spill.plan_distinct_spill(ex, plan, limit)
    if sp is not None:
        return ("distinct-spill", sp[-1])
    frags = streaming.plan_streaming(ex, plan, limit)
    if frags is not None:
        budget = max(limit // streaming.SAFETY_FACTOR, 1)
        tiles = []
        for f in frags:
            if f.partitioning == "source":
                (idx, (cat, tab, _c)), = f.scan_tables.items()
                node = streaming._find_scan_nodes(f.root)[idx]
                tiles.append((tab, math.ceil(
                    streaming._est_scan_bytes(ex, cat, tab, node) / budget)))
        return ("stream", len(frags), tuple(tiles))
    sp = spill.plan_spill(ex, plan, limit)
    if sp is not None:
        return ("aggregation-spill", len(sp[2]), sp[3])
    sp = spill.plan_join_spill(ex, plan, limit)
    if sp is not None:
        return ("join-spill", sp[-1])
    if spill.plan_sort_spill(ex, plan, limit) is not None:
        return ("sort-spill",)
    sp = spill.plan_window_spill(ex, plan, limit)
    if sp is not None:
        return ("window-spill", sp[-1])
    return ("memory",)


@pytest.fixture(scope="module")
def sf10():
    sessions = {}

    def get(**props):
        key = tuple(sorted(props.items()))
        if key not in sessions:
            sessions[key] = (jax_session(10.0, **props), torch_session(10.0, **props))
        return sessions[key]

    return get


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_tpch_sf10_decisions_match_jax_under_8gib(sf10, q):
    js, ts = sf10()
    want = decision(jax_spill, jax_streaming, js, QUERIES[q][0], 8 << 30)
    assert decision(torch_spill, torch_streaming, ts, QUERIES[q][0], 8 << 30) == want
    assert want == (("stream", 3, (("lineitem", 2),)) if q == 1 else ("memory",))


OOC_CASES = [(limit, props, label, sql)
             for limit, props, stmts in chip_smoke._ooc_statements()
             for label, sql in stmts]


@pytest.mark.parametrize("limit,props,label,sql", OOC_CASES,
                         ids=[f"{c[2]}-{c[0] >> 20}MiB" for c in OOC_CASES])
def test_ooc_decisions_match_jax(sf10, limit, props, label, sql):
    js, ts = sf10(**props)
    want = decision(jax_spill, jax_streaming, js, sql, limit)
    got = decision(torch_spill, torch_streaming, ts, sql, limit)
    assert got == want
    # chip_smoke.py holds the card to the same decisions
    assert chip_smoke.OOC_WANT[(label, limit)] == want
    if want[0] == "stream":
        frags = torch_streaming.plan_streaming(ts._executor(), ts.plan(sql), limit)
        tiles = torch_streaming.tile_counts(ts._executor(), frags, limit)
        assert sorted(tiles.values()) == sorted(t for _, t in want[2])


def test_partitioned_join_fragment_refused_alike():
    """Q18 under a tight limit with its lineitem-orders join partitioned
    (as at SF10, where orders pass the broadcast threshold; here the
    threshold is lowered to SF 0.1's orders): both packages plan to
    stream it, and the join fragment, which gathers every lineitem row
    the tiles send it, refuses with the same error.  With broadcast
    joins the same statement streams (chip_smoke.py's Q18-BROADCAST)."""
    props = dict(query_max_memory_bytes=(1 << 30) // 100,
                 broadcast_join_threshold_rows=100_000)
    with pytest.raises(JaxLimitError) as je:
        jax_session(0.1, **props).execute(QUERIES[18][0])
    with pytest.raises(ExceededMemoryLimitError) as te:
        torch_session(0.1, **props).execute(QUERIES[18][0])
    assert str(te.value) == str(je.value)
    ts, _ = run_both(0.1, QUERIES[18][0], query_max_memory_bytes=(1 << 30) // 100,
                     join_distribution_type="broadcast")
    assert ts.last_kernel_profile["outOfCore"] == "stream"


# ---------------------------------------------------------------------------
# the memory manager (memory/pools.py): revoke -> block -> clean error


def test_memory_manager_revokes_then_blocks_then_fails():
    import threading

    from trino_tpu_torch.memory import LocalMemoryManager, QueryKilledError

    m = LocalMemoryManager(1000)
    freed = []
    m.register_revocable("cache", 600, lambda: freed.append(1) or 600)
    m.reserve("a", 900, tier="device")
    # the device tier is full: the revocable listener runs first, then
    # the reservation fails cleanly (timeout 0)
    with pytest.raises(ExceededMemoryLimitError, match="device \\(HBM\\) memory limit of 1000"):
        m.reserve("b", 200, tier="device")
    assert freed == [1]
    # blocked: a free by another query lets the reservation through
    threading.Timer(0.1, lambda: m.free("a", tier="device")).start()
    m.reserve("b", 200, tier="device", timeout=5.0)
    assert m.device.reserved == 200
    # the host tier spills into the reserved pool for one query
    m.reserve("c", 1000)
    m.reserve("c", 50)
    assert m.reserved.query_bytes("c") == 50
    with pytest.raises(ExceededMemoryLimitError, match="host memory limit"):
        m.reserve("d", 60)
    m.free_query("c")
    assert m.general.reserved == 0 and m.reserved.reserved == 0
    # a query the killer picks fails its blocked reservation
    m.reserve("e", 1000)
    threading.Timer(0.1, lambda: m.kill("f", "chosen by the killer")).start()
    with pytest.raises(QueryKilledError, match="chosen by the killer"):
        m.reserve("f", 500, timeout=5.0)


def test_session_registers_the_scan_cache_by_what_it_holds():
    ts = torch_session(0.01)
    ts.execute(Q[6])
    ts._executor()
    (qid, nbytes, listener), = ts.memory_manager._revocable
    assert qid == "scan-cache" and nbytes == ts._scan_cache.bytes > 0
    assert nbytes < ts._scan_cache.max_bytes
    assert listener() == nbytes and ts._scan_cache.bytes == 0


def test_duplicate_dictionary_entries_group_apart_in_both_packages():
    """Shared with the reference (ROADMAP.md, C): the generator gives
    o_clerk one dictionary entry per row, and grouping, DISTINCT and
    count(DISTINCT) compare codes, so equal clerks on different codes
    stay apart: 15,000 where SQL says 10.  Merged tiles and spill batches
    unify such a dictionary (merge_pages_to_arrays keeps each string
    once), so a streamed run would answer otherwise; both packages give
    the same pages in memory."""
    sql = "select count(distinct o_clerk) from orders"
    a = jax_session(0.01).execute(sql)
    ts = torch_session(0.01)
    b = ts.execute(sql)
    convert.assert_pages_identical(a, b)
    clerks = ts.execute("select o_clerk from orders").to_pylist()
    assert b.to_pylist() == [(len(clerks),)] == [(15000,)]
    assert len(set(clerks)) == 10


def test_prefetch_threads_share_one_run_cache(monkeypatch):
    """Twelve prefetch threads (more than this machine's cores) load
    Q3's tiles at once under a short switch interval: every tile reads
    the run's remote inputs, which must be merged and cached once per
    fragment (the run's lock), and the page stays the in-memory one."""
    import sys

    ref = torch_session(0.05).execute(Q[3])
    merged = []
    real_merge = scan._merge_remote

    def merge(node, pages):
        merged.append(node.fragment_id)
        return real_merge(node, pages)

    monkeypatch.setattr(scan, "_merge_remote", merge)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = torch_session(0.05, query_max_memory_bytes=3_000_000,
                           double_buffer_depth=12)
        page = ts.execute(Q[3])
    finally:
        sys.setswitchinterval(old)
    convert.assert_pages_identical(ref, page)
    assert merged and len(merged) == len(set(merged)), merged
    assert max(ts.last_kernel_profile["streamedTiles"].values()) >= 10


# ---------------------------------------------------------------------------
# a worker's streamed PARTIAL fragment on a cluster


CLUSTER_LIMIT = 300_000
# a wide sum whose partial state spans several tiles of each worker: a
# product of up to about 5.5e17 units a row, the column's sum past the
# int64 range, so the high limbs of the accumulator carry
WIDE_GLOBAL = ("select sum(l_extendedprice * l_extendedprice * l_quantity) as s, "
               "avg(l_extendedprice) as a, count(*) as n from lineitem")
CLUSTER_STATEMENTS = {"q1": Q[1], "q3": Q[3], "q6": Q[6], "wide_global_sum": WIDE_GLOBAL}


@pytest.fixture(scope="module")
def cluster():
    from trino_tpu_torch.testing import DistributedQueryRunner

    with DistributedQueryRunner(workers=2, device="cpu",
                                properties={"query_max_memory_bytes": CLUSTER_LIMIT}) as r:
        yield r


@pytest.fixture(scope="module")
def oracle_db():
    import sqlite3

    from oracle import load_tpch

    conn = sqlite3.connect(":memory:")
    load_tpch(conn, 0.01, ["customer", "orders", "lineitem"])
    return conn


def _exact(rows, page):
    """Rows with each decimal column's value as the Decimal it states."""
    from decimal import Decimal

    dec = [c.type.is_decimal for c in page.columns]
    return [tuple(Decimal(str(v)) if d and v is not None else v for v, d in zip(r, dec))
            for r in rows]


@pytest.mark.parametrize("name", sorted(CLUSTER_STATEMENTS))
def test_a_cluster_streams_worker_partials_to_the_one_node_answer(
        cluster, oracle_db, monkeypatch, name):
    """Under a 300,000-byte limit each worker streams its PARTIAL
    fragment in tiles (its own splits, cut finer), the tiles merge into
    one partial state with every accumulator lane the FINAL step reads
    (Q1's wide sums and averages included), and the answer is the
    one-node session's, exactly, and the sqlite oracle's (to the
    oracle's floating point)."""
    import collections

    from oracle import assert_rows_match
    from tpch_sql import oracle_dialect
    from trino_tpu_torch.utils.tracing import TRACER

    sql = CLUSTER_STATEMENTS[name]
    monkeypatch.setattr(TRACER, "spans", collections.deque(maxlen=1 << 20))
    rows = cluster.rows(sql)
    tiles = [s for s in TRACER.spans if s.name == "stream_tile"]
    by_task = collections.Counter(s.parent_id for s in tiles)
    assert len(by_task) >= 2 and min(by_task.values()) >= 2, by_task
    assert all(s.attributes["rows"] > 0 for s in tiles)
    page = torch_session(0.01).execute(sql)
    assert _exact(rows, page) == _exact(page.to_pylist(), page)
    if name == "wide_global_sum":
        assert page.to_pylist()[0][0] * 10 ** 6 > 2 ** 63
    # sqlite sums in binary floating point, and both sides are rounded
    # to 4 places before the comparison: one unit of the 4th place apart
    expected = oracle_db.execute(oracle_dialect(sql)).fetchall()
    assert_rows_match(rows, expected, tol=1e-4 + 1e-12, ordered=True)
