"""The port's spans inside a query: scan loads, the host's line count, on-device
scan generation, operator visits, kernel launches, device syncs and the
retry ladder (trino_tpu_torch/utils/tracing.TRACER), at TPC-H SF 0.01 on the
CPU.  Every span is on the same clock as torch.profiler's events."""
import time

import pytest
import torch

import trino_tpu_torch.session as tsession
from trino_tpu_torch.runtime.supervisor import Breadcrumb, DeviceSupervisor
from trino_tpu_torch.utils.tracing import TRACER, Tracer

Q3 = """select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
o_orderdate, o_shippriority from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey and l_orderkey = o_orderkey
and o_orderdate < date '{date}' and l_shipdate > date '{date}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10"""

# a decimal product near the int64 range: the wide-multiply check fires
# and the ladder re-runs the plan on the 128-bit kernels
WIDE = ("select sum(o_totalprice * o_totalprice * o_totalprice * o_totalprice) "
        "from orders")


@pytest.fixture
def session():
    s = tsession.tpch_session(0.01, device="cpu", result_cache=False)
    s.tracer.clear()
    return s


def _spans(s, name=None):
    return [sp for sp in s.tracer.spans if name is None or sp.name == name]


def _by_id(s):
    return {sp.span_id: sp for sp in s.tracer.spans}


def _parent(s, sp):
    return _by_id(s).get(sp.parent_id)


def test_a_q3_gives_one_scan_load_per_scan_under_execute(session):
    session.execute(Q3.format(date="1995-03-15"))
    loads = _spans(session, "scan_load")
    assert sorted(sp.attributes["table"] for sp in loads) == ["customer", "lineitem",
                                                              "orders"]
    assert {_parent(session, sp).name for sp in loads} == {"execute"}
    for sp in loads:
        assert sp.attributes["cache"] == "miss"
        assert sp.attributes["rows"] > 0
        assert sp.start <= sp.end


def test_scan_load_rows_are_the_scans_row_counts(session):
    session.execute("select count(*) from orders")
    (load,) = _spans(session, "scan_load")
    assert load.attributes["rows"] == session.execute(
        "select count(*) from orders").to_pylist()[0][0]


@pytest.mark.parametrize("second", ["1995-03-15", "1995-03-20"])
def test_cache_attributes_equal_the_scan_caches_counts(session, second):
    """Over two queries the spans' hits and misses are the cache's deltas:
    the second Q3 hits every scan, at the same date and at another (the
    date is pushed into the orders and lineitem scans, and the scan cache
    keys by the data a scan reads, not by its constraint)."""
    cache = session._scan_cache
    h0, m0 = cache.hits, cache.misses
    session.execute(Q3.format(date="1995-03-15"))
    session.execute(Q3.format(date=second))
    kinds = [sp.attributes["cache"] for sp in _spans(session, "scan_load")]
    assert kinds.count("hit") == cache.hits - h0
    assert kinds.count("miss") == cache.misses - m0
    assert kinds.count("hit") == 3


@pytest.mark.parametrize("props,sql", [
    ({"scan_cache_enabled": False}, "select count(*) from nation"),
    ({}, "select count(*) from system.runtime.nodes"),
], ids=["cache-off", "uncacheable-connector"])
def test_a_scan_the_cache_does_not_look_up_is_uncached(props, sql):
    s = tsession.tpch_session(0.01, device="cpu", result_cache=False, **props)
    s.tracer.clear()
    h0, m0 = s._scan_cache.hits, s._scan_cache.misses
    s.execute(sql)
    (load,) = _spans(s, "scan_load")
    assert load.attributes["cache"] == "uncached"
    assert (s._scan_cache.hits, s._scan_cache.misses) == (h0, m0)


def test_scan_count_only_on_a_lineitem_generation_miss(session):
    session.execute("select count(*) from orders")
    assert _spans(session, "scan_count") == []
    session.execute("select count(*) from lineitem")
    (count,) = _spans(session, "scan_count")
    assert _parent(session, count).name == "scan_load"
    assert _parent(session, count).attributes["table"] == "lineitem"
    assert count.attributes["orders_lo"] == 0
    assert count.attributes["orders_hi"] == 15000
    rows = session.execute("select count(*) from lineitem").to_pylist()[0][0]
    assert count.attributes["rows"] == rows
    # the third query hit the cache: no second count
    assert len(_spans(session, "scan_count")) == 1


def test_scan_generate_inside_the_table_scan_visit(session):
    session.execute("select sum(l_quantity) from lineitem where l_discount > 0.05")
    (gen,) = _spans(session, "scan_generate")
    assert gen.attributes["table"] == "lineitem"
    assert set(gen.attributes["columns"].split(",")) == {"l_quantity", "l_discount"}
    (load,) = _spans(session, "scan_load")
    assert gen.attributes["rows"] == load.attributes["rows"]
    parent = _parent(session, gen)
    assert parent.name == "operator" and parent.attributes["op"] == "TableScan"


def _plan_tree(node):
    return (type(node).__name__, [_plan_tree(c) for c in node.sources])


def _span_tree(s, sp):
    kids = sorted((c for c in _spans(s, "operator") if c.parent_id == sp.span_id),
                  key=lambda c: c.start)
    return (sp.attributes["op"], [_span_tree(s, c) for c in kids])


@pytest.mark.parametrize("sql", [
    Q3.format(date="1995-03-15"),
    "select n_name, count(*) from nation join region on n_regionkey = r_regionkey "
    "group by n_name order by n_name",
    "select o_orderpriority, count(*) from orders where o_orderdate >= date '1995-01-01' "
    "group by o_orderpriority",
], ids=["q3", "join", "aggregate"])
def test_operator_spans_nest_by_plan_shape(session, sql):
    session.execute(sql)
    plan = session._plan_cache[sql]
    (run,) = _spans(session, "plan_run")
    roots = [sp for sp in _spans(session, "operator") if sp.parent_id == run.span_id]
    assert len(roots) == 1
    assert _span_tree(session, roots[0]) == _plan_tree(plan.source)


def test_launch_spans_sit_inside_operators(session):
    session.execute("select l_returnflag, sum(l_quantity), count(*) from lineitem "
                    "group by l_returnflag")
    launches = _spans(session, "launch")
    assert launches
    for sp in launches:
        assert sp.attributes["kernel"]
        assert _parent(session, sp).name == "operator"


def test_plan_run_carries_its_attempt(session):
    session.execute("select count(*) from region")
    (run,) = _spans(session, "plan_run")
    assert run.attributes == {"attempt": 0}
    assert _parent(session, run).name == "execute"


def test_a_fired_check_marks_the_rerun(session):
    session.execute(WIDE)
    runs = sorted(_spans(session, "plan_run"), key=lambda sp: sp.start)
    assert [sp.attributes for sp in runs] == [{"attempt": 0, "rerun": "wide_mul"},
                                              {"attempt": 1}]


def test_query_syncs_are_spans_under_the_run(session):
    session.execute("select count(*) from region")
    whats = {sp.attributes["what"]: _parent(session, sp).name
             for sp in _spans(session, "sync")}
    assert whats == {"runtime checks": "plan_run", "output copy": "execute"}


def test_a_sync_span_wraps_device_get_and_gives_the_recorders_wall():
    sup = DeviceSupervisor(node_id="t")
    TRACER.clear()
    seen = []

    def read():
        seen.append(time.time_ns() / 1e9)
        return 7

    assert sup.device_get(read, Breadcrumb("runtime checks", mode="sync")) == 7
    (sp,) = [s for s in TRACER.spans if s.name == "sync"]
    assert sp.attributes == {"what": "runtime checks"}
    assert sp.start <= seen[0] <= sp.end
    rec = [r for r in sup.flight_recorder.tail(4) if r["recordType"] == "complete"][-1]
    assert rec["wallS"] == sp.end - sp.start


@pytest.mark.parametrize("mode,name,attrs", [
    ("operator", "operator", {"op": "Filter"}),
    ("launch", "launch", {"kernel": "grouped_count"}),
], ids=["operator", "launch"])
def test_dispatch_spans_by_mode(mode, name, attrs):
    sup = DeviceSupervisor(node_id="t")
    TRACER.clear()
    kernel = "op:Filter" if mode == "operator" else "grouped_count"
    assert sup.dispatch(lambda: 3, Breadcrumb(kernel, mode=mode)) == 3
    (sp,) = list(TRACER.spans)
    assert (sp.name, sp.attributes) == (name, attrs)
    rec = [r for r in sup.flight_recorder.tail(4) if r["recordType"] == "complete"][-1]
    assert rec["wallS"] == sp.end - sp.start


def test_a_failing_step_still_closes_its_span():
    sup = DeviceSupervisor(node_id="t")
    TRACER.clear()

    def boom():
        raise ValueError("not a device fault")

    with pytest.raises(ValueError):
        sup.dispatch(boom, Breadcrumb("op:Project", mode="operator"))
    (sp,) = list(TRACER.spans)
    assert sp.name == "operator" and sp.end >= sp.start
    assert TRACER.current_span() is None


def test_spans_are_on_the_profilers_clock():
    """A record_function range opened inside a span lies within the span's
    interval to 100 us, as torch.profiler reads it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with tracer.span("outer", i=i):
                with record_function(f"tracing_clock_{i}"):
                    torch.ones(64).sum()
    spans = {sp.attributes["i"]: sp for sp in tracer.spans}
    ranges = {int(e.name().rsplit("_", 1)[1]): e
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("tracing_clock_")}
    assert set(ranges) == set(spans)
    for i, e in ranges.items():
        lo, hi = e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9
        assert lo >= spans[i].start - 100e-6
        assert hi <= spans[i].end + 100e-6


def test_span_ids_are_w3c_shaped_and_distinct():
    tracer = Tracer()
    with tracer.span("root"):
        for _ in range(200):
            with tracer.span("child"):
                pass
    ids = [sp.span_id for sp in tracer.spans]
    assert len(set(ids)) == len(ids)
    assert all(len(i) == 16 and int(i, 16) >= 0 for i in ids)
    root = [sp for sp in tracer.spans if sp.name == "root"][0]
    assert len(root.trace_id) == 32
    assert all(sp.trace_id == root.trace_id for sp in tracer.spans)


def test_the_clock_script_finds_every_kernel_inside_its_span():
    """scripts/span_clock.py on the CPU: each operator's profiler interval
    lies inside the span that launched it."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "span_clock.py"), "--device", "cpu",
         "--spans", "50", "--cost-spans", "1000"],
        capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["spans"] == 50 and res["device"] == "cpu"
    assert res["outside_us"] <= 100.0
    assert res["span_us"] > 0


def test_a_cluster_query_spans_its_schedule_serde_and_streamed_tiles(monkeypatch):
    """Under a cluster query that streams its workers' fragments: the
    coordinator's `schedule`, the workers' `stream_tile`s, the pages'
    `serde_encode` and `serde_decode` and the exchange's `exchange_fetch`
    and `exchange_transfer` open with their attributes, and the workers'
    spans join the coordinator's trace."""
    import collections

    from trino_tpu_torch.testing import DistributedQueryRunner

    monkeypatch.setattr(TRACER, "spans", collections.deque(maxlen=1 << 20))
    with DistributedQueryRunner(workers=2, device="cpu",
                                properties={"query_max_memory_bytes": 300_000}) as r:
        TRACER.clear()
        r.rows("select sum(l_extendedprice * l_discount) from lineitem")
    spans = list(TRACER.spans)
    (query,) = [s for s in spans if s.name == "query"]
    by = collections.defaultdict(list)
    for s in spans:
        by[s.name].append(s)
    (sched,) = by["schedule"]
    assert sched.attributes["fragments"] == 2 and sched.attributes["tasks"] == 3
    assert len(by["stream_tile"]) >= 4
    for s in by["stream_tile"]:
        assert {"fragment", "tile", "rows"} <= set(s.attributes) and s.attributes["rows"] > 0
    for name in ("serde_encode", "serde_decode", "exchange_fetch"):
        assert by[name] and all(s.attributes["bytes"] > 0 for s in by[name])
    for name in ("serde_encode", "serde_decode"):
        assert all(s.attributes["pages"] == 1 and s.attributes["rows"] >= 1
                   for s in by[name])
    # every page written is read once
    assert (sorted(s.attributes["bytes"] for s in by["serde_encode"])
            == sorted(s.attributes["bytes"] for s in by["serde_decode"]))
    assert sum(s.attributes["bytes"] for s in by["exchange_fetch"]) == sum(
        s.attributes["bytes"] for s in by["serde_decode"])
    # a transfer is one answered request's body, inside its pull: every
    # frame's bytes, and no time of the producer's wait or the decode
    fetches = {s.span_id: s for s in by["exchange_fetch"]}
    assert sorted(s.attributes["bytes"] for s in by["exchange_transfer"]
                  if s.attributes["bytes"]) == sorted(
        s.attributes["bytes"] for s in by["serde_decode"])
    for s in by["exchange_transfer"]:
        assert s.parent_id in fetches and s.attributes["task"] == fetches[
            s.parent_id].attributes["task"]
    for d in by["serde_decode"]:
        assert not any(t.start < d.end and d.start < t.end for t in by["exchange_transfer"]
                       if t.parent_id == d.parent_id)
    assert sum(s.end - s.start for s in by["exchange_transfer"]) < sum(
        s.end - s.start for s in by["exchange_fetch"])
    for name in ("schedule", "stream_tile", "serde_encode", "serde_decode", "exchange_fetch",
                 "exchange_transfer", "fragment_execute"):
        assert {s.trace_id for s in by[name]} == {query.trace_id}, name
    # the tasks parent onto the query, not onto `schedule`
    assert by["task"] and all(t.parent_id == query.span_id for t in by["task"])
