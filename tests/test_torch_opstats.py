"""The port's per-operator timeline and EXPLAIN ANALYZE against the JAX
package's.

As tests/test_opstats.py:76-160: with `operator_stats = true`, the
frames of TPC-H Q1, Q3 and Q6 (rows and bytes in and out, calls) equal
the JAX package's frame for frame, and equal independently computed
counts (COUNT(*) probes of the same session); the exclusive operator
walls reconcile with the query wall.  EXPLAIN ANALYZE's operator rows
and estimates equal the JAX package's, its annotated plan equals the
JAX package's but for the walls, and it carries the kernel profile and
the bandwidth ledger against the card's roofline.
"""
import re

import pytest

from tpch_sql import QUERIES
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch.exec.streaming import DEVGEN_TEMP_LANES
from trino_tpu_torch.obs import bandwidth
from trino_tpu_torch.session import tpch_session as torch_session

SF = 0.001
LANE_BYTES = 8
Q6_COLUMNS = 4
KEYS = ("operatorId", "planNodeId", "operatorType", "inputRows", "inputBytes",
        "outputRows", "outputBytes", "estimatedRows", "calls")


@pytest.fixture(scope="module")
def sessions():
    return (jax_session(SF, operator_stats=True, result_cache=False),
            torch_session(SF, device="cpu", operator_stats=True, result_cache=False))


def _frames(session, sql):
    page = session.execute(sql)
    tl = session.last_timeline
    assert tl and tl.get("operators"), "operator_stats produced no frames"
    return page, tl


def _rows(frames):
    return [{k: f[k] for k in KEYS} for f in frames]


def _by_type(tl, operator_type):
    return [f for f in tl["operators"] if f["operatorType"] == operator_type]


def _scalar(session, sql):
    return session.execute(sql).to_pylist()[0][0]


@pytest.mark.parametrize("q", [1, 3, 6])
def test_operator_frames_match_jax(sessions, q):
    js, ts = sessions
    _, jt = _frames(js, QUERIES[q][0])
    _, tt = _frames(ts, QUERIES[q][0])
    assert _rows(tt["operators"]) == _rows(jt["operators"])


def test_q1_operator_rows_match_counts(sessions):
    _, ts = sessions
    page, tl = _frames(ts, QUERIES[1][0])
    lineitem = _scalar(ts, "SELECT count(*) FROM lineitem")
    passing = _scalar(ts, "SELECT count(*) FROM lineitem "
                          "WHERE l_shipdate <= DATE '1998-09-02'")
    (scan,) = _by_type(tl, "TableScan")
    assert scan["outputRows"] == lineitem and scan["inputRows"] == 0
    (filt,) = _by_type(tl, "Filter")
    assert (filt["inputRows"], filt["outputRows"]) == (lineitem, passing)
    (agg,) = _by_type(tl, "Aggregate")
    assert (agg["inputRows"], agg["outputRows"]) == (passing, page.count)


def test_q3_scan_rows_match_table_cardinalities(sessions):
    _, ts = sessions
    page, tl = _frames(ts, QUERIES[3][0])
    counts = sorted(_scalar(ts, f"SELECT count(*) FROM {t}")
                    for t in ("customer", "orders", "lineitem"))
    assert sorted(f["outputRows"] for f in _by_type(tl, "TableScan")) == counts
    root = min(tl["operators"], key=lambda f: f["operatorId"])
    assert root["outputRows"] == page.count
    for join in _by_type(tl, "Join"):
        assert join["outputRows"] <= join["inputRows"]


def test_q6_operator_rows_and_bytes(sessions):
    _, ts = sessions
    page, tl = _frames(ts, QUERIES[6][0])
    lineitem = _scalar(ts, "SELECT count(*) FROM lineitem")
    passing = _scalar(ts, "SELECT count(*) FROM lineitem "
                          "WHERE l_shipdate >= DATE '1994-01-01' "
                          "AND l_shipdate < DATE '1995-01-01' "
                          "AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24")
    (scan,) = _by_type(tl, "TableScan")
    (filt,) = _by_type(tl, "Filter")
    (agg,) = _by_type(tl, "Aggregate")
    assert scan["outputRows"] == lineitem
    assert scan["outputBytes"] == lineitem * Q6_COLUMNS * LANE_BYTES
    assert (filt["inputRows"], filt["outputRows"]) == (lineitem, passing)
    assert filt["outputBytes"] == passing * Q6_COLUMNS * LANE_BYTES
    assert (agg["inputRows"], agg["outputRows"]) == (passing, 1) and page.count == 1


def test_operator_walls_sum_to_query_wall(sessions):
    _, ts = sessions
    _, tl = _frames(ts, QUERIES[1][0])
    wall = tl["wallS"]
    op_wall = sum(f["wallS"] for f in tl["operators"])
    assert wall > 0
    assert abs(op_wall - wall) <= max(0.1 * wall, 0.05), (op_wall, wall)


_WALL = re.compile(r", wall=[0-9.]+ms")


@pytest.mark.parametrize("q", [1, 3, 6])
def test_explain_analyze_matches_jax(q):
    """The operator rows and the cost model's estimates of EXPLAIN
    ANALYZE equal the JAX package's (the plain sessions: EXPLAIN ANALYZE
    instruments its own executor), and so does the annotated plan but
    for its walls."""
    js = jax_session(SF, result_cache=False)
    ts = torch_session(SF, device="cpu")
    pages = [s.execute("explain analyze " + QUERIES[q][0]) for s in (js, ts)]
    frames = [_rows(s.last_timeline["operators"]) for s in (js, ts)]
    assert frames[1] == frames[0] and frames[1]
    plans = []
    for p in pages:
        lines = [r[0] for r in p.to_pylist()]
        plans.append([_WALL.sub("", line) for line in lines[: lines.index("")]])
    assert plans[1] == plans[0]
    text = "\n".join(r[0] for r in pages[1].to_pylist())
    assert "Operator timeline" in text and "output rows" in text
    assert "Kernel profile (cpu)" in text and "kernel launches: none" in text
    assert "scans generated on the device: " in text
    assert "Device memory bandwidth ledger" in text and "of 3350 GB/s" in text
    # plain execution is not changed by the instrumentation
    assert ts.execute(QUERIES[q][0]).to_pylist() == js.execute(QUERIES[q][0]).to_pylist()


def test_bandwidth_ledger_property_and_roofline():
    ts = torch_session(SF, device="cpu", bandwidth_ledger=True, result_cache=False)
    ts.execute(QUERIES[6][0])
    prof = ts.last_kernel_profile
    (entry,) = prof["bandwidth"]
    assert entry["inputBytes"] > 0 and entry["outputBytes"] > 0
    assert entry["executions"] == 1 and entry["deviceWallS"] > 0
    assert prof["summary"]["rooflineGbps"] == bandwidth.DEFAULT_ROOFLINE_GBPS == 3350.0
    led = bandwidth.BandwidthLedger(roofline_gbps=1.0)
    led.record("k", "eager", 600, 300, 100, 1e-6)
    (e,) = led.entries()
    assert e["totalBytes"] == 1000 and e["gbps"] == pytest.approx(1.0)
    assert e["rooflinePct"] == pytest.approx(100.0)


PROFILE_COUNTS = ("deviceGeneratedScans", "hostGeneratedScans",
                  "fusedAggregates", "fusionRejects")


@pytest.mark.parametrize("q", [1, 6])
@pytest.mark.parametrize("settings", [
    {"megakernels": "off", "device_generation": False},
    {"megakernels": "on", "device_generation": False},
    {"megakernels": "on", "device_generation": True},
], ids=["unfused-hostgen", "fused-hostgen", "fused-devgen"])
def test_explain_analyze_runs_the_sessions_settings(q, settings):
    """EXPLAIN ANALYZE profiles the run `execute` performs under the
    session's properties: its frames and profile counts equal those of an
    operator_stats run of a session with the same settings."""
    plain = torch_session(SF, device="cpu", operator_stats=True,
                          result_cache=False, **settings)
    explained = torch_session(SF, device="cpu", result_cache=False, **settings)
    _, tl = _frames(plain, QUERIES[q][0])
    want = {k: plain.last_kernel_profile.get(k, 0) for k in PROFILE_COUNTS}
    explained.execute("explain analyze " + QUERIES[q][0])
    got = {k: explained.last_kernel_profile.get(k, 0) for k in PROFILE_COUNTS}
    observed = [k for k in KEYS if k != "estimatedRows"]  # EXPLAIN's cost model
    assert ([{k: f[k] for k in observed} for f in explained.last_timeline["operators"]]
            == [{k: f[k] for k in observed} for f in tl["operators"]])
    assert got == want
    assert (want["deviceGeneratedScans"] > 0) == settings["device_generation"]
    assert (want["fusedAggregates"] > 0) == (settings["megakernels"] == "on")


def _ledger_intermediate(session, sql):
    session.execute(sql)
    (entry,) = session.last_kernel_profile["bandwidth"]
    return entry["intermediateBytes"]


def test_bandwidth_ledger_counts_generation_only_when_it_ran():
    """The ledger charges generator temporaries to the run that generated
    its scans: a warm run reads the scan cache and is charged none."""
    lineitem = _scalar(torch_session(SF, device="cpu"), "select count(*) from lineitem")
    ts = torch_session(SF, device="cpu", bandwidth_ledger=True, result_cache=False)
    cold = _ledger_intermediate(ts, QUERIES[6][0])
    assert ts.last_kernel_profile["deviceGeneratedScans"] == 1
    warm = _ledger_intermediate(ts, QUERIES[6][0])
    assert "deviceGeneratedScans" not in ts.last_kernel_profile  # a cache hit
    assert cold - warm == lineitem * 8 * DEVGEN_TEMP_LANES
    off = torch_session(SF, device="cpu", bandwidth_ledger=True,
                        result_cache=False, device_generation=False)
    assert _ledger_intermediate(off, QUERIES[6][0]) == warm


def test_bandwidth_ledger_host_generated_scan_charges_no_generator():
    """A scan of a host-formatted column takes the host generator: no
    generator temporaries in its run's intermediate bytes."""
    sql = "select count(*) from customer where c_phone like '1%'"
    ts = torch_session(SF, device="cpu", bandwidth_ledger=True, result_cache=False)
    assert _ledger_intermediate(ts, sql) == 0
    assert ts.last_kernel_profile["hostGeneratedScans"] == 1
    assert ts.last_kernel_profile.get("deviceGeneratedScans", 0) == 0
