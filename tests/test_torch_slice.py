"""The port's TPC-H Q6/Q1/Q3 slice against the JAX package, end to end.

Both engines run the same SQL text (tests/tpch_sql.py) over the same
generated data through their own `tpch_session`, with the fused
megakernel on and off (and Q3 with its direct-address joins on and
off); the output pages must be byte-identical
(trino_tpu_torch/convert.py) and agree with the sqlite oracle.  The
port runs on the CPU (device="cpu"), i.e. with its kernels' plain
versions.
"""
import os
import sqlite3
import subprocess
import sys

import pytest
import torch

from oracle import assert_rows_match, load_tpch
from tpch_sql import QUERIES, oracle_dialect
from trino_tpu.session import tpch_session as jax_session
from trino_tpu_torch import convert
from trino_tpu_torch.ops import kernels as kn
from trino_tpu_torch.session import tpch_session as torch_session

SF = 0.002
Q = {"q6": QUERIES[6][0], "q1": QUERIES[1][0], "q3": QUERIES[3][0]}
PROFILE_KEYS = ("fusedAggregates", "fusedTerms", "fusionRejects",
                "lastFusionReject")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sessions():
    return {
        mode: (jax_session(SF, megakernels=mode, result_cache=False),
               torch_session(SF, device="cpu", megakernels=mode))
        for mode in ("on", "off")
    }


@pytest.fixture(scope="module")
def oracle_conn():
    conn = sqlite3.connect(":memory:")
    load_tpch(conn, SF, ["lineitem", "orders", "customer"])
    return conn


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("q", ["q6", "q1"])
def test_pages_byte_identical_and_match_oracle(sessions, oracle_conn, q, mode):
    js, ts = sessions[mode]
    a = js.execute(Q[q])
    b = ts.execute(Q[q])
    convert.assert_pages_identical(a, b)
    expected = oracle_conn.execute(oracle_dialect(Q[q])).fetchall()
    assert_rows_match(b.to_pylist(), expected, tol=2e-2, ordered=True)
    jp, tp = js.last_kernel_profile, ts.last_kernel_profile
    assert {k: jp.get(k) for k in PROFILE_KEYS} == {
        k: tp.get(k) for k in PROFILE_KEYS}
    if mode == "on":
        # Q6 fuses to t3/g1 and Q1 to t11/g12 in both engines
        assert tp["fusedAggregates"] == 1
        assert tp["fusedTerms"] == {"q6": 3, "q1": 11}[q]
    else:
        assert tp.get("fusedAggregates") is None


@pytest.mark.parametrize("sql", [
    # min/max are order statistics, not plane-decomposable sums
    "select l_returnflag, min(l_quantity), max(l_discount), count(*) "
    "from lineitem where l_shipdate < date '1995-01-01' "
    "group by l_returnflag order by l_returnflag",
    # decimal division in the aggregate input is no fusable expression
    "select sum(l_extendedprice / l_quantity) from lineitem",
])
def test_non_fusable_query_rejects_on_both_sides(sessions, sql):
    js, ts = sessions["on"]
    a = js.execute(sql)
    b = ts.execute(sql)
    convert.assert_pages_identical(a, b)
    jp, tp = js.last_kernel_profile, ts.last_kernel_profile
    assert tp.get("fusedAggregates") is None and tp["fusionRejects"] >= 1
    assert {k: jp.get(k) for k in PROFILE_KEYS} == {
        k: tp.get(k) for k in PROFILE_KEYS}


def test_explain_matches_reference_plan(sessions):
    js, ts = sessions["off"]
    assert js.explain(Q["q1"]) == ts.explain(Q["q1"])


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("mode", ["on", "off"])
def test_q3_pages_byte_identical_and_match_oracle(oracle_conn, mode, direct):
    """Q3: two joins (direct-address, or the sorted unique kernel when
    direct_address_joins is off), hash-sort grouping by l_orderkey with
    two arbitrary() riders, and a top-N."""
    js = jax_session(SF, megakernels=mode, result_cache=False,
                     direct_address_joins=direct)
    ts = torch_session(SF, device="cpu", megakernels=mode,
                       direct_address_joins=direct)
    a = js.execute(Q["q3"])
    b = ts.execute(Q["q3"])
    convert.assert_pages_identical(a, b)
    assert b.count == 10
    expected = oracle_conn.execute(oracle_dialect(Q["q3"])).fetchall()
    assert_rows_match(b.to_pylist(), expected, tol=2e-2, ordered=True)
    jp, tp = js.last_kernel_profile, ts.last_kernel_profile
    assert {k: jp.get(k) for k in PROFILE_KEYS} == {
        k: tp.get(k) for k in PROFILE_KEYS}
    assert tp.get("fusedAggregates") is None  # grouped by a bigint key
    assert ("direct=[" in ts.explain(Q["q3"])) == direct


def test_explain_matches_reference_plan_q3(sessions):
    js, ts = sessions["off"]
    assert js.explain(Q["q3"]) == ts.explain(Q["q3"])


def _counting(monkeypatch, name):
    """Replace a kernel wrapper by a shim that counts its calls and runs
    the plain version (the CPU wrappers do not count launches)."""
    calls = []
    plain = getattr(kn, f"{name}_plain")

    def shim(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(kn, name, shim)
    return calls


def test_q3_probes_both_joins_through_the_direct_probe(monkeypatch):
    calls = _counting(monkeypatch, "direct_probe")
    torch_session(SF, device="cpu").execute(Q["q3"])
    assert len(calls) == 2
    # the orderkey join probes lineitem's int64 keys against a table
    # spanning the orderkey domain
    assert max(c[0].shape[0] for c in calls) >= 11_983


def test_q1_unfused_sums_through_grouped_sum_i64(monkeypatch):
    calls = _counting(monkeypatch, "grouped_sum_i64")
    torch_session(SF, device="cpu", megakernels="off").execute(Q["q1"])
    assert calls and {c[2] for c in calls} == {12}


def test_megakernels_auto_is_off_on_the_cpu():
    s = torch_session(SF, device="cpu")
    s.execute(Q["q6"])
    assert s.last_kernel_profile.get("fusedAggregates") is None


def test_plan_cache_never_replays_a_folded_current_date(monkeypatch):
    """current_date folds into a per-query constant; like the reference,
    the port caches only deterministic plans, so a repeated query sees the
    clock move.  A deterministic query is cached by its text."""
    import datetime
    import types

    from trino_tpu_torch.sql import analyzer

    days = iter([datetime.datetime(2024, 3, 1, 12, tzinfo=datetime.timezone.utc),
                 datetime.datetime(2025, 7, 9, 12, tzinfo=datetime.timezone.utc)])

    class _Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return next(days)

    fake = types.SimpleNamespace(**vars(datetime))
    fake.datetime = _Clock
    monkeypatch.setattr(analyzer, "datetime", fake)
    s = torch_session(SF, device="cpu")
    sql = "select current_date"
    got = [s.execute(sql).to_pylist()[0][0] for _ in range(2)]
    assert got == ["2024-03-01", "2025-07-09"]
    assert sql not in s._plan_cache
    s.execute(Q["q6"])
    assert Q["q6"] in s._plan_cache


def test_entry_point_refuses_the_cpu_unless_asked():
    """With no card, the port's entry points raise unless the caller
    asks for the CPU; they never run there quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_session(SF)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import trino_tpu_torch\n"
        "for m in pkgutil.walk_packages(trino_tpu_torch.__path__,"
        " 'trino_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'trino_tpu' or m.startswith('trino_tpu.')]\n"
        "assert not bad, bad\n"
        "walked = {'trino_tpu_torch.connectors.memory', 'trino_tpu_torch.expr.arrays',"
        " 'trino_tpu_torch.ops.matcher', 'trino_tpu_torch.utils.memory',"
        " 'trino_tpu_torch.memory.pools', 'trino_tpu_torch.ops.sketches',"
        " 'trino_tpu_torch.plan.fragment', 'trino_tpu_torch.exec.partitioner',"
        " 'trino_tpu_torch.exec.dynamic_filter', 'trino_tpu_torch.exec.fragment_exec',"
        " 'trino_tpu_torch.exec.streaming', 'trino_tpu_torch.exec.spill',"
        " 'trino_tpu_torch.connectors.tpch_device', 'trino_tpu_torch.cache',"
        " 'trino_tpu_torch.cache.signature', 'trino_tpu_torch.cache.result_cache',"
        " 'trino_tpu_torch.serde', 'trino_tpu_torch.obs.opstats',"
        " 'trino_tpu_torch.obs.bandwidth', 'trino_tpu_torch.stats.analyze',"
        " 'trino_tpu_torch.utils.events', 'trino_tpu_torch.utils.tracing',"
        " 'trino_tpu_torch.utils.metrics', 'trino_tpu_torch.utils.faults',"
        " 'trino_tpu_torch.obs.journal', 'trino_tpu_torch.obs.flight_recorder',"
        " 'trino_tpu_torch.runtime', 'trino_tpu_torch.runtime.supervisor',"
        " 'trino_tpu_torch.fs', 'trino_tpu_torch.fs.filesystem',"
        " 'trino_tpu_torch.fs.objectstore', 'trino_tpu_torch.connectors.blackhole',"
        " 'trino_tpu_torch.connectors.hive', 'trino_tpu_torch.connectors.lakehouse',"
        " 'trino_tpu_torch.obs.history', 'trino_tpu_torch.obs.doctor',"
        " 'trino_tpu_torch.obs.compile_observatory', 'trino_tpu_torch.cache.compile_cache',"
        " 'trino_tpu_torch.security', 'trino_tpu_torch.connectors.system',"
        " 'trino_tpu_torch.parallel', 'trino_tpu_torch.parallel.collectives',"
        " 'trino_tpu_torch.parallel.shuffle', 'trino_tpu_torch.parallel.mesh_executor',"
        " 'trino_tpu_torch.server', 'trino_tpu_torch.server.coordinator',"
        " 'trino_tpu_torch.server.worker', 'trino_tpu_torch.server.scheduler',"
        " 'trino_tpu_torch.server.discovery', 'trino_tpu_torch.server.protocol',"
        " 'trino_tpu_torch.server.resource_groups', 'trino_tpu_torch.server.webui',"
        " 'trino_tpu_torch.server.coordinator_main', 'trino_tpu_torch.server.worker_main',"
        " 'trino_tpu_torch.client', 'trino_tpu_torch.client.client',"
        " 'trino_tpu_torch.client.dbapi', 'trino_tpu_torch.distributed',"
        " 'trino_tpu_torch.distributed.topology', 'trino_tpu_torch.testing',"
        " 'trino_tpu_torch.testing.runner', 'trino_tpu_torch.cli',"
        " 'trino_tpu_torch.exec.exchange_client', 'trino_tpu_torch.memory.admission',"
        " 'trino_tpu_torch.memory.cluster', 'trino_tpu_torch.memory.killer',"
        " 'trino_tpu_torch.exchange', 'trino_tpu_torch.exchange.filesystem',"
        " 'trino_tpu_torch.server.fte', 'trino_tpu_torch.server.recovery',"
        " 'trino_tpu_torch.server.autoscaler', 'trino_tpu_torch.obs.serving_observatory',"
        " 'trino_tpu_torch.services', 'trino_tpu_torch.services.proxy',"
        " 'trino_tpu_torch.services.verifier'}\n"
        "assert walked <= set(sys.modules), walked - set(sys.modules)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
