"""The port's fault-tolerant execution against the JAX package's.

Replayed through both packages' servers (test_torch_server.replay_module:
the same case, the port's imports rebound to trino_tpu_torch on the CPU,
the clients' records compared): every case of tests/test_fte.py (the
spool, the TPC-H queries under retry_policy = task against the sqlite
oracle, task retries, speculation and adaptive replanning); the healed
corrupt spool, the whole-query retry and the property's validation of
tests/test_faults.py; the kill -9 cases of tests/test_lifecycle.py (FTE
reassignment and retry_policy = query); the doctor's spool-corruption,
node-churn and estimate-drift verdicts of tests/test_doctor.py.

Beside them: the port's form of tests/test_supervisor.py:319 (a device
loss on one worker fails its task with DeviceFaultError and the task is
retried on the other worker; the port has no CPU re-run, so there is no
``device_cpu_fallback`` and no ``fallbacksAttempted``), the loser of a
speculative race reserving nothing on its worker, and a spool directory
written by either package's workers read page for page by the other's
``read_spool_pages``.
"""
import json
import sqlite3
import time
import urllib.request

import pytest

from oracle import assert_rows_match, load_tpch
from test_torch_server import replay_module
from tpch_sql import oracle_dialect

replay_module("test_fte.py")
replay_module("test_faults.py", select=[135, 186, 230])
replay_module("test_lifecycle.py", select=[288, 345])
replay_module("test_doctor.py", select=[225, 254, 294])

SF = 0.001
TPCH = (("tpch", "tpch", {"tpch.scale-factor": SF}),)
GROUPED = ("select l_returnflag, count(*) c from lineitem "
           "group by l_returnflag order by l_returnflag")


@pytest.fixture(scope="module")
def oracle():
    conn = sqlite3.connect(":memory:")
    load_tpch(conn, SF, ["lineitem"])
    return conn


def test_fte_retries_device_lost_task_on_another_worker(oracle):
    """retry_policy = task: the device-lost task FAILS on the sick worker
    with DeviceFaultError and is retried on the other node — the query
    matches the oracle, the sick node ends QUARANTINED, and nothing
    re-ran on the CPU (no CPU_FALLBACK event)."""
    from trino_tpu_torch.obs import journal
    from trino_tpu_torch.runtime.supervisor import QUARANTINED
    from trino_tpu_torch.server.fte import FaultTolerantScheduler
    from trino_tpu_torch.sql.parser import parse
    from trino_tpu_torch.testing import DistributedQueryRunner
    from trino_tpu_torch.utils.faults import FaultInjector

    journal._reset_journal()
    with DistributedQueryRunner(workers=2, catalogs=TPCH, device="cpu") as runner:
        bad = runner.workers[0]
        bad.supervisor.probe_backoff_s = 60.0  # no recovery mid-test
        bad.supervisor.fault_injector = FaultInjector({"device_loss": {"nth": 1}})
        nm = runner.coordinator.coordinator.node_manager
        fte = FaultTolerantScheduler(
            runner.session.catalogs, nm,
            properties={"retry_policy": "task", "device_probe_backoff_s": 60.0},
        )
        plan = runner.session._plan_stmt(parse(GROUPED))
        page = fte.run(plan, "q_chaos_device")
        expected = oracle.execute(oracle_dialect(GROUPED)).fetchall()
        assert_rows_match(page.to_pylist(), expected, tol=2e-2, ordered=True)
        snap = bad.supervisor.snapshot()
        assert snap["devices"][0]["faults"] >= 1, "fault never fired"
        assert snap["devices"][0]["state"] == QUARANTINED
        assert snap["state"] == "QUARANTINED"
        assert "fallbacksAttempted" not in snap
        # the faulted attempt ran on the sick worker; its task re-ran on
        # the healthy one
        attempts = {}
        for uri, task_id in fte._created_tasks:
            _q, frag, idx, _att = task_id.rsplit(".", 3)
            attempts.setdefault((frag, idx), []).append(uri)
        retried = [u for u in attempts.values() if len(u) > 1]
        assert retried and all(u[0] == bad.uri and u[-1] != bad.uri
                               for u in retried), attempts
        kinds = [e["eventType"] for e in journal.get_journal().tail()]
        assert journal.DEVICE_QUARANTINE in kinds
        assert journal.FTE_REASSIGN in kinds
        assert journal.CPU_FALLBACK not in kinds


def test_speculative_loser_reserves_nothing(oracle):
    """The stalled primary of a speculative race is aborted while it
    sleeps: when it wakes it runs nothing, so the worker's memory manager
    holds no reservation of it and launches no kernel for it."""
    from trino_tpu_torch.server.fte import FaultTolerantScheduler
    from trino_tpu_torch.sql.parser import parse
    from trino_tpu_torch.testing import DistributedQueryRunner

    stall = 2.0
    with DistributedQueryRunner(workers=2, catalogs=TPCH, device="cpu") as runner:
        nm = runner.coordinator.coordinator.node_manager
        qid = "q_spec_loser"
        for w in runner.workers:
            req = urllib.request.Request(
                f"{w.uri}/v1/task/{qid}.1.0.0/fail",
                data=json.dumps({"mode": f"STALL:{stall}"}).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=5.0).read()
        fte = FaultTolerantScheduler(runner.session.catalogs, nm,
                                     properties={"fte_speculation_min_s": 0.2})
        plan = runner.session._plan_stmt(parse(GROUPED))
        t0 = time.time()
        page = fte.run(plan, qid)
        assert time.time() - t0 < stall
        expected = oracle.execute(oracle_dialect(GROUPED)).fetchall()
        assert_rows_match(page.to_pylist(), expected, tol=2e-2, ordered=True)
        assert fte.straggler.flags, "the stall was never hedged"
        time.sleep(stall + 0.5 - (time.time() - t0))
        for w in runner.workers:
            snap = w.memory_manager.snapshot()
            held = {p: d["reserved"] for p, d in snap["pools"].items()}
            assert not any(held.values()), (w.uri, snap)


class _KeptSpool:
    """An exchange manager whose spool trees outlive the query."""

    def __init__(self, cls, base):
        self.inner = cls(str(base))
        self.base = self.inner.base

    def sink(self, *a):
        return self.inner.sink(*a)

    def cleanup_query(self, query_id):
        pass


def _spool_files(base):
    return sorted(p for p in base.rglob("buffer_*.bin"))


def _run_kept(pkg, base, sql):
    import importlib

    fte_mod = importlib.import_module(f"{pkg}.server.fte")
    fs = importlib.import_module(f"{pkg}.exchange.filesystem")
    runner_mod = importlib.import_module(f"{pkg}.testing.runner")
    parser = importlib.import_module(f"{pkg}.sql.parser")
    kw = {"device": "cpu"} if pkg == "trino_tpu_torch" else {}
    with runner_mod.DistributedQueryRunner(workers=2, catalogs=TPCH, **kw) as r:
        fte = fte_mod.FaultTolerantScheduler(
            r.session.catalogs, r.coordinator.coordinator.node_manager,
            exchange=_KeptSpool(fs.FileSystemExchangeManager, base),
            properties={"retry_policy": "task"},
        )
        page = fte.run(r.session._plan_stmt(parser.parse(sql)), "q_spool_cross")
    return page.to_pylist()


@pytest.mark.parametrize("writer", ["trino_tpu", "trino_tpu_torch"])
def test_spool_directories_cross_between_the_packages(tmp_path, writer):
    """Q3's spool tree written by one package's workers reads in the
    other, page for page: the same rows, types and page boundaries."""
    from tpch_sql import QUERIES
    from trino_tpu.exchange.filesystem import read_spool_pages as jax_read
    from trino_tpu_torch.exchange.filesystem import read_spool_pages as port_read

    rows = _run_kept(writer, tmp_path, QUERIES[3][0])
    assert rows
    files = _spool_files(tmp_path)
    assert len(files) >= 4, files
    for f in files:
        jp, pp = jax_read(str(f)), port_read(str(f))
        assert len(jp) == len(pp)
        for a, b in zip(jp, pp):
            assert [str(c.type) for c in a.columns] == [str(c.type) for c in b.columns]
            assert a.to_pylist() == b.to_pylist()


def test_spool_write_corrupt_fails_the_port_crc(tmp_path):
    """A bit flipped by the spool_write_corrupt site after serialization
    is caught by the port's read-side CRC as the JAX package catches it."""
    from trino_tpu import types as JT
    from trino_tpu.exchange.filesystem import SpoolCorruptionError as JaxCorrupt
    from trino_tpu.exchange.filesystem import read_spool_pages as jax_read
    from trino_tpu.page import page_from_pydict
    from trino_tpu.serde import serialize_page
    from trino_tpu_torch.exchange.filesystem import SpoolCorruptionError, SpoolHandle
    from trino_tpu_torch.exchange.filesystem import read_spool_pages
    from trino_tpu_torch.utils.faults import FaultInjector

    page = page_from_pydict([("a", JT.BIGINT)], {"a": list(range(100))})
    inj = FaultInjector({"spool_write_corrupt": {"flip_byte": 40}})
    h = SpoolHandle(str(tmp_path / "t0.0"))
    h.write_buffers({0: [inj.corrupt("spool_write_corrupt", serialize_page(page))]})
    assert h.committed
    with pytest.raises(SpoolCorruptionError, match="spool corruption at"):
        read_spool_pages(h.buffer_file(0))
    with pytest.raises(JaxCorrupt):
        jax_read(h.buffer_file(0))
    h.decommit()
    assert not h.committed


def test_fte_query_documents_carry_retry_and_spool_stats():
    """Through the statement protocol under retry_policy = task: the
    query document reports retryCount like the JAX coordinator's, the
    query its adaptive actions, and every task's stats its spool bytes."""
    from trino_tpu_torch.testing import DistributedQueryRunner

    with DistributedQueryRunner(workers=2, catalogs=TPCH, device="cpu",
                                properties={"retry_policy": "task"}) as runner:
        assert runner.rows("select count(*) from orders") == [(1500,)]
        co = runner.coordinator.coordinator
        q = max(co.queries.values(), key=lambda q: q.created)
        with urllib.request.urlopen(f"{runner.coordinator.uri}/v1/query/{q.query_id}",
                                    timeout=5.0) as resp:
            doc = json.loads(resp.read())
        assert doc["retryCount"] == 0 and q.adaptive_actions == []
        assert q.task_stats and all("spoolWriteBytes" in t for t in q.task_stats)
        assert sum(t["spoolWriteBytes"] for t in q.task_stats) > 0
        assert sum(t["spoolReadBytes"] for t in q.task_stats) > 0
        assert q.sched_timings["rootBytes"] > 0


# (event type name, query-tagged) of each scenario, emitted in order
DOCTOR_SCENARIOS = {
    "spool_corruption": [("FAULT_INJECTED", False, {"site": "spool_write_corrupt"}),
                         ("SPOOL_HEAL", True, {"fragment": 1})],
    "node_churn": [("NODE_SUSPECT", False, {}), ("FTE_REASSIGN", True, {"attempt": 1}),
                   ("NODE_GONE", False, {})],
    "estimate_drift": [("FAULT_INJECTED", False, {"site": "stats_estimate",
                                                  "key": "fragment 1"}),
                       ("FTE_REASSIGN", True, {"attempt": 0})],
    "overload": [("QUERY_SHED", True, {"group": "global", "waitedS": 2.0}),
                 ("SCALE_OUT", False, {"workers": 3, "backlog": 12})],
    "slo_burn": [("SLO_BURN", True, {"tenant": "t1", "burnRate": 20.0, "windowS": 30.0,
                                     "latencyTargetS": 0.5, "errorBudget": 0.1})],
}


@pytest.mark.parametrize("writer", ["trino_tpu", "trino_tpu_torch"])
@pytest.mark.parametrize("scenario", sorted(DOCTOR_SCENARIOS))
def test_doctor_fte_and_serving_verdicts_cross_between_the_packages(tmp_path, writer,
                                                                    scenario):
    """A journal directory holding one FTE or serving scenario, written by
    either package's journal, gets the same diagnosis from both doctors."""
    import importlib

    from trino_tpu.obs import doctor as jax_doctor
    from trino_tpu_torch.obs import doctor

    journal = importlib.import_module(f"{writer}.obs.journal")
    d = str(tmp_path / "journal")
    journal._reset_journal()
    journal.configure(d)
    try:
        for name, tagged, detail in DOCTOR_SCENARIOS[scenario]:
            journal.emit(getattr(journal, name), query_id="q_fte" if tagged else "",
                         node_id="" if tagged else "w2", severity=journal.WARN,
                         **detail)
        journal.sync()
    finally:
        journal._reset_journal()
    port = doctor.diagnose_from_dir(d, query_id="q_fte")
    want = jax_doctor.diagnose_from_dir(d, query_id="q_fte")
    assert port["rootCause"] == scenario, port
    assert {k: v for k, v in port.items() if k not in ("ts", "wallS")} == \
        {k: v for k, v in want.items() if k not in ("ts", "wallS")}
