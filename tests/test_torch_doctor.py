"""The port's query doctor against the JAX package's.

The non-server cases of tests/test_doctor.py (:95-205, :294, :327, :370,
:440) on the port: error classification, the ordered rule table, the
explicit HEALTHY verdict, torn journal tails, ambient events, the
finalize pass of healthy, out-of-memory and device-fault queries, the
window-attributed stats_estimate verdict, the SQL surfaces, EXPLAIN
ANALYZE's Diagnosis and the kill -9 post-mortem from disk.  Verdicts
must match the JAX doctor's in verdict, root cause, severity and the
order of the cited event types; the rule table itself is held to the
JAX package's over synthetic evidence for every rule.  A journal
directory the JAX package wrote gets the same verdict from both
doctors, its CPU re-run included; the port's own device faults carry
no CPU re-run (a difference on purpose, witnessed here).
"""
import json
import os
import subprocess
import sys

import pytest

import trino_tpu.session as jsession
from tpch_sql import QUERIES
from trino_tpu.obs import doctor as jax_doctor
from trino_tpu.obs import journal as jax_journal
from trino_tpu_torch.obs import doctor, history, journal
from trino_tpu_torch.runtime import DeviceFaultError
from trino_tpu_torch.session import tpch_session
from trino_tpu_torch.utils.faults import FaultInjector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.001
Q6 = QUERIES[6][0]
OOM = json.dumps({"seed": 7, "oom": {"p": 1.0, "times": 1}})
LOSS = json.dumps({"device_loss": {"nth": 1}})


@pytest.fixture(autouse=True, scope="module")
def _jax_compile_cache_of_its_own():
    """The JAX package's compiled fragments stay this module's: its
    process-global compile cache is swapped for a fresh one meanwhile, so
    a later JAX test of this process that counts its first compiles finds
    none that these tests cached."""
    import trino_tpu.cache.compile_cache as jax_compile_cache

    saved = jax_compile_cache._SHARED
    jax_compile_cache._SHARED = None
    yield
    jax_compile_cache._SHARED = saved


@pytest.fixture(autouse=True)
def _fresh_journals():
    """Ambient-event attribution is wall-clock windowed: a prior test's
    events must never bleed into this one's verdict."""
    for j, d in ((journal, doctor), (jax_journal, jax_doctor)):
        j._reset_journal()
        d._reset_diagnoses()
    yield
    for j, d in ((journal, doctor), (jax_journal, jax_doctor)):
        j._reset_journal()
        d._reset_diagnoses()


def _ev(i, etype, qid="q1", node="", task="", **detail):
    return {"eventId": i, "eventType": etype, "queryId": qid, "taskId": task,
            "nodeId": node, "severity": "warn", "detail": detail, "ts": float(i)}


def _shape(d, events):
    """What both doctors must agree on: verdict, root cause, each
    finding's code and severity, and the types of its cited events."""
    types = {e["eventId"]: e["eventType"] for e in events}
    return (d["verdict"], d["rootCause"], d["errorCode"],
            [(f["code"], f["severity"], [types[i] for i in f["eventIds"]])
             for f in d["findings"]])


# --- units: error classification, the rule table, torn tails -------------


def test_classify_error_structured_codes():
    assert doctor.classify_error(None) == ""
    assert doctor.classify_error("") == ""
    cases = (
        ("ExceededMemoryLimitError: query memory limit", "EXCEEDED_MEMORY_LIMIT"),
        ("QueryKilledError: Query killed to free memory", "QUERY_KILLED"),
        ("DeviceFaultError: forced device_loss in kernel", "DEVICE_LOSS"),
        ("DeviceFaultError: forced device_wedge", "DEVICE_WEDGE"),
        ("DeviceFaultError: device_quarantined", "DEVICE_FAULT"),
        ("SchedulerError: NO_NODES_AVAILABLE", "NO_NODES_AVAILABLE"),
        ("RuntimeError: REMOTE_HOST_GONE fetching page", "REMOTE_HOST_GONE"),
        ("PageIntegrityError: crc mismatch", "PAGE_CORRUPTION"),
        ("ValueError: something else entirely", "INTERNAL_ERROR"),
    )
    for text, code in cases:
        assert doctor.classify_error(text) == code == jax_doctor.classify_error(text)
    assert doctor.DIAGNOSIS_FIELDS == jax_doctor.DIAGNOSIS_FIELDS


J = journal
# one piece of evidence per rule of the table (and an error code where a
# rule also reads one), in the table's order
EVIDENCE = {
    "device_fault": [_ev(1, J.DEVICE_FAULT, node="n1", kind="device_loss",
                         kernel="fused_agg_sums"),
                     _ev(2, J.DEVICE_QUARANTINE, node="n1", device=0, strikes=1)],
    "memory_kill": [_ev(1, J.MEMORY_KILL, reason="largest query over limit"),
                    _ev(2, J.MEMORY_REVOKE, reason="pool pressure")],
    "host_gone": [_ev(1, J.HOST_GONE, host="h2", localDevices=4),
                  _ev(2, J.NODE_GONE, node="w2"), _ev(3, J.FTE_REASSIGN)],
    "node_churn": [_ev(1, J.NODE_SUSPECT, node="w3"), _ev(2, J.FTE_REASSIGN)],
    "coordinator_restart": [_ev(1, J.COORDINATOR_RESTART),
                            _ev(2, J.QUERY_RESUMED, reusedSpools=3)],
    "snapshot_conflict": [_ev(1, J.SNAPSHOT_CONFLICT, table="t"),
                          _ev(2, J.FAULT_INJECTED, qid="", site="objstore_error")],
    "mesh_shrink": [_ev(1, J.MESH_SHRINK, deviceId=3, fromSize=8, toSize=4)],
    "overload": [_ev(1, J.QUERY_SHED, group="global"), _ev(2, J.SCALE_OUT)],
    "slo_burn": [_ev(1, J.SLO_BURN, tenant="t1", burnRate=20.0, windowS=60.0,
                     latencyTargetS=0.5, errorBudget=0.01)],
    "memory_pressure": [_ev(1, J.FAULT_INJECTED, qid="", site="oom"),
                        _ev(2, J.ADMISSION_BLOCK), _ev(3, J.FORCED_STREAMING)],
    "retrace_storm": [_ev(1, J.RETRACE_STORM, misses=9, windowS=10.0)],
    "spool_corruption": [_ev(1, J.FAULT_INJECTED, qid="", site="spool_read"),
                         _ev(2, J.SPOOL_HEAL, fragment=2)],
    "cache_corruption": [_ev(1, J.FAULT_INJECTED, qid="", site="cache_read"),
                         _ev(2, J.CACHE_HEAL, frames=1)],
    "straggler": [_ev(1, J.STRAGGLER_FLAG, task="q1.1.0.0", wallS=2.0, medianS=0.5),
                  _ev(2, J.HEDGE)],
    "fusion_reject": [_ev(1, J.FUSION_REJECT, reason="kernel limits")],
    "estimate_drift": [_ev(1, J.FAULT_INJECTED, qid="", site="stats_estimate",
                           key="fragment 1")],
}


@pytest.mark.parametrize("error", [None, "ValueError: boom"], ids=["ok", "failed"])
@pytest.mark.parametrize("rule", sorted(EVIDENCE))
def test_every_rule_gives_the_jax_verdict(rule, error):
    events = EVIDENCE[rule]
    d = doctor.diagnose("q1", events, error=error)
    assert d["rootCause"] == rule and d["eventIds"]
    want = jax_doctor.diagnose("q1", events, error=error)
    assert {k: v for k, v in d.items() if k != "ts"} == {
        k: v for k, v in want.items() if k != "ts"}


def test_all_evidence_at_once_ranks_as_jax():
    """Every rule's evidence in one query: the ordered table names the
    device fault, and every other rule survives as a finding, in the
    JAX package's order."""
    events, i = [], 0
    for evs in EVIDENCE.values():
        for e in evs:
            i += 1
            events.append(dict(e, eventId=i, ts=float(i)))
    d = doctor.diagnose("q1", events)
    assert d["rootCause"] == "device_fault"
    assert _shape(d, events) == _shape(jax_doctor.diagnose("q1", events), events)
    assert len(d["findings"]) == len(EVIDENCE)


def test_rule_precedence_device_fault_outranks_memory_pressure():
    events = [
        _ev(1, journal.MEMORY_REVOKE, reason="pool pressure"),
        _ev(2, journal.DEVICE_FAULT, node="n1", kind="device_loss", kernel="q6_fused"),
        _ev(3, journal.CPU_FALLBACK, node="n1"),
    ]
    d = doctor.diagnose("q1", events)
    assert d["verdict"] == doctor.ROOT_CAUSE and d["rootCause"] == "device_fault"
    assert set(d["eventIds"]) >= {2, 3}
    codes = [f["code"] for f in d["findings"]]
    assert codes.index("device_fault") < codes.index("memory_pressure")
    d2 = doctor.diagnose("q1", events)
    assert {k: v for k, v in d.items() if k != "ts"} == {
        k: v for k, v in d2.items() if k != "ts"}


def test_no_evidence_is_an_explicit_healthy_verdict():
    d = doctor.diagnose("q_clean", [])
    assert d["verdict"] == doctor.HEALTHY
    assert d["rootCause"] == "" and d["eventIds"] == []
    assert "HEALTHY" in doctor.format_diagnosis(d)
    assert doctor.format_diagnosis(d) == jax_doctor.format_diagnosis(d)


def test_read_journal_dir_skips_torn_tail(tmp_path):
    j = journal.EventJournal(str(tmp_path), name="w1")
    eid = j.emit(journal.MEMORY_KILL, query_id="q1", node_id="n1",
                 reason="largest query over limit")
    j.sync()
    j.close()
    with open(tmp_path / (journal._FILE_PREFIX + "crashed-0.jsonl"), "wb") as f:
        f.write(b'{"eventId": 99, "eventType": "device_f')
    events = journal.read_journal_dir(str(tmp_path))
    assert [e["eventId"] for e in events] == [eid]
    assert events == jax_journal.read_journal_dir(str(tmp_path))


def test_ambient_events_need_a_window():
    journal.emit(journal.FAULT_INJECTED, site="oom", key="")
    ts = journal.get_journal().tail()[-1]["ts"]
    assert doctor.events_for_query("q_x") == []
    scoped = doctor.events_for_query("q_x", window=(ts - 0.1, ts + 0.1))
    assert [e["eventType"] for e in scoped] == [journal.FAULT_INJECTED]


# --- the finalize pass of the port's session --------------------------------


def _sessions(sf, **config):
    return (jsession.tpch_session(sf, result_cache=False, **config),
            tpch_session(sf, device="cpu", result_cache=False, **config))


def test_healthy_query_diagnosed_healthy():
    js, ts = _sessions(SF)
    for s in (js, ts):
        assert s.execute("select count(*) from lineitem").to_pylist()[0][0] > 0
    d = ts.last_diagnosis
    assert d is not None and d["queryId"].startswith("q_")
    assert d["verdict"] == doctor.HEALTHY and d["errorCode"] == ""
    assert _shape(d, []) == _shape(js.last_diagnosis, [])
    assert doctor.recent_diagnoses()[-1] is d


def test_seeded_oom_diagnosed_memory_pressure():
    """Scenario `oom`: the verdict names memory pressure, carries the
    structured error code and cites the injector's events, and the
    failed query is in the history with the same code, as in the JAX
    package."""
    js, ts = _sessions(0.01, fault_injection=OOM)
    shapes = []
    for s, j in ((js, jax_journal), (ts, journal)):
        with pytest.raises(Exception, match="memory limit"):
            s.execute("select sum(l_extendedprice) from lineitem")
        d = s.last_diagnosis
        assert d["verdict"] == doctor.ROOT_CAUSE
        assert d["rootCause"] == "memory_pressure"
        assert d["errorCode"] == "EXCEEDED_MEMORY_LIMIT"
        events = j.get_journal().tail()
        assert d["eventIds"] and set(d["eventIds"]) <= {e["eventId"] for e in events}
        shapes.append(_shape(d, events))
        failed = [r for r in s.query_history if r["state"] == "FAILED"]
        assert failed[-1]["error_code"] == "EXCEEDED_MEMORY_LIMIT"
    assert shapes[1] == shapes[0]


def test_device_fault_verdict_has_no_cpu_rerun():
    """Witness of the difference on purpose: the port fails a faulted
    query instead of re-running it on the CPU, so its verdict ends at the
    quarantine and carries the DEVICE_LOSS error code.  The JAX package
    with its CPU re-run off gives the same verdict; with it on, the
    degraded re-run step and no error."""
    ts = tpch_session(SF, device="cpu", result_cache=False, fault_injection=LOSS,
                      device_probe_backoff_s=30.0)
    with pytest.raises(DeviceFaultError, match="device_loss"):
        ts.execute(Q6)
    d = ts.last_diagnosis
    assert d["rootCause"] == "device_fault" and d["errorCode"] == "DEVICE_LOSS"
    assert "device_loss on session/" in d["summary"]
    assert d["summary"].endswith("-> quarantine")
    port = _shape(d, journal.get_journal().tail())
    js = jsession.tpch_session(SF, result_cache=False, fault_injection=LOSS,
                               device_probe_backoff_s=30.0, device_cpu_fallback=False)
    with pytest.raises(Exception, match="device_loss"):
        js.execute(Q6)
    assert port == _shape(js.last_diagnosis, jax_journal.get_journal().tail())
    jax_journal._reset_journal()
    js = jsession.tpch_session(SF, result_cache=False, fault_injection=LOSS,
                               device_probe_backoff_s=30.0)
    js.execute(Q6)
    assert js.last_diagnosis["summary"].endswith("-> CPU degraded re-run")
    assert js.last_diagnosis["errorCode"] == ""


def test_seeded_stats_estimate_attributed_by_window():
    """Scenario `stats_estimate` (tests/test_doctor.py:294, in process):
    the injector's firing is an ambient event (no query id), attributed
    to the query by its wall-clock window."""
    import time

    inj = FaultInjector.from_spec({"seed": 1, "stats_estimate": {"factor": 10}})
    t0 = time.time()
    assert inj.fires("stats_estimate", "fragment 1")
    t1 = time.time()
    d = doctor.diagnose_query("q_doc_stats", window=(t0, t1))
    assert d["verdict"] == doctor.ROOT_CAUSE
    assert d["rootCause"] == "estimate_drift"
    assert "stats_estimate" in d["summary"]
    events = journal.get_journal().tail()
    want = jax_doctor.diagnose("q_doc_stats", doctor.events_for_query(
        "q_doc_stats", events=events, window=(t0, t1)))
    assert _shape(d, events) == _shape(want, events)


# --- the SQL surfaces and EXPLAIN ANALYZE ------------------------------------


def test_events_and_diagnoses_queryable_over_sql():
    js, ts = _sessions(SF)
    rows = {}
    for s, j in ((js, jax_journal), (ts, journal)):
        assert s.execute("select count(*) from lineitem").to_pylist() == [(5995,)]
        j.emit(j.STRAGGLER_FLAG, query_id="q_sql_vis", task_id="q_sql_vis.1.0.0",
               wallS=2.0, medianS=0.5)
        rows[s] = s.execute("select event_type, query_id, severity, detail "
                            "from system.runtime.events where query_id = 'q_sql_vis'"
                            ).to_pylist()
        diags = s.execute("select verdict, root_cause, error_code, event_ids, "
                          "findings from system.runtime.diagnoses").to_pylist()
        # the count and the events query, each diagnosed at finalize
        assert diags == [("HEALTHY", "", "", "", 0)] * 2
    assert rows[ts] == rows[js] == [("straggler_flag", "q_sql_vis", "info",
                                     '{"medianS": 0.5, "wallS": 2.0}')]


def test_explain_analyze_carries_diagnosis_section():
    js, ts = _sessions(SF)
    texts = []
    for s in (js, ts):
        text = "\n".join(r[0] for r in s.execute(
            "explain analyze select count(*) from lineitem").to_pylist())
        texts.append(text[text.index("Diagnosis:"):])
    assert texts[1] == texts[0] == (
        "Diagnosis:\n  HEALTHY — no anomalous events correlated with this query")
    assert ts.last_diagnosis["verdict"] == doctor.HEALTHY


def test_doctor_off_records_nothing():
    ts = tpch_session(SF, device="cpu", result_cache=False, query_doctor=False)
    ts.execute("select count(*) from nation")
    text = "\n".join(r[0] for r in ts.execute(
        "explain analyze select count(*) from nation").to_pylist())
    assert ts.last_diagnosis is None and doctor.recent_diagnoses() == []
    assert "Diagnosis:" not in text


# --- post-mortems from disk ----------------------------------------------


_CRASH_CHILD = """
import json, os, sys
sys.path.insert(0, sys.argv[3])
from trino_tpu_torch.session import tpch_session
s = tpch_session(
    0.01, device="cpu",
    event_journal_dir=sys.argv[1],
    query_history_dir=sys.argv[2],
    query_doctor=False,  # the in-process doctor never ran: offline only
    fault_injection=json.dumps({"seed": 7, "oom": {"p": 1.0, "times": 1}}),
)
try:
    s.execute("select sum(l_extendedprice) from lineitem")
except Exception:
    pass
os._exit(137)  # kill -9 semantics: no atexit, no flush, no goodbye
"""


def test_kill9_postmortem_reconstructs_verdict_from_disk(tmp_path):
    """A port process killed mid-incident leaves only its mmap'd
    segments: a fresh process (the doctor's command line) finds the
    crashed query and gives the verdict, and so does the JAX doctor
    over the same directories."""
    jd, hd = str(tmp_path / "journal"), str(tmp_path / "history")
    script = tmp_path / "crash_child.py"
    script.write_text(_CRASH_CHILD)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    child = subprocess.run([sys.executable, str(script), jd, hd, ROOT], env=env,
                           capture_output=True, text=True, timeout=300)
    assert child.returncode == 137, child.stderr[-2000:]
    res = subprocess.run(
        [sys.executable, "-m", "trino_tpu_torch.obs.doctor", "--journal", jd,
         "--history", hd, "--json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    diag = json.loads(res.stdout)
    assert diag["queryId"].startswith("q_")
    assert diag["verdict"] == doctor.ROOT_CAUSE
    assert diag["rootCause"] == "memory_pressure"
    assert diag["errorCode"] == "EXCEEDED_MEMORY_LIMIT"
    assert diag["eventIds"]
    records = history.read_history_dir(hd)
    assert doctor.find_crashed_query(journal.read_journal_dir(jd), records) == diag["queryId"]
    want = jax_doctor.diagnose_from_dir(jd, history_dir=hd)
    events = journal.read_journal_dir(jd)
    assert _shape(diag, events) == _shape(want, events)
    res2 = subprocess.run(
        [sys.executable, "-m", "trino_tpu_torch.obs.doctor", "--journal", jd,
         "--history", hd], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert res2.returncode == 0
    assert diag["queryId"] in res2.stdout and "memory_pressure" in res2.stdout
    empty = subprocess.run(
        [sys.executable, "-m", "trino_tpu_torch.obs.doctor", "--journal",
         str(tmp_path / "nowhere")], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert empty.returncode == 1


@pytest.mark.parametrize("fallback", [True, False], ids=["cpu_rerun", "no_rerun"])
def test_jax_written_directory_gets_the_jax_verdict(tmp_path, fallback):
    """A journal and history directory the JAX package wrote (Q6 under a
    device loss, with and without its CPU re-run) diagnosed by both
    doctors: the same verdict, the re-run step included."""
    jd, hd = str(tmp_path / "journal"), str(tmp_path / "history")
    jax_journal.configure(jd)
    try:
        js = jsession.tpch_session(SF, result_cache=False, fault_injection=LOSS,
                                   device_probe_backoff_s=30.0, query_history_dir=hd,
                                   device_cpu_fallback=fallback)
        try:
            js.execute(Q6)
        except Exception:  # noqa: BLE001 — without the re-run Q6 fails
            assert not fallback
        jax_journal.sync()
    finally:
        jax_journal._reset_journal()
    # a finished query is no crash: name it
    qid = None if not fallback else js.last_diagnosis["queryId"]
    port = doctor.diagnose_from_dir(jd, query_id=qid, history_dir=hd)
    want = jax_doctor.diagnose_from_dir(jd, query_id=qid, history_dir=hd)
    assert port["rootCause"] == "device_fault"
    assert {k: v for k, v in port.items() if k not in ("ts", "wallS")} == {
        k: v for k, v in want.items() if k not in ("ts", "wallS")}
    assert port["summary"].endswith("-> CPU degraded re-run") == fallback
