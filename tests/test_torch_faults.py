"""The port's fault injection, incident journal and flight recorder
against the JAX package's.

The FaultInjector unit tests of tests/test_faults.py:91-133 on the port
(and its seeded firings equal the JAX injector's); a GROUP BY under
`distributed = true` over 4 shards against the JAX package's mesh; the
refusal of the padding-ladder properties (SET, like any property the
port has no machinery for); the memory manager's seeded `oom` site and its journal
events; the result cache's journaled heal (CACHE_HEAL); the same fault
scenario journaled with the same kinds and fields by both packages; and
journal / flight-recorder directories one package writes read by the
other's readers.
"""
import json
import os
import re
import tempfile

import pytest

import trino_tpu.session as jsession
from tpch_sql import QUERIES
from trino_tpu.obs import flight_recorder as jax_fr
from trino_tpu.obs import journal as jax_journal
from trino_tpu.utils.faults import FaultInjector as JaxFaultInjector
from trino_tpu_torch import types as T
from trino_tpu_torch.cache.result_cache import FragmentResultCache
from trino_tpu_torch.memory import LocalMemoryManager
from trino_tpu_torch.obs import flight_recorder as fr
from trino_tpu_torch.obs import journal
from trino_tpu_torch.page import page_from_pydict
from trino_tpu_torch.runtime import Breadcrumb
from trino_tpu_torch.session import tpch_session
from trino_tpu_torch.utils.faults import SITES, FaultInjector
from trino_tpu_torch.utils.memory import ExceededMemoryLimitError

GROUP_BY = ("select l_returnflag, count(*) c from lineitem "
            "group by l_returnflag order by l_returnflag")


@pytest.fixture(autouse=True)
def _fresh_journals():
    journal._reset_journal()
    jax_journal._reset_journal()
    yield
    journal._reset_journal()
    jax_journal._reset_journal()


# --- FaultInjector unit behavior ------------------------------------------


def test_fault_injector_seeded_determinism():
    rules = lambda: {"exchange_fetch": {"p": 0.5, "times": 3}}  # noqa: E731
    a = FaultInjector(rules(), seed=42)
    b = FaultInjector(rules(), seed=42)
    pa = [a.fires("exchange_fetch") for _ in range(30)]
    assert pa == [b.fires("exchange_fetch") for _ in range(30)]
    assert sum(pa) == 3  # times cap
    assert a.fired_count("exchange_fetch") == 3
    # the same spec fires at the same calls in both packages
    j = JaxFaultInjector(rules(), seed=42)
    assert pa == [j.fires("exchange_fetch") for _ in range(30)]


def test_fault_injector_nth_and_match():
    inj = FaultInjector({"task_run": {"nth": 2, "match": "q1."}})
    assert not inj.fires("task_run", key="q2.1.0.0")  # scoped out: no count
    assert not inj.fires("task_run", key="q1.1.0.0")  # call 1
    assert inj.fires("task_run", key="q1.1.0.1")      # call 2: fires
    assert not inj.fires("task_run", key="q1.1.0.2")
    assert inj.fired_count("task_run") == 1


def test_fault_injector_spec_parsing():
    assert not FaultInjector.from_spec("").enabled()
    assert not FaultInjector.from_spec(None).enabled()
    inj = FaultInjector.from_spec('{"seed": 7, "heartbeat": {"nth": 1}}')
    assert inj.enabled() and inj.seed == 7
    with pytest.raises(ValueError):
        FaultInjector({"bogus_site": {}})
    from trino_tpu.utils.faults import SITES as JAX_SITES

    assert SITES == JAX_SITES


def test_fault_injector_corrupt_flips_one_bit():
    inj = FaultInjector({"spool_write_corrupt": {"flip_byte": 5}}, seed=1)
    out = inj.corrupt("spool_write_corrupt", b"hello world")
    assert out[5] == b"hello world"[5] ^ 0x01
    assert out[:5] == b"hello" and out[6:] == b"world"
    assert inj.corrupt("spool_read", b"abc") == b"abc"


def test_fault_firings_are_journaled():
    inj = FaultInjector({"oom": {"nth": 1}})
    assert inj.fires("oom", key="q7")
    (event,) = journal.get_journal().tail()
    assert event["eventType"] == journal.FAULT_INJECTED
    assert event["detail"] == {"site": "oom", "key": "q7"}
    assert event["severity"] == journal.WARN


# --- refusals (C.1, C.2) ---------------------------------------------------


def test_distributed_true_is_refused():
    """SET SESSION distributed = true and num_devices = 4, then a GROUP
    BY: the port runs it over a mesh of 4 shards, and the page is the
    JAX package's mesh page (4 virtual devices); EXPLAIN of the
    distributed plan is the planner's and still works.  (The name is
    the refusal's this test once witnessed.)"""
    s = tpch_session(0.001, device="cpu", result_cache=False)
    s.execute("set session distributed = true")
    s.execute("set session num_devices = 4")
    js = jsession.tpch_session(0.001, result_cache=False)
    js.execute("set session distributed = true")
    js.execute("set session num_devices = 4")
    rows = s.execute(GROUP_BY).to_pylist()
    assert rows == js.execute(GROUP_BY).to_pylist()
    assert s.last_kernel_profile["mesh"]["shards"] == 4
    text = "\n".join(r[0] for r in s.execute(
        "explain (type distributed) " + GROUP_BY).to_pylist())
    assert "Fragment" in text
    s.execute("set session distributed = false")
    assert s.execute(GROUP_BY).to_pylist() == rows and len(rows) == 3
    assert "mesh" not in s.last_kernel_profile


@pytest.mark.parametrize("prop", ["padding_ladder", "padding_ladder_file"])
def test_padding_ladder_properties_are_refused(prop):
    """An eager executor pads nothing: SET refuses the ladder like
    group_capacity, where the JAX package accepts it."""
    s = tpch_session(0.001, device="cpu")
    with pytest.raises(KeyError, match=f"unknown session property: {prop}"):
        s.execute(f"set session {prop} = 'off'")
    js = jsession.tpch_session(0.001, result_cache=False)
    js.execute(f"set session {prop} = 'off'")


# --- the oom site, the memory journal, the cache heal -----------------------


def test_oom_site_behaves_like_a_short_pool_in_both_packages():
    from trino_tpu.memory import LocalMemoryManager as JaxManager

    outcomes = []
    for manager, inj in ((LocalMemoryManager(1 << 20, node_id="n"),
                          FaultInjector({"oom": {"nth": 1}})),
                         (JaxManager(1 << 20, node_id="n"),
                          JaxFaultInjector({"oom": {"nth": 1}}))):
        manager.fault_injector = inj
        freed = []
        manager.register_revocable("other", 4096, lambda: freed.append(1) or 4096)
        with pytest.raises(Exception) as ei:
            manager.reserve("q1", 1024)
        assert freed == [1]  # the revocation path ran first
        manager.reserve("q1", 1024)  # the rule fired once: the pool is fine
        manager.kill("q2", "low memory")
        outcomes.append((type(ei.value).__name__, str(ei.value)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == "ExceededMemoryLimitError"
    port = [(e["eventType"], sorted(e["detail"]))
            for e in journal.get_journal().tail()]
    jax = [(e["eventType"], sorted(e["detail"]))
           for e in jax_journal.get_journal().tail()]
    assert port == jax
    assert [k for k, _ in port] == [journal.FAULT_INJECTED, journal.MEMORY_REVOKE,
                                    journal.MEMORY_KILL]


def test_oom_fault_through_the_session_matches_jax():
    spec = json.dumps({"oom": {"nth": 1}})
    js = jsession.tpch_session(0.001, result_cache=False, fault_injection=spec,
                               device_generation=False)
    ts = tpch_session(0.001, device="cpu", result_cache=False, fault_injection=spec,
                      device_generation=False)
    errors = []
    for s in (js, ts):
        with pytest.raises(RuntimeError) as ei:
            s.execute(GROUP_BY)
        errors.append((type(ei.value).__name__,
                       re.sub(r"query q_[0-9a-f]+", "query", str(ei.value))))
        # the rule fired once: the next run answers
        assert len(s.execute(GROUP_BY).to_pylist()) == 3
    assert errors[0] == errors[1]
    assert isinstance(ei.value, ExceededMemoryLimitError)
    assert "cannot reserve" in errors[1][1]


def test_result_cache_heal_is_journaled():
    with tempfile.TemporaryDirectory() as d:
        rc = FragmentResultCache(max_bytes=1000, spill_dir=d, max_entry_fraction=1.0)
        page = page_from_pydict([("x", T.BIGINT)], {"x": list(range(100))})
        rc.put(("k1",), page)
        rc.put(("k2",), page)  # spills k1
        inj = FaultInjector.from_spec({"seed": 7, "cache_read": {"nth": 1}})
        assert rc.get(("k1",), injector=inj) is None
        assert rc.heals == 1 and os.listdir(d) == []
    kinds = [e["eventType"] for e in journal.get_journal().tail()]
    assert kinds == [journal.FAULT_INJECTED, journal.CACHE_HEAL]
    heal = journal.get_journal().tail()[-1]
    assert heal["detail"]["reason"] == "checksum mismatch"
    assert heal["severity"] == journal.WARN


# --- one fault scenario, journaled alike -----------------------------------


def _shape(events):
    """The scenario's journal, ids, timestamps and texts aside."""
    out = []
    for e in events:
        d = dict(e["detail"])
        for k in ("kernel", "cause", "key", "error"):
            d.pop(k, None)
        out.append((e["eventType"], e["severity"], e["nodeId"], sorted(e),
                    sorted(e["detail"]), d))
    return out


def test_device_fault_scenario_journals_alike():
    """Q6 under a seeded device loss (the JAX package with its CPU re-run
    off, which the port does not have), then a failed query: both
    packages journal the same kinds, fields and values (device, strikes,
    kind, the failures' errorCode), apart from ids, times, kernel names
    and error texts."""
    spec = json.dumps({"device_loss": {"nth": 1}})
    js = jsession.Session(config={"result_cache": False, "fault_injection": spec,
                                  "device_probe_backoff_s": 30.0,
                                  "device_cpu_fallback": False})
    js.create_catalog("tpch", "tpch", {"tpch.scale-factor": 0.001})
    ts = tpch_session(0.001, device="cpu", result_cache=False, fault_injection=spec,
                      device_probe_backoff_s=30.0)
    for s in (js, ts):
        with pytest.raises(Exception, match="device_loss"):
            s.execute(QUERIES[6][0])
        with pytest.raises(Exception):
            s.execute("select no_such_column from lineitem")
    jax = _shape(jax_journal.get_journal().tail())
    port = _shape(journal.get_journal().tail())
    # the JAX package warms up with compile-observatory events the port
    # has no counterpart for; QUERY_FAILED carries the doctor's errorCode
    # in both
    jax = [e for e in jax if e[0] in {k for k, *_ in port}]
    assert [e[5].get("errorCode") for e in port if e[0] == journal.QUERY_FAILED] == [
        "DEVICE_LOSS", "INTERNAL_ERROR"]
    assert [e[0] for e in port] == [
        journal.FAULT_INJECTED, journal.DEVICE_FAULT, journal.DEVICE_QUARANTINE,
        journal.QUERY_FAILED, journal.QUERY_FAILED]
    assert port == jax


def test_journal_directories_cross_between_the_packages(tmp_path):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    journal.configure(port_dir)
    jax_journal.configure(jax_dir)
    for mod in (journal, jax_journal):
        mod.emit(mod.DEVICE_FAULT, query_id="q1", node_id="session",
                 severity=mod.ERROR, kind="device_loss", kernel="k", device=0)
        mod.emit(mod.CPU_FALLBACK, query_id="q1", severity=mod.WARN)
    for d in (port_dir, jax_dir):
        a = [(e["eventType"], e["queryId"], e["detail"]) for e in journal.read_journal_dir(d)]
        b = [(e["eventType"], e["queryId"], e["detail"])
             for e in jax_journal.read_journal_dir(d)]
        assert a == b and [k for k, *_ in a] == ["device_fault", "cpu_fallback"]


def test_flight_recorder_rings_cross_between_the_packages(tmp_path):
    assert fr.RECORD_FIELDS == jax_fr.RECORD_FIELDS
    rec = fr.FlightRecorder(str(tmp_path), max_records=8, name="n")
    bc = Breadcrumb("fused_agg_sums", query_id="q", node_id="n",
                    shapes={"live": "bool(10,)"})
    done = rec.record_dispatch(bc)
    rec.record_complete(done, bc, 0.001)
    rec.record_dispatch(Breadcrumb("grouped_sum_i64", node_id="n"))  # in flight
    rec.sync()
    for read in (fr.read_dir, jax_fr.read_dir):
        records = read(str(tmp_path))
        assert [r["recordType"] for r in records] == ["dispatch", "complete", "dispatch"]
        assert records[1]["hbmPeakBytes"] == 0  # no card touched: no watermark
        assert jax_fr.last_unmatched(records)["kernel"] == "grouped_sum_i64"
        assert fr.last_unmatched(records)["kernel"] == "grouped_sum_i64"
    rec.close()
