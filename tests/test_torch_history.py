"""The port's crash-safe query history against the JAX package's.

Both packages' sessions run the same statements over the same generated
data (the port on the CPU, result caches off), each with a history
directory of its own: the records on disk, RUNNING then FINISHED or
FAILED for every statement, must match field by field apart from query
ids, timestamps and walls.  Beside that: the byte budget and its
eviction, re-reading after a restart, a torn tail, a SIGKILL mid-run,
and directories one package wrote read by the other's reader, store and
SQL (tests/test_opstats.py:145-220 for the reference's cases).
"""
import os
import signal
import subprocess
import sys

import pytest

import trino_tpu.session as jsession
from trino_tpu.obs import history as jax_history
from trino_tpu_torch.obs import history
from trino_tpu_torch.session import tpch_session

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.001
# the fields that may differ between the packages' runs
VOLATILE = ("queryId", "created", "finished", "wallS", "ts")

STATEMENTS = (
    "select count(*) from lineitem",
    "select l_returnflag, sum(l_quantity) q from lineitem "
    "group by l_returnflag order by l_returnflag",
    "select no_such_column from nation",
    "show catalogs",
    "select n_name from nation where n_nationkey < 3 order by n_name",
    "select 1 / 0",
)


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
def _fresh_stores():
    history._reset_stores()
    jax_history._reset_stores()
    yield
    history._reset_stores()
    jax_history._reset_stores()


def _run(session, statements=STATEMENTS):
    for sql in statements:
        try:
            session.execute(sql)
        except Exception:  # noqa: BLE001 — failures are recorded too
            pass


def _stable(records):
    return [{k: v for k, v in r.items() if k not in VOLATILE} for r in records]


def test_history_records_match_jax(tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _run(jsession.tpch_session(SF, result_cache=False, query_history_dir=jd))
    _run(tpch_session(SF, device="cpu", result_cache=False, query_history_dir=td))
    jax, port = jax_history.read_history_dir(jd), history.read_history_dir(td)
    assert len(port) == 2 * len(STATEMENTS)
    assert [sorted(r) for r in port] == [sorted(r) for r in jax]
    assert sorted(port[0]) == sorted(history.HISTORY_FIELDS)
    assert history.HISTORY_FIELDS == jax_history.HISTORY_FIELDS
    assert _stable(port) == _stable(jax)
    states = [(r["state"], r["errorCode"]) for r in port if r["state"] != "RUNNING"]
    assert states == [("FINISHED", ""), ("FINISHED", ""),
                      ("FAILED", "INTERNAL_ERROR"), ("FINISHED", ""),
                      ("FINISHED", ""), ("FINISHED", "")]
    for r in port:
        if r["state"] != "RUNNING":
            assert r["finished"] >= r["created"] and r["wallS"] >= 0


def test_query_history_view_and_sql_match_jax():
    """`Session.query_history` and system.runtime.queries /
    completed_queries over the process's memory-only store."""
    js = jsession.tpch_session(SF, result_cache=False)
    ts = tpch_session(SF, device="cpu", result_cache=False)
    for s in (js, ts):
        _run(s)
    keys = ("state", "sql", "user", "rows", "error", "error_code")
    assert ([{k: h[k] for k in keys} for h in ts.query_history]
            == [{k: h[k] for k in keys} for h in js.query_history])
    sql = ("select state, query, user, rows, error, error_code, tenant, "
           "plan_signature, operators from system.runtime.completed_queries")
    assert ts.execute(sql).to_pylist() == js.execute(sql).to_pylist()
    sql = "select state, query, user, rows, error from system.runtime.queries"
    jrows, trows = js.execute(sql).to_pylist(), ts.execute(sql).to_pylist()
    # each package's store now also holds the statement that reads it
    assert trows[:-1] == jrows[:-1] and trows[-1][0] == jrows[-1][0] == "RUNNING"


def _fill(store):
    for i in range(400):
        store.put({
            "query_id": f"q_{i}", "state": "FINISHED",
            "sql": "SELECT " + "x" * 1024, "user": "t",
            "created": float(i), "finished": float(i), "rows": i,
        })


@pytest.mark.parametrize("directory", [False, True], ids=["memory", "disk"])
def test_byte_budget_evicts_like_jax(tmp_path, directory):
    """max_bytes clamps to two 64 KiB segments; 400 records of ~1 KiB
    overflow it several times: the oldest go first, in both packages."""
    port = history.QueryHistoryStore(str(tmp_path / "p") if directory else None,
                                     max_bytes=4096)
    jax = jax_history.QueryHistoryStore(str(tmp_path / "j") if directory else None,
                                        max_bytes=4096)
    for store in (port, jax):
        _fill(store)
    assert port.total_bytes() <= port.max_bytes == jax.max_bytes
    assert 0 < len(port.entries()) < 400
    assert port.entries()[-1]["queryId"] == "q_399"
    assert [e["queryId"] for e in port.entries()] == [e["queryId"] for e in jax.entries()]
    if directory:
        on_disk = history.read_history_dir(str(tmp_path / "p"))
        assert on_disk and on_disk[-1]["queryId"] == "q_399"
        assert ([r["queryId"] for r in on_disk]
                == [r["queryId"] for r in jax_history.read_history_dir(str(tmp_path / "j"))])
    port.close()
    jax.close()


def test_restart_rereads_the_directory(tmp_path):
    d = str(tmp_path)
    s = tpch_session(SF, device="cpu", result_cache=False, query_history_dir=d)
    s.execute("select count(*) from nation")
    s.execute("select count(*) from region")
    history._reset_stores()  # the process "restarts"
    s2 = tpch_session(SF, device="cpu", result_cache=False, query_history_dir=d)
    rows = s2.execute("select query, state, rows from system.runtime.completed_queries"
                      " order by created").to_pylist()
    assert rows[:2] == [("select count(*) from nation", "FINISHED", 1),
                        ("select count(*) from region", "FINISHED", 1)]
    # appends resume after the survivors: nothing is overwritten
    history._reset_stores()
    assert len([r for r in history.read_history_dir(d) if r["state"] == "FINISHED"]) == 3


def test_torn_tail_reads_alike(tmp_path):
    """A line half-written at the instant of death parses to nothing,
    never to an error, in both packages' readers."""
    store = history.QueryHistoryStore(str(tmp_path), name="w1")
    for i in range(3):
        store.put({"query_id": f"q_{i}", "state": "FINISHED", "sql": f"select {i}",
                   "created": float(i), "rows": i})
    store.close()
    with open(tmp_path / (history._FILE_PREFIX + "crashed-0.jsonl"), "wb") as f:
        f.write(b'{"queryId": "q_torn", "state": "FINI')
    port = history.read_history_dir(str(tmp_path))
    assert [r["queryId"] for r in port] == ["q_0", "q_1", "q_2"]
    assert port == jax_history.read_history_dir(str(tmp_path))
    # a store re-opening its own torn segment appends after the last
    # intact line
    with open(tmp_path / (history._FILE_PREFIX + "w1-0.jsonl"), "r+b") as f:
        data = f.read()
        end = data.index(b"\0")
        f.seek(end)
        f.write(b'{"queryId": "q_half')
    again = history.QueryHistoryStore(str(tmp_path), name="w1")
    again.put({"query_id": "q_3", "state": "FINISHED", "sql": "select 3"})
    again.close()
    assert ([r["queryId"] for r in history.read_history_dir(str(tmp_path))]
            == ["q_0", "q_1", "q_2", "q_3"])


_CRASH_CHILD = """
import os, sys, time
sys.path.insert(0, %(repo)r)
from trino_tpu_torch.obs.history import QueryHistoryStore

store = QueryHistoryStore(%(dir)r, max_bytes=1 << 20)
for i in range(5):
    store.put({
        "query_id": "q_crash_%%d" %% i, "state": "FINISHED",
        "sql": "SELECT %%d" %% i, "user": "crash-test",
        "created": 1000.0 + i, "finished": 1001.0 + i, "rows": i,
    })
# no close(), no flush, no atexit: readiness then hang for SIGKILL
print("READY", flush=True)
time.sleep(60)
"""


def test_history_survives_kill9_and_is_read_by_both_packages(tmp_path):
    script = _CRASH_CHILD % {"repo": ROOT, "dir": str(tmp_path)}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.strip() == "READY", proc.stderr.read()
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=30)
    port = history.read_history_dir(str(tmp_path))
    assert {r["queryId"] for r in port} == {f"q_crash_{i}" for i in range(5)}
    assert port == jax_history.read_history_dir(str(tmp_path))
    # "restart" in the JAX package: its session serves the port's records
    s = jsession.tpch_session(SF, query_history_dir=str(tmp_path))
    rows = s.execute("select query_id, state, rows from "
                     "system.runtime.completed_queries").to_pylist()
    assert {r[0]: r[2] for r in rows if r[0].startswith("q_crash")} == {
        f"q_crash_{i}": i for i in range(5)}


def test_directories_cross_between_the_packages(tmp_path):
    """A directory the JAX package's sessions wrote is re-opened by the
    port's store and served by its SQL, and the other way round."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _run(jsession.tpch_session(SF, result_cache=False, query_history_dir=jd),
         STATEMENTS[:3])
    _run(tpch_session(SF, device="cpu", result_cache=False, query_history_dir=td),
         STATEMENTS[:3])
    history._reset_stores()
    jax_history._reset_stores()
    sql = ("select query, state, rows, error_code from "
           "system.runtime.completed_queries order by created")
    port_reads_jax = tpch_session(SF, device="cpu", query_history_dir=jd).execute(sql)
    jax_reads_port = jsession.tpch_session(SF, query_history_dir=td).execute(sql)
    want = [(STATEMENTS[0], "FINISHED", 1, ""), (STATEMENTS[1], "FINISHED", 3, ""),
            (STATEMENTS[2], "FAILED", 0, "INTERNAL_ERROR")]
    assert port_reads_jax.to_pylist() == want
    assert jax_reads_port.to_pylist() == want
