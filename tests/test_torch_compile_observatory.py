"""The port's compile observatory and compile cache against the JAX
package's.

The reference's non-server cases (tests/test_compile_observatory.py:53-153,
:225, :297-317, :438) rewritten for the port's choke points: the cause
taxonomy, the cold window, the pid-guarded ingest, the ledger records and
census rows (equal to the JAX observatory's for the same calls), the
retry ladder's ladder_rung, a warm family's new program as a shape_miss,
zero events on a warm run, the cross-process census merge, the SIGKILL
torn tail, the retrace storm reaching the doctor and the SQL/EXPLAIN
ANALYZE surfaces.  Then the compile cache (cache/compile_cache.py): a
second session re-encodes nothing (tests/test_cache.py:319), the LRU
bound, `compile_cache = false`, and the persistent tier in a temporary
`compile_cache_dir` read by a second process; and the nvcc choke point
(ops/kernels.build) on libraries an earlier process left.
"""
import json
import os
import signal
import subprocess
import sys

import pytest

from tpch_sql import QUERIES
from trino_tpu.obs import compile_observatory as jax_co
from trino_tpu.obs import doctor as jax_doctor
from trino_tpu.obs import journal as jax_journal
from trino_tpu_torch.cache import compile_cache as cc_mod
from trino_tpu_torch.obs import compile_observatory as co
from trino_tpu_torch.obs import doctor, journal
from trino_tpu_torch.ops import kernels as kn
from trino_tpu_torch.session import Session, tpch_session

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.001
Q6 = QUERIES[6][0]
# the fields that may differ between the packages' records of one call
VOLATILE = ("compileId", "ts", "compileWallS")


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
def _fresh_state(monkeypatch):
    """Clean process-global ledgers: the classifier is warm/cold stateful
    and the doctor windows over the journal; and a compile cache of the
    test's own (another test in this process may have encoded its
    programs)."""
    monkeypatch.setattr(cc_mod, "_SHARED", None)
    for m in (co, jax_co):
        m._reset_observatory()
    for j, d in ((journal, doctor), (jax_journal, jax_doctor)):
        j._reset_journal()
        d._reset_diagnoses()
    yield
    for m in (co, jax_co):
        m._reset_observatory()
    for j, d in ((journal, doctor), (jax_journal, jax_doctor)):
        j._reset_journal()
        d._reset_diagnoses()


def _cold(mod, **kw):
    kw.setdefault("family_cold_s", 0.0)
    return mod.CompileObservatory(None, **kw)


# --- the cause taxonomy, held to the JAX observatory --------------------


def _taxonomy(mod):
    obs = _cold(mod)
    out = [obs.classify("f1", "s1")]
    out.append(obs.record(kernel="k1", family="f1", shape_sig="s1", query_id="qA")["cause"])
    out += [obs.classify("f1", "s1", query_id="qB"),
            obs.classify("f1", "s2", query_id="qA"),
            obs.classify("f1", "s2", query_id="qB"),
            obs.classify("f1", "s2", ladder_attempt=2, query_id="qB"),
            obs.classify("f1", "s2", ladder_attempt=2, poisoned=True),
            obs.classify("f1", "s1", persistent=True)]
    return out, obs.counts_by_cause()


def test_cause_taxonomy_precedence():
    got, counts = _taxonomy(co)
    assert got == [co.FIRST_COMPILE, co.FIRST_COMPILE, co.FIRST_COMPILE,
                   co.FIRST_COMPILE, co.SHAPE_MISS, co.LADDER_RUNG,
                   co.POISONED_RECOVERY, co.PERSISTENT_LOAD]
    assert (got, counts) == _taxonomy(jax_co)
    assert co.CAUSES == jax_co.CAUSES
    assert co.COMPILE_FIELDS == jax_co.COMPILE_FIELDS
    assert co.CENSUS_FIELDS == jax_co.CENSUS_FIELDS


def test_family_cold_window_absorbs_concurrent_cold_start():
    for mod in (co, jax_co):
        warm = mod.CompileObservatory(None, family_cold_s=60.0)
        warm.record(kernel="k", family="f", shape_sig="sA", query_id="qA")
        assert warm.classify("f", "sB", query_id="qB") == mod.FIRST_COMPILE
        cold = _cold(mod)
        cold.record(kernel="k", family="f", shape_sig="sA", query_id="qA")
        assert cold.classify("f", "sB", query_id="qB") == mod.SHAPE_MISS


def test_ingest_is_pid_guarded_and_census_replaces_per_node():
    obs = _cold(co)
    obs.record(kernel="k", family="f", shape_sig="s", query_id="q1", scan_rows=[100])
    obs.ingest("self-node", obs.announce_snapshot())
    assert obs.counts_by_cause()[co.FIRST_COMPILE] == 1  # not doubled
    assert len(obs.tail()) == 1
    remote = {
        "pid": os.getpid() + 1, "counts": {co.SHAPE_MISS: 3}, "compileWallS": 1.5,
        "census": {"families": {"rf": {"count": 4, "minRows": 10, "maxRows": 20,
                                       "totalRows": 60, "buckets": {"32": 4}}}},
        "events": [],
    }
    for _ in range(5):  # cumulative re-announcement: replace, not add
        obs.ingest("w2", remote)
    assert obs.counts_by_cause()[co.SHAPE_MISS] == 3
    assert obs.merged_census().families["rf"]["count"] == 4
    assert obs.total_compile_wall_s() == pytest.approx(obs.compile_wall_s + 1.5)


def _calls(obs):
    """One sequence of compiles every choke point of either package makes."""
    obs.record(kernel="lib-a", family="nvcc:a.cu", cause=co.FIRST_COMPILE, mode="nvcc",
               shapes={"source": "a.cu"}, scan_rows=[])
    obs.record(kernel="k0", family="fam", shape_sig="s0", query_id="q0",
               actual_rows=100, padded_rows=128, scan_rows=[100, 3000])
    obs.record(kernel="k1", family="fam", shape_sig="s1", query_id="q1",
               actual_rows=70000, scan_rows=[70000])
    obs.record(kernel="eager-1", family="fam", mode="eager", query_id="q1",
               ladder_attempt=1, scan_rows=[])
    obs.record(kernel="k0", family="fam", shape_sig="s0", persistent=True,
               query_id="q2", task_id="t", node_id="n")


def test_records_and_census_match_jax(tmp_path):
    """The same calls give the same ledger records (apart from ids, times
    and walls) and census rows, and each package's directory is read by
    the other's readers."""
    port = co.CompileObservatory(str(tmp_path / "p"), name="w", family_cold_s=0.0)
    jax = jax_co.CompileObservatory(str(tmp_path / "j"), name="w", family_cold_s=0.0)
    for obs in (port, jax):
        _calls(obs)
        obs.sync()

    def stable(events):
        return [{k: v for k, v in e.items() if k not in VOLATILE} for e in events]

    assert [e["cause"] for e in port.tail()] == [
        co.FIRST_COMPILE, co.FIRST_COMPILE, co.SHAPE_MISS, co.LADDER_RUNG,
        co.PERSISTENT_LOAD]
    assert stable(port.tail()) == stable(jax.tail())
    assert sorted(port.tail()[0]) == sorted(co.COMPILE_FIELDS)
    assert port.census.rows() == jax.census.rows()
    assert port.counts_by_cause() == jax.counts_by_cause()
    for d in ("p", "j"):
        path = str(tmp_path / d)
        assert stable(co.read_observatory_dir(path)) == stable(jax_co.read_observatory_dir(path))
        assert co.read_census_dir(path).rows() == jax_co.read_census_dir(path).rows()
    assert stable(co.read_observatory_dir(str(tmp_path / "j"))) == stable(port.tail())


def test_launch_census_rows_over_sql():
    """The row count of every kernel launch (observe_launch, under the
    wrapper's name) is what system.runtime.shape_census reads."""
    obs = co.get_observatory()
    for rows in (100, 5000, 6000, 60_000_000):
        obs.observe_launch("fused_agg_sums", rows)
    obs.observe_launch("direct_probe", 15_000_000)
    s = tpch_session(SF, device="cpu")
    rows = s.execute("select family, bucket, count, min_rows, max_rows, total_rows "
                     "from system.runtime.shape_census order by family, bucket").to_pylist()
    assert rows == [
        ("direct_probe", 16777216, 1, 15_000_000, 15_000_000, 15_000_000),
        ("fused_agg_sums", 128, 1, 100, 60_000_000, 60_011_100),
        ("fused_agg_sums", 8192, 2, 100, 60_000_000, 60_011_100),
        ("fused_agg_sums", 67108864, 1, 100, 60_000_000, 60_011_100),
    ]
    assert obs.tail() == []  # a launch compiles nothing


# --- engine-level causes -------------------------------------------------


def _wide_session():
    s = Session(config={"result_cache": False}, device="cpu")
    s.create_catalog("mem", "memory", {})
    s.execute("create table mem.default.w (a decimal(18,0))")
    s.execute("insert into mem.default.w values (3000000000), (2)")
    return s


def test_ladder_rung_cause_via_the_retry_ladder():
    """A decimal product past the int64 range fires the executor's
    overflow check: its re-run with the 128-bit kernels is a ladder_rung
    of the plan's family, and the warm repeat starts on that rung."""
    s = _wide_session()
    q = "select sum(a * a) from mem.default.w"
    assert s.execute(q).to_pylist() == [(9000000000000000004,)]
    assert s.last_kernel_profile["summary"]["compilesByCause"] == {co.LADDER_RUNG: 1}
    ev = co.get_observatory().tail()[-1]
    assert (ev["cause"], ev["kernel"], ev["mode"]) == (co.LADDER_RUNG, "eager-1", "eager")
    assert ev["queryId"] == s.last_diagnosis["queryId"]
    assert ev["family"] == cc_mod.fragment_family(s.plan(q))
    s.execute(q)
    assert s.last_kernel_profile["summary"]["compilesByCause"] == {}
    assert co.get_observatory().counts_by_cause()[co.LADDER_RUNG] == 1


def _memory_sum_session():
    s = Session(config={"result_cache": False, "megakernels": "on"}, device="cpu")
    s.create_catalog("mem", "memory", {})
    s.execute("create table mem.default.t (a bigint, b bigint)")
    s.execute("insert into mem.default.t values (1, 0), (2, 1), (3, 2), (4, 3)")
    s.execute("analyze mem.default.t")
    return s


def _aggregate(node):
    from trino_tpu_torch.plan import nodes as P

    while not isinstance(node, P.Aggregate):
        (node,) = node.sources
    return node


def test_shape_miss_cause_via_a_new_program():
    """The same fused fragment over new statistics: the bound of `a`
    grows past the per-term limit, so the program splits its term into
    16-bit limbs -- a warm family with a new shape signature."""
    co.get_observatory()._family_cold_s = 0.0
    s = _memory_sum_session()
    q = "select sum(a), count(*) from mem.default.t where b < 3"
    assert s.execute(q).to_pylist() == [(6, 3)]
    s.execute("insert into mem.default.t values (50000000, 2)")
    s.execute("analyze mem.default.t")
    assert s.execute(q).to_pylist() == [(50000006, 4)]
    first, miss = co.get_observatory().tail()
    assert (first["cause"], miss["cause"]) == (co.FIRST_COMPILE, co.SHAPE_MISS)
    assert first["family"] == miss["family"] == cc_mod.fragment_family(_aggregate(s.plan(q)))
    assert first["kernel"] != miss["kernel"]
    assert miss["shapes"]["terms"] > first["shapes"]["terms"]


def test_warm_second_query_records_zero_compile_events():
    """A second identical query (result cache off, so it really runs)
    reuses its encoded program: the ledger gains nothing, in both
    packages."""
    import trino_tpu.session as jsession

    sql = ("select sum(l_extendedprice * l_discount) from lineitem "
           "where l_quantity < 24")
    for s, obs in ((tpch_session(SF, device="cpu", result_cache=False, megakernels="on"),
                    co.get_observatory()),
                   (jsession.tpch_session(SF, result_cache=False),
                    jax_co.get_observatory())):
        r1 = s.execute(sql).to_pylist()
        before_events, before_counts = len(obs.tail()), dict(obs.counts_by_cause())
        assert before_events >= 1, "first execution recorded no compiles"
        assert s.execute(sql).to_pylist() == r1
        assert len(obs.tail()) == before_events
        assert dict(obs.counts_by_cause()) == before_counts
    assert [e["cause"] for e in co.get_observatory().tail()] == [co.FIRST_COMPILE]


def test_compiles_queryable_over_sql_and_explain_analyze():
    s = tpch_session(SF, device="cpu", result_cache=False, megakernels="on")
    s.execute(Q6)
    rows = s.execute("select cause, kernel, family, mode, query_id "
                     "from system.runtime.compiles").to_pylist()
    assert rows and all(r[0] in co.CAUSES for r in rows)
    assert rows[0][0] == co.FIRST_COMPILE and rows[0][1].startswith("fused_agg_sums:")
    assert rows[0][3] == "encode" and rows[0][4].startswith("q_")

    def compiles(text):
        text = "\n".join(r[0] for r in text.to_pylist())
        return text[text.index("Compiles:"):text.index("\n\n", text.index("Compiles:"))]

    sql = "explain analyze " + Q6.replace("0.06", "0.07")
    assert compiles(s.execute(sql)) == "Compiles:\n  first_compile: 1"
    assert compiles(s.execute(sql)) == "Compiles:\n  (no compiles this query)"


# --- durability: cross-process census merge, kill -9 torn tail -----------


_WORKER_CHILD = """
import sys
sys.path.insert(0, %(repo)r)
from trino_tpu_torch.obs.compile_observatory import CompileObservatory

obs = CompileObservatory(%(dir)r, name=%(name)r, family_cold_s=0.0)
for i in range(%(n)d):
    obs.record(kernel="k-%%d" %% i, family=%(family)r,
               shape_sig="s-%%d" %% i, query_id="q-%(name)s",
               scan_rows=[%(rows)d])
obs.sync()
"""


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_census_merges_across_two_subprocess_workers(tmp_path):
    for name, n, rows in (("w1", 3, 100), ("w2", 5, 40000)):
        script = _WORKER_CHILD % {"repo": ROOT, "dir": str(tmp_path), "name": name,
                                  "n": n, "rows": rows, "family": "shared-fam"}
        subprocess.run([sys.executable, "-c", script], check=True, timeout=60, env=_env())
    census = co.read_census_dir(str(tmp_path))
    fam = census.families["shared-fam"]
    assert fam["count"] == 8 and fam["minRows"] == 100 and fam["maxRows"] == 40000
    assert census.rows() == jax_co.read_census_dir(str(tmp_path)).rows()
    events = co.read_observatory_dir(str(tmp_path))
    assert len(events) == 8 and {e["queryId"] for e in events} == {"q-w1", "q-w2"}


_CRASH_CHILD = """
import os, sys, time
sys.path.insert(0, %(repo)r)
from trino_tpu_torch.obs.compile_observatory import CompileObservatory

obs = CompileObservatory(%(dir)r, name="crashed", family_cold_s=0.0)
for i in range(12):
    obs.record(kernel="k-%%d" %% i, family="fam-crash",
               shape_sig="s-%%d" %% i, query_id="q-crash",
               scan_rows=[256])
# no sync(), no close(), no atexit: MAP_SHARED dirty pages already
# belong to the page cache — signal readiness and hang for SIGKILL
print("READY", flush=True)
time.sleep(60)
"""


def test_kill9_torn_tail_readback(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-c", _CRASH_CHILD % {"repo": ROOT, "dir": str(tmp_path)}],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
    try:
        line = proc.stdout.readline()
        assert line.strip() == "READY", proc.stderr.read()
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.wait(timeout=30)
    with open(tmp_path / (co._FILE_PREFIX + "torn-0.jsonl"), "wb") as f:
        f.write(b'{"compileId": 99, "cause": "shape_mi')
    events = co.read_observatory_dir(str(tmp_path))
    assert {e["kernel"] for e in events} == {"k-%d" % i for i in range(12)}
    # the first is the family's first compile; the query that introduced
    # it presents its other shapes as first compiles too
    assert all(e["cause"] == co.FIRST_COMPILE for e in events)
    assert events == jax_co.read_observatory_dir(str(tmp_path))


# --- retrace storm -> journal -> doctor -----------------------------------


def test_retrace_storm_reaches_doctor_with_cited_events():
    obs = _cold(co, storm_window_s=60.0, storm_misses=3)
    obs.record(kernel="k0", family="fam", shape_sig="s0", query_id="q0")
    for i in range(1, 5):
        ev = obs.record(kernel="k%d" % i, family="fam", shape_sig="s%d" % i,
                        query_id="q_storm")
        assert ev["cause"] == co.SHAPE_MISS
    storms = [e for e in journal.get_journal().tail()
              if e["eventType"] == journal.RETRACE_STORM]
    assert len(storms) == 1, "storm emit must be throttled per window"
    assert storms[0]["detail"]["misses"] >= 3
    d = doctor.diagnose("q_storm", journal.get_journal().tail())
    assert d["verdict"] == doctor.ROOT_CAUSE and d["rootCause"] == "retrace_storm"
    assert storms[0]["eventId"] in d["eventIds"]
    want = jax_doctor.diagnose("q_storm", journal.get_journal().tail())
    assert {k: v for k, v in d.items() if k != "ts"} == {
        k: v for k, v in want.items() if k != "ts"}


def test_retrace_storm_ranks_below_memory_pressure():
    events = [
        {"eventId": 1, "eventType": journal.MEMORY_REVOKE, "queryId": "q1",
         "taskId": "", "nodeId": "", "severity": "warn",
         "detail": {"reason": "pool pressure"}, "ts": 1.0},
        {"eventId": 2, "eventType": journal.RETRACE_STORM, "queryId": "q1",
         "taskId": "", "nodeId": "", "severity": "warn",
         "detail": {"misses": 9, "windowS": 10.0}, "ts": 2.0},
    ]
    d = doctor.diagnose("q1", events)
    assert d["rootCause"] == "memory_pressure"
    codes = [f["code"] for f in d["findings"]]
    assert codes.index("memory_pressure") < codes.index("retrace_storm")


# --- the compile cache -----------------------------------------------------


def test_compile_cache_cross_session_reuse_zero_reencodes(monkeypatch):
    """A second session that re-runs a fragment finds its encoded
    program in the process's cache: one hit, no put, no encode."""
    encodes = []
    real = kn.compile_program
    monkeypatch.setattr(kn, "compile_program",
                        lambda *a: encodes.append(a) or real(*a))
    q = "select count(*) as c, sum(o_custkey) from orders where o_orderkey < 100"
    cache = cc_mod.shared_compile_cache()
    a = tpch_session(SF, device="cpu", megakernels="on", result_cache=False)
    pa = a.execute(q)
    assert a.last_kernel_profile.get("fusedAggregates") == 1
    n, h0, p0 = len(encodes), cache.hits, cache.puts
    assert n >= 1
    b = tpch_session(SF, device="cpu", megakernels="on", result_cache=False)
    assert b.caches.compile_cache is a.caches.compile_cache is cache
    pb = b.execute(q)
    assert pb.to_pylist() == pa.to_pylist()
    assert cache.hits == h0 + 1 and cache.puts == p0
    assert len(encodes) == n  # zero re-encodes in the second session
    row = b.execute("select hits, misses, puts, entries from system.runtime.caches "
                    "where name = 'compile_cache'").to_pylist()[0]
    assert row == (cache.hits, cache.misses, cache.puts, len(cache))


def _program(k):
    return kn.Program((), (), (((kn.LOAD, 0), (kn.CONST, k), (kn.ADD, 0)),))


def test_compile_cache_lru_bounded():
    cache = cc_mod.CompileCache(max_entries=2)
    for k in (1, 2, 3):
        cache.program(_program(k), 1, 1)
    assert len(cache) == 2 and cache.evictions == 1 and cache.puts == 3
    assert (_program(1), 1, 1) not in cache  # the oldest went
    cache.program(_program(3), 1, 1)
    assert cache.hits == 1
    cache.program(_program(1), 1, 1)
    assert cache.misses == 4 and cache.evictions == 2
    with pytest.raises(ValueError, match="groups"):
        cache.program(_program(4), 1, kn.MAX_GROUPS + 1)
    assert len(cache) == 2 and cache.puts == 4


def test_compile_cache_false_detaches_the_shared_tier():
    """compile_cache = false: each execution encodes into a cache of its
    own (every run records a first_compile); the shared cache sees
    nothing."""
    cache = cc_mod.shared_compile_cache()
    s = tpch_session(SF, device="cpu", megakernels="on", result_cache=False,
                     compile_cache=False)
    before = cache.stats()
    for _ in range(2):
        s.execute(Q6)
    assert cache.stats() == before
    assert [e["cause"] for e in co.get_observatory().tail()] == [co.FIRST_COMPILE] * 2


_PERSISTENT_CHILD = """
import json, sys
sys.path.insert(0, %(repo)r)
from trino_tpu_torch.obs import compile_observatory as co
from trino_tpu_torch.session import tpch_session

s = tpch_session(0.001, device="cpu", megakernels="on", result_cache=False,
                 compile_cache_dir=%(dir)r, compile_prewarm=%(prewarm)r)
before = [e["cause"] + "/" + e["mode"] for e in co.get_observatory().tail()]
rows = s.execute(%(sql)r).to_pylist()
after = [e["cause"] + "/" + e["mode"] for e in co.get_observatory().tail()]
print(json.dumps({"prewarm": s.last_prewarm, "boot": before, "run": after[len(before):],
                  "rows": [[str(v) for v in r] for r in rows]}))
"""


def test_persistent_index_read_by_a_second_process(tmp_path, monkeypatch):
    """The program index in compile_cache_dir: a second process with
    compile_prewarm encodes the indexed program when its session starts
    (a persistent_load) and its first query then encodes nothing; without
    prewarm, that query's encode is the persistent_load."""
    d = str(tmp_path / "cc")
    s = tpch_session(SF, device="cpu", megakernels="on", result_cache=False,
                     compile_cache_dir=d)
    want = [[str(v) for v in r] for r in s.execute(Q6).to_pylist()]
    assert kn.build_dir() == os.path.abspath(d)
    index = json.load(open(os.path.join(d, "index.json")))["programs"]
    (rec,) = index.values()
    assert rec["groups"] == 1 and rec["family"] == co.get_observatory().tail()[-1]["family"]
    tpch_session(SF, device="cpu")  # a session without the directory detaches it
    assert kn.build_dir() == kn.BUILD
    assert cc_mod.shared_compile_cache().persistent_dir is None

    def child(prewarm):
        out = subprocess.run(
            [sys.executable, "-c", _PERSISTENT_CHILD % {
                "repo": ROOT, "dir": d, "prewarm": prewarm, "sql": Q6}],
            capture_output=True, text=True, timeout=300, env=_env())
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    warm = child(True)
    assert warm["prewarm"]["entries"] == 1 and warm["prewarm"]["libraries"] == 0
    assert warm["boot"] == ["persistent_load/prewarm"]
    assert warm["run"] == [] and warm["rows"] == want
    cold = child(False)
    assert cold["prewarm"] is None and cold["boot"] == []
    assert cold["run"] == ["persistent_load/encode"] and cold["rows"] == want


# --- the nvcc choke point ----------------------------------------------------


def test_libraries_left_by_an_earlier_process_are_persistent_loads(tmp_path):
    """ops/kernels.build over a directory that already holds every
    library (newer than its source): one persistent_load event a library,
    once a process, and no nvcc (this machine has none: a missing library
    raises)."""
    d = tmp_path / "libs"
    d.mkdir()
    try:
        kn.set_build_dir(str(d))
        for name in kn.SOURCES:
            (d / f"lib{name}.so").write_bytes(b"")
        assert kn.build() == {}
        kn.build()
        events = co.get_observatory().tail()
        assert [(e["cause"], e["mode"]) for e in events] == [
            (co.PERSISTENT_LOAD, "nvcc")] * len(kn.SOURCES)
        assert {e["family"] for e in events} == {f"nvcc:{s}" for s in kn.SOURCES.values()}
        assert sorted(e["kernel"] for e in events) == sorted(
            f"lib{n}.so" for n in kn.SOURCES)
        os.remove(d / "libgrouped_sum.so")
        if kn.shutil.which("nvcc") is None and not os.path.exists(
                "/usr/local/cuda/bin/nvcc"):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                kn.build()
    finally:
        kn.set_build_dir(None)
    assert kn.build_dir() == kn.BUILD
