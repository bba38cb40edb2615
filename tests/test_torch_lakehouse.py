"""The port's lakehouse connector against the JAX package's.

The 7 tests of tests/test_lakehouse.py on the port (snapshots, time
travel, CAS conflicts between concurrent writers, a writer killed
mid-commit, the result cache keyed by snapshot, expire_snapshots and
remove_orphan_files), every scenario under the same seeded object-store
faults.  Snapshots are read over SQL (`system.runtime.snapshots`), and
the query doctor's verdict over a CAS conflict cites the conflict from
the journal alone, as the JAX doctor's does.

Besides: a table written by either package is read by the other with
identical pages, its `.npz` data files hold equal arrays (name, dtype,
value) and its metadata documents are equal apart from timestamps and
uuid tokens.
"""
import json
import os
import re
import sqlite3
import subprocess
import sys
import threading

import numpy as np
import pytest

import trino_tpu.session as jsession
from trino_tpu.obs import doctor as jax_doctor
from trino_tpu_torch import convert
from trino_tpu_torch.obs import doctor, journal
from trino_tpu_torch.session import Session
from trino_tpu_torch.utils.metrics import counter

# seeded chaos on every object-store call: low-probability bounded
# faults the bounded-backoff retry loop must absorb without surfacing
FAULTS = json.dumps({
    "seed": 7,
    "objstore_error": {"p": 0.03, "times": 3},
    "objstore_latency": {"p": 0.05, "times": 6, "stall_s": 0.002},
})
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_journal():
    """A clean process-global journal per scenario."""
    journal._reset_journal()
    yield
    journal._reset_journal()


def _lake(warehouse, faults: str = FAULTS, package=None) -> Session:
    s = (package.Session() if package is jsession
         else Session(device="cpu"))
    s.create_catalog("lake", "lakehouse", {
        "lake.warehouse-dir": str(warehouse),
        "lake.fault-injection": faults,
    })
    return s


def _snapshots(s, table):
    """(snapshot_id, parent_id, operation, data_files, rows, is_current,
    committed_at_us) of one table, from system.runtime.snapshots."""
    return s.execute(
        "select snapshot_id, parent_id, operation, data_files, rows, is_current, "
        f"committed_at_us from system.runtime.snapshots where catalog = 'lake' "
        f"and table_name = '{table}' order by snapshot_id").to_pylist()


def test_create_insert_delete_snapshot_history(tmp_path):
    s = _lake(tmp_path)
    s.execute("create table lake.default.t (k bigint, v double)")
    s.execute("insert into lake.default.t values (1, 1.5), (2, 2.5)")
    s.execute("insert into lake.default.t values (3, 3.5)")
    assert s.execute("select k, v from lake.default.t order by k").to_pylist() == [
        (1, 1.5), (2, 2.5), (3, 3.5)]
    # DELETE plans as a whole-table overwrite snapshot
    s.execute("delete from lake.default.t where k = 2")
    assert s.execute("select k from lake.default.t order by k").to_pylist() == [
        (1,), (3,)]
    snaps = _snapshots(s, "t")
    assert [r[2] for r in snaps] == ["create", "append", "append", "overwrite"]
    assert [r[1] for r in snaps] == [-1, 0, 1, 2]
    assert [r[5] for r in snaps] == [False, False, False, True]
    assert [r[4] for r in snaps] == [0, 2, 3, 2]


def test_time_travel_byte_identical_vs_oracle(tmp_path):
    """FOR VERSION/TIMESTAMP AS OF against a sqlite oracle replaying the
    batches committed up to each snapshot, unmoved by later writes."""
    batches = [[(1, 10.0), (2, 20.0)], [(3, 30.0)], [(4, 40.0), (5, 50.0)]]
    s = _lake(tmp_path)
    s.execute("create table lake.default.ledger (k bigint, amt double)")
    for b in batches:
        vals = ", ".join(f"({k}, {a})" for k, a in b)
        s.execute(f"insert into lake.default.ledger values {vals}")
    oracle = sqlite3.connect(":memory:")
    oracle.execute("create table ledger (k integer, amt real)")
    q = "select k, amt from lake.default.ledger{tt} order by k"
    pinned_before = [s.execute(q.format(tt=f" for version as of {v}")).to_pylist()
                     for v in range(1, len(batches) + 1)]
    for v, b in enumerate(batches, start=1):
        oracle.executemany("insert into ledger values (?, ?)", b)
        assert pinned_before[v - 1] == oracle.execute(
            "select k, amt from ledger order by k").fetchall()
    s.execute("insert into lake.default.ledger values (6, 60.0)")
    for v in range(1, len(batches) + 1):
        assert s.execute(q.format(tt=f" for version as of {v}")).to_pylist() == \
            pinned_before[v - 1]
    ts1 = next(r[6] for r in _snapshots(s, "ledger") if r[0] == 1)
    assert s.execute(q.format(tt=f" for timestamp as of {ts1}")).to_pylist() == \
        pinned_before[0]
    assert counter("trino_tpu_lake_time_travel_total").total() > 0
    with pytest.raises(Exception, match="99"):
        s.execute(q.format(tt=" for version as of 99"))


def test_concurrent_inserts_cas_conflict_doctor_citable(tmp_path):
    """Writer A loads table state, then stalls at the commit kill-point
    while writer B commits the same snapshot id: A's CAS loses, journals
    SNAPSHOT_CONFLICT, re-reads B's snapshot and retries — zero lost
    updates, and the doctor cites the conflict as the root cause from
    the journal alone, as the JAX doctor does over the same events."""
    s_a, s_b = _lake(tmp_path), _lake(tmp_path)
    s_a.execute("create table lake.default.events (w bigint, x bigint)")
    conn_a = s_a.catalogs.get("lake")
    at_kill_point = threading.Event()
    release = threading.Event()

    def stalling_maybe_crash(key):
        at_kill_point.set()
        assert release.wait(timeout=30), "conflict gate never released"

    conn_a.maybe_crash = stalling_maybe_crash
    before = counter("trino_tpu_lake_conflicts_total").total()
    t = threading.Thread(target=lambda: s_a.execute(
        "insert into lake.default.events values (1, 1), (1, 2)"), daemon=True)
    t.start()
    assert at_kill_point.wait(timeout=30)
    s_b.execute("insert into lake.default.events values (2, 1)")
    release.set()
    t.join(timeout=60)
    assert not t.is_alive()
    assert s_b.execute("select w, x from lake.default.events order by w, x"
                       ).to_pylist() == [(1, 1), (1, 2), (2, 1)]
    assert [r[:3] for r in _snapshots(s_b, "events")] == [
        (0, -1, "create"), (1, 0, "append"), (2, 1, "append")]
    assert counter("trino_tpu_lake_conflicts_total").total() >= before + 1
    conflicts = [e for e in journal.get_journal().tail()
                 if e.get("eventType") == journal.SNAPSHOT_CONFLICT]
    assert conflicts, "CAS loss was not journaled"
    assert conflicts[0]["detail"]["table"] == "events"
    assert conflicts[0]["detail"]["attempted"] == 1
    assert conflicts[0]["detail"]["winner"] == 1
    assert conflicts[0]["eventId"] > 0 and conflicts[0]["severity"] == journal.WARN
    events = journal.get_journal().tail()
    d = doctor.diagnose("q_conflict_probe", events)
    assert d["rootCause"] == "snapshot_conflict"
    assert d["eventIds"], "verdict must cite concrete journal events"
    assert "re-read winner and retried" in d["summary"]
    want = jax_doctor.diagnose("q_conflict_probe", events)
    assert {k: v for k, v in d.items() if k != "ts"} == {
        k: v for k, v in want.items() if k != "ts"}


def test_result_cache_misses_at_next_snapshot(tmp_path):
    s = _lake(tmp_path)
    s.execute("create table lake.default.rc (k bigint)")
    s.execute("insert into lake.default.rc values (1), (2)")
    conn = s.catalogs.get("lake")
    v_before = conn.data_version("rc")
    q = "select sum(k) as s from lake.default.rc"
    assert s.execute(q).to_pylist() == [(3,)]
    assert s.execute(q).to_pylist() == [(3,)]
    assert s.caches.result_cache.hits == 1  # warm at snapshot N
    s.execute("insert into lake.default.rc values (10)")
    assert conn.data_version("rc") == v_before + 1
    assert s.execute(q).to_pylist() == [(13,)]
    assert s.caches.result_cache.hits == 1


_CRASH_WRITER = """
import sys
sys.path.insert(0, {root!r})
from trino_tpu_torch.session import Session
s = Session(device="cpu")
s.create_catalog("lake", "lakehouse", {{
    "lake.warehouse-dir": {warehouse!r},
    "lake.fault-injection": '{{"seed": 1, "lake_commit_crash": {{"nth": 1}}}}',
}})
s.execute("insert into lake.default.wal values (100), (101)")
print("UNREACHABLE: crash fault did not fire")
sys.exit(3)
"""


def test_writer_killed_mid_commit_leaves_readable_history(tmp_path):
    """os._exit(137) at the commit kill-point, after the data file is
    written and before the metadata CAS: the table reads at the prior
    snapshot and the dead writer's file is an orphan."""
    s = _lake(tmp_path)
    s.execute("create table lake.default.wal (k bigint)")
    s.execute("insert into lake.default.wal values (1), (2)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TRINO_TPU_CRASH_FAULTS"] = "1"  # arms the lake_commit_crash site
    proc = subprocess.run(
        [sys.executable, "-c",
         _CRASH_WRITER.format(root=ROOT, warehouse=str(tmp_path))],
        env=env, capture_output=True, timeout=240,
    )
    assert proc.returncode == 137, (proc.returncode, proc.stdout, proc.stderr)
    s2 = _lake(tmp_path)
    assert s2.execute("select k from lake.default.wal order by k").to_pylist() == [
        (1,), (2,)]
    orphans = s2.catalogs.get("lake").orphaned_files("wal")
    assert len(orphans) == 1 and orphans[0].startswith("wal/data/")
    assert [(r[0], r[2], r[4]) for r in _snapshots(s2, "wal")] == [
        (0, "create", 0), (1, "append", 2)]


def test_expire_snapshots_prunes_history_and_reclaims_files(tmp_path):
    s = _lake(tmp_path)
    s.execute("create table lake.default.exp (k bigint)")
    s.execute("insert into lake.default.exp values (1), (2)")
    s.execute("delete from lake.default.exp where k = 1")
    conn = s.catalogs.get("lake")
    assert s.execute("select k from lake.default.exp for version as of 1 "
                     "order by k").to_pylist() == [(1,), (2,)]
    data_before = len(conn.fs.list_files("exp/data"))
    before = counter("trino_tpu_lake_expired_snapshots_total").value()
    res = conn.expire_snapshots("exp", keep=1)
    assert res["expiredSnapshots"] == 2
    assert res["removedFiles"] == 1
    assert res["currentSnapshotId"] == 2
    assert s.execute("select k from lake.default.exp order by k").to_pylist() == [(2,)]
    with pytest.raises(Exception, match="1"):
        s.execute("select k from lake.default.exp for version as of 1")
    assert [r[:3:2] for r in _snapshots(s, "exp")] == [(2, "overwrite")]
    assert len(conn.fs.list_files("exp/data")) == data_before - 1
    assert conn.orphaned_files("exp") == []
    again = conn.expire_snapshots("exp", keep=1)
    assert again["expiredSnapshots"] == 0 and again["removedFiles"] == 0
    with pytest.raises(ValueError, match="pinned"):
        conn.expire_snapshots("exp@2")
    assert counter("trino_tpu_lake_expired_snapshots_total").value() >= before + 2
    expired = [e for e in journal.get_journal().tail()
               if e.get("eventType") == journal.SNAPSHOT_EXPIRED]
    assert expired, "expiry was not journaled"
    assert expired[0]["detail"]["table"] == "exp"
    assert expired[0]["detail"]["expired"] == 2
    assert expired[0]["detail"]["removedFiles"] == 1


def test_remove_orphan_files_sweeps_crashed_writer_leftovers(tmp_path):
    s = _lake(tmp_path)
    s.execute("create table lake.default.orph (k bigint)")
    s.execute("insert into lake.default.orph values (1), (2)")
    conn = s.catalogs.get("lake")
    conn.fs.write_file("orph/data/deadwriter-000.bin", b"x" * 128)
    assert conn.orphaned_files("orph") == ["orph/data/deadwriter-000.bin"]
    before = counter("trino_tpu_lake_orphans_removed_total").value()
    res = conn.remove_orphan_files("orph", older_than_s=0.0)
    assert res["removedFiles"] == 1 and res["freedBytes"] == 128
    assert conn.orphaned_files("orph") == []
    assert s.execute("select k from lake.default.orph order by k").to_pylist() == [
        (1,), (2,)]
    swept = [e for e in journal.get_journal().tail()
             if e.get("eventType") == journal.ORPHANS_REMOVED]
    assert swept and swept[-1]["detail"] == {
        "table": "orph", "removedFiles": 1, "freedBytes": 128}
    assert counter("trino_tpu_lake_orphans_removed_total").value() >= before + 1
    conn.fs.write_file("orph/data/inflight-001.bin", b"y")
    assert conn.remove_orphan_files("orph", older_than_s=3600.0)["removedFiles"] == 0
    assert conn.orphaned_files("orph") == ["orph/data/inflight-001.bin"]


# -- across the packages ------------------------------------------------------

WRITES = (
    "create table lake.default.li as select l_orderkey, l_quantity, "
    "l_extendedprice, l_returnflag, l_shipdate, l_comment from tpch.tiny.lineitem "
    "where l_orderkey < 400",
    "insert into lake.default.li select l_orderkey, l_quantity, l_extendedprice, "
    "l_returnflag, l_shipdate, l_comment from tpch.tiny.lineitem "
    "where l_orderkey between 400 and 600",
    "delete from lake.default.li where l_orderkey between 100 and 199",
    "insert into lake.default.li (l_orderkey, l_returnflag, l_comment) values "
    "(9999, 'Z', 'late'), (10000, null, 'null flag')",
)
READS = (
    "select * from lake.default.li{tt} order by l_orderkey, l_comment, l_extendedprice",
    "select l_returnflag, count(*), sum(l_quantity), min(l_shipdate) "
    "from lake.default.li{tt} group by l_returnflag order by l_returnflag",
)
_TOKENS = re.compile(r"[0-9a-f]{32}|-[0-9a-f]{8}(?=\.json)")


def _writer(package, warehouse, writes=WRITES):
    s = _lake(warehouse, faults="", package=package)
    s.create_catalog("tpch", "tpch", {"tpch.scale-factor": 0.001})
    for sql in writes:
        s.execute(sql)
    return s


def _npz_arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _assert_files_equal(files):
    """Both packages' data files, snapshot by snapshot: equal arrays."""
    for snap, port_files in files["port"][0].items():
        jax_files = files["jax"][0][snap]
        assert len(port_files) == len(jax_files)
        for a, b in zip(port_files, jax_files):
            assert sorted(a) == sorted(b)
            for name in a:
                assert a[name].dtype == b[name].dtype, name
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _snapshot_files(warehouse):
    """Per snapshot, the arrays of its data files in manifest order, and
    the metadata documents with timestamps and uuid tokens blanked."""
    meta_dir = os.path.join(warehouse, "li", "metadata")
    ptr = open(os.path.join(meta_dir, "ptr")).read()
    meta = json.loads(open(os.path.join(meta_dir, ptr)).read())
    files = {}
    for snap in meta["snapshots"]:
        man = json.loads(open(os.path.join(meta_dir, snap["manifest"])).read())
        files[snap["snapshotId"]] = [
            _npz_arrays(os.path.join(warehouse, f["path"])) for f in man["files"]]
    for snap in meta["snapshots"]:
        snap["ts"] = 0
    return files, json.loads(_TOKENS.sub("", json.dumps(meta)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tables_cross_between_the_packages(tmp_path, writer):
    """One package writes (CTAS, INSERT ... SELECT, DELETE, INSERT of
    partial rows); the other reads every snapshot to identical pages;
    both packages, writing the same statements, leave equal arrays in
    their data files and equal metadata."""
    import trino_tpu_torch.session as tsession

    wh = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    sessions = {"port": _writer(tsession, wh["port"]),
                "jax": _writer(jsession, wh["jax"])}
    other = "jax" if writer == "port" else "port"
    reader = _lake(wh[writer], faults="",
                   package=jsession if other == "jax" else tsession)
    for snap in (1, 2, 3, 4, None):
        tt = "" if snap is None else f" for version as of {snap}"
        for sql in READS:
            convert.assert_pages_identical(
                sessions[writer].execute(sql.format(tt=tt)),
                reader.execute(sql.format(tt=tt)))
    files = {k: _snapshot_files(str(v)) for k, v in wh.items()}
    assert files["port"][1] == files["jax"][1]
    _assert_files_equal(files)


# an INSERT that names no varchar column: its data file's varchar
# dictionaries are empty, every row NULL
NULL_VARCHAR_WRITES = WRITES[:2] + (
    "insert into lake.default.li (l_orderkey, l_quantity) values "
    "(20000, 1), (20001, 2)",
)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_insert_leaving_varchars_out_crosses_the_packages(tmp_path, writer):
    """Either package writes a table whose last data file holds only
    NULL varchars; the port reads it to the same pages as its own table,
    with the NULLs where the INSERT left them, and both packages' data
    files hold equal arrays.  The JAX package's reader raises IndexError
    over such a file (ROADMAP C), so the port is the reader on both
    sides."""
    import trino_tpu_torch.session as tsession

    wh = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    sessions = {"port": _writer(tsession, wh["port"], NULL_VARCHAR_WRITES),
                "jax": _writer(jsession, wh["jax"], NULL_VARCHAR_WRITES)}
    reader = _lake(wh[writer], faults="", package=tsession)
    for snap in (1, 2, 3, None):
        tt = "" if snap is None else f" for version as of {snap}"
        for sql in READS:
            convert.assert_pages_identical(
                sessions["port"].execute(sql.format(tt=tt)),
                reader.execute(sql.format(tt=tt)))
    tail = ("select l_orderkey, l_quantity, l_returnflag, l_comment, l_shipdate "
            "from lake.default.li where l_orderkey >= 20000 order by l_orderkey")
    assert [tuple(r) for r in reader.execute(tail).to_pylist()] == [
        (20000, 1.0, None, None, None), (20001, 2.0, None, None, None)]
    counts = {r[0]: r[1] for r in reader.execute(READS[1].format(tt="")).to_pylist()}
    assert counts[None] == 2
    with pytest.raises(IndexError):
        _lake(wh[writer], faults="", package=jsession).execute(
            READS[0].format(tt=""))
    files = {k: _snapshot_files(str(v)) for k, v in wh.items()}
    assert files["port"][1] == files["jax"][1]
    _assert_files_equal(files)
