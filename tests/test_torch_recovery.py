"""The port's coordinator recovery against the JAX package's.

Every case of tests/test_recovery.py replayed through both packages
(test_torch_server.replay_module: the same case, the port's imports
rebound to trino_tpu_torch on the CPU, the clients' records compared),
the two kill -9 acceptance cases keeping their ``slow`` marks: the WAL
store (round trip, torn tail, segment flip, truncation), the replay
classification, the structured retryable error, the doctor's
coordinator-restart verdict, the 503 + Retry-After recovery window, and
a subprocess coordinator killed with -9 mid-Q3 (resumed byte-identical
from its committed spools) or mid pipelined query (orphaned, re-submitted).

Beside them, a WAL directory written by the JAX coordinator over a
distributed FTE query replays in the port to the same classification,
and the port's plan digest of the same SQL is the one the JAX
coordinator logged; and the reverse.
"""
import pytest

from test_torch_server import replay_module
from tpch_sql import QUERIES

replay_module("test_recovery.py")

SF = 0.001
TPCH = (("tpch", "tpch", {"tpch.scale-factor": SF}),)
Q3 = QUERIES[3][0]


def _wal_of(pkg, wal_dir):
    """Run Q3 under retry_policy = task on a two-worker cluster of
    ``pkg`` with a recovery directory; return the WAL's records."""
    import importlib

    runner_mod = importlib.import_module(f"{pkg}.testing.runner")
    recovery = importlib.import_module(f"{pkg}.server.recovery")
    kw = {"device": "cpu"} if pkg == "trino_tpu_torch" else {}
    props = {"retry_policy": "task", "coordinator_recovery_dir": str(wal_dir),
             "result_cache": False}
    with runner_mod.DistributedQueryRunner(workers=2, catalogs=TPCH,
                                           properties=props, **kw) as r:
        rows = r.rows(Q3)
        r.rows("select count(*) from nation")
        r.coordinator.coordinator.wal.close()
    return rows, recovery.read_wal_dir(str(wal_dir))


def _classified(recovery, records):
    return {
        qid: (w.resumable, w.terminal, w.retry_policy, w.plan_digest,
              {k: len(v) for k, v in w.committed_lists().items()})
        for qid, w in recovery.replay_wal(records).items()
    }


@pytest.mark.parametrize("writer", ["trino_tpu", "trino_tpu_torch"])
def test_wal_directories_cross_between_the_packages(tmp_path, writer):
    import trino_tpu.server.recovery as jrec
    import trino_tpu.session as jsession
    import trino_tpu_torch.server.recovery as trec
    from trino_tpu.sql.parser import parse as jparse
    from trino_tpu_torch.session import tpch_session
    from trino_tpu_torch.sql.parser import parse as tparse

    rows, records = _wal_of(writer, tmp_path / "wal")
    assert rows
    types = {r["recordType"] for r in records}
    assert {jrec.QUERY_SUBMITTED, jrec.QUERY_PLANNED, jrec.TASK_DISPATCHED,
            jrec.TASK_COMMITTED, jrec.QUERY_FINISHED} <= types
    # each package reads the directory to the same records and verdicts
    assert jrec.read_wal_dir(str(tmp_path / "wal")) == \
        trec.read_wal_dir(str(tmp_path / "wal"))
    assert _classified(jrec, records) == _classified(trec, records)
    # the logged plan digest is each package's digest of Q3's plan
    planned = [r["planDigest"] for r in records
               if r["recordType"] == jrec.QUERY_PLANNED]
    js = jsession.tpch_session(SF)
    ts = tpch_session(SF, device="cpu")
    want = jrec.plan_digest(js._plan_stmt(jparse(Q3)))
    assert trec.plan_digest(ts._plan_stmt(tparse(Q3))) == want
    assert want in planned
