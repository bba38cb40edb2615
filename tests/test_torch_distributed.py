"""The port's pipelined distributed execution against the JAX package's.

Replayed through both packages' servers (test_torch_server.replay_module:
the same case, the port's imports rebound to trino_tpu_torch on the CPU,
the clients' rows compared): every case of tests/test_distributed.py
(the 11 TPC-H queries against the sqlite oracle included), the
pipelined node-lifecycle cases of tests/test_lifecycle.py, the absorbed
transient exchange fault of tests/test_faults.py, the health-aware
placement of tests/test_supervisor.py and the doctor's server cases of
tests/test_doctor.py.

Beside them: a port worker's device loss (the query fails with
DeviceFaultError, the node announces QUARANTINED, then ACTIVE after the
canary), the plan JSON of every fragment of the 11 queries (the JAX
package's text, byte for byte), and a JAX-written fragment with its
JAX-written frames run by the port's FragmentExecutor to the JAX
FragmentExecutor's page.
"""
import json
import time
import urllib.request

import numpy as np
import pytest

from test_torch_server import replay_module
from tpch_sql import QUERIES

SF = 0.001
DISTRIBUTED_QUERIES = [1, 3, 4, 5, 6, 10, 12, 14, 16, 17, 19]

replay_module("test_distributed.py")
replay_module("test_lifecycle.py", select=[92, 121, 147, 166, 198, 221, 248, 267])
replay_module("test_faults.py", select=[163])
replay_module("test_supervisor.py", select=[372, 386, 408])
replay_module("test_doctor.py", select=[327, 348, 383])

TPCH = (("tpch", "tpch", {"tpch.scale-factor": SF}),)


def _get(uri):
    with urllib.request.urlopen(uri, timeout=5.0) as r:
        return json.loads(r.read())


def test_port_worker_device_loss_fails_query_and_quarantines():
    """A device loss on a port worker fails its task with DeviceFaultError,
    which reaches the client through the protocol's error field; nothing
    re-runs on the CPU.  The worker announces QUARANTINED (the scheduler
    then places nothing on it) until the condition clears and the canary
    restores ACTIVE; the next query is answered."""
    from trino_tpu_torch.client.client import ClientError
    from trino_tpu_torch.obs import journal
    from trino_tpu_torch.session import tpch_session
    from trino_tpu_torch.testing import DistributedQueryRunner

    q6 = QUERIES[6][0]
    spec = json.dumps({"device_loss": {"nth": 1}})
    journal._reset_journal()
    with DistributedQueryRunner(
        workers=2, catalogs=TPCH, device="cpu",
        properties={"fault_injection": spec, "device_probe_backoff_s": 30.0},
    ) as runner:
        with pytest.raises(ClientError, match="DeviceFaultError"):
            runner.execute(q6)
        faulted = [w for w in runner.workers
                   if w.supervisor.snapshot()["devices"][0]["faults"] >= 1]
        assert faulted, "device_loss never fired: the test exercised nothing"
        for w in faulted:
            doc = _get(f"{w.uri}/v1/info")
            assert doc["state"] == "QUARANTINED"
            assert doc["device"]["devices"][0]["lastFaultKind"] == "device_loss"
            assert "fallbacksCompleted" not in doc["device"]
        kinds = [e["eventType"] for e in journal.get_journal().tail()]
        assert journal.DEVICE_QUARANTINE in kinds
        assert journal.CPU_FALLBACK not in kinds
        nm = runner.coordinator.coordinator.node_manager
        deadline = time.time() + 10.0
        while time.time() < deadline and not all(
            (nm.device_states().get(w.node_id) or {}).get("state") == "QUARANTINED"
            for w in faulted
        ):
            time.sleep(0.05)
        # the condition clears: the announce loop's canary restores ACTIVE
        for w in faulted:
            w.supervisor.fault_injector = None
            with w.supervisor._lock:
                for d in w.supervisor._devices.values():
                    d.next_probe = 0.0
        deadline = time.time() + 10.0
        while time.time() < deadline and not all(
            _get(f"{w.uri}/v1/info")["state"] == "ACTIVE" for w in faulted
        ):
            time.sleep(0.05)
        assert all(_get(f"{w.uri}/v1/info")["state"] == "ACTIVE" for w in faulted)
        deadline = time.time() + 10.0
        while time.time() < deadline and any(
            (nm.device_states().get(w.node_id) or {}).get("state") != "ACTIVE"
            for w in faulted
        ):
            time.sleep(0.05)
        # the spec's one loss is spent: the query runs on both workers
        rows = runner.rows(q6)
    local = tpch_session(SF, device="cpu").execute(q6)
    assert rows == [tuple(r) for r in local.to_pylist()] or \
        [str(v) for v in rows[0]] == [str(v) for v in local.to_pylist()[0]]


@pytest.fixture(scope="module")
def sessions():
    import trino_tpu.session as jsession
    from trino_tpu_torch.session import tpch_session

    js = jsession.tpch_session(SF)
    ts = tpch_session(SF, device="cpu")
    return js, ts


@pytest.mark.parametrize("qnum", DISTRIBUTED_QUERIES)
def test_fragment_plan_json_is_the_jax_text(sessions, qnum):
    """The coordinator ships each fragment as plan JSON; the port's text
    for every fragment of the query is the JAX package's, byte for byte
    (the registry keys do not name the package)."""
    from trino_tpu.plan.fragment import fragment_plan as jfrag
    from trino_tpu.serde import plan_to_json as jjson
    from trino_tpu_torch.plan.fragment import fragment_plan as tfrag
    from trino_tpu_torch.serde import plan_from_json, plan_to_json as tjson

    js, ts = sessions
    sql = QUERIES[qnum][0]
    jf, tf = jfrag(js.plan(sql)), tfrag(ts.plan(sql))
    assert [f.id for f in jf] == [f.id for f in tf]
    for a, b in zip(jf, tf):
        text = tjson(b.root)
        assert text == jjson(a.root)
        assert tjson(plan_from_json(text)) == text


def test_jax_written_fragments_and_frames_run_on_the_port(sessions):
    """Q1's and Q3's fragments as the JAX coordinator ships them (plan
    JSON), each over its sources' frames as JAX workers serialize them
    (two tasks a source fragment, one consumer; the splits decoded from
    the task document's JSON): the port's
    FragmentExecutor gives the JAX FragmentExecutor's page at every
    fragment, the root's included."""
    from trino_tpu.exec.fragment_exec import FragmentExecutor as JExec
    from trino_tpu.plan.fragment import SOURCE
    from trino_tpu.plan.fragment import fragment_plan as jfrag
    from trino_tpu.serde import deserialize_page as jdeser
    from trino_tpu.serde import encode_value as jencode
    from trino_tpu.serde import plan_to_json as jjson
    from trino_tpu.serde import serialize_page as jser
    from trino_tpu.server.scheduler import assign_splits as jassign
    from trino_tpu_torch import convert
    from trino_tpu_torch.exec.fragment_exec import FragmentExecutor as TExec
    from trino_tpu_torch.serde import decode_value as tdecode
    from trino_tpu_torch.serde import deserialize_page as tdeser
    from trino_tpu_torch.serde import plan_from_json

    js, ts = sessions
    for qnum in (1, 3):
        frags = jfrag(js.plan(QUERIES[qnum][0]))
        order = sorted((f for f in frags if f.id != 0), key=lambda f: f.id)
        order.append(next(f for f in frags if f.id == 0))
        frames = {}
        for f in order:
            ntasks = 2 if f.partitioning == SOURCE else 1
            tplan = plan_from_json(jjson(f.root))
            out = []
            for splits in jassign(js.catalogs, f, ntasks):
                jin = {s: [jdeser(b) for b in frames[s]] for s in f.source_fragments}
                tin = {s: [tdeser(b) for b in frames[s]] for s in f.source_fragments}
                # the splits as the task document carries them
                tsplits = {k: [tdecode(json.loads(json.dumps(jencode(sp))))
                               for sp in v] for k, v in splits.items()}
                jpage = JExec(js.catalogs, {}, splits, jin).execute(f.root)
                tpage = TExec(ts.catalogs, {"device": "cpu"}, tsplits, tin).execute(tplan)
                convert.assert_pages_identical(jpage, tpage)
                out.append(jser(jpage))
            frames[f.id] = out
        assert tdeser(frames[0][0]).count > 0


def test_tensor_pages_serialize_to_the_jax_frames(sessions):
    """A page whose lanes are tensors (a worker's output on its device; on
    the CPU here) serializes to the frame the JAX package writes for the
    same rows, the wide decimal and validity lanes included, and the
    first `count` rows only."""
    import torch

    from trino_tpu.serde import serialize_page as jser
    from trino_tpu_torch.page import Column, Page
    from trino_tpu_torch.serde import deserialize_page, serialize_page

    js, ts = sessions
    sql = ("select o_orderkey, o_totalprice, o_orderstatus, o_orderdate, "
           "sum(o_totalprice * o_totalprice) over (partition by o_orderstatus) as w "
           "from orders order by o_orderkey limit 300")
    host = ts.execute(sql)
    jax_frame = jser(js.execute(sql))
    assert serialize_page(host) == jax_frame
    rng = np.random.default_rng(7)
    cols = []
    for c in host.columns:
        ok = rng.random(host.count + 5) < 0.8
        vals = np.concatenate([np.asarray(c.values), np.asarray(c.values)[:5]])
        cols.append(Column(c.type, torch.from_numpy(vals), torch.from_numpy(ok),
                           c.dictionary))
    tensor_page = Page(cols, host.count, host.names)
    numpy_page = Page([Column(c.type, c.values.numpy(), c.validity.numpy(),
                              c.dictionary) for c in cols], host.count, host.names)
    frame = serialize_page(tensor_page)
    assert frame == serialize_page(numpy_page)
    back = deserialize_page(frame)
    assert back.count == host.count
    assert np.array_equal(back.columns[0].values, np.asarray(host.columns[0].values))


@pytest.mark.parametrize("table, columns", [
    ("lineitem", "*"),
    ("orders", "o_orderkey, o_custkey, o_totalprice, o_orderdate, o_orderpriority"),
])
def test_round_robin_splits_generate_on_the_device_as_on_the_host(table, columns):
    """A worker's round-robin share of a table's splits (not contiguous)
    is generated on the device one contiguous run at a time, in split
    order: the scan's lanes equal the host generator's for those splits."""
    from trino_tpu_torch import convert
    from trino_tpu_torch.exec.fragment_exec import FragmentExecutor
    from trino_tpu_torch.session import tpch_session

    s = tpch_session(0.01, device="cpu")
    plan = s.plan(f"select {columns} from {table}")
    conn = s.catalogs.get("tpch")
    splits = conn.split_manager().get_splits(table, 8, None)
    share = {0: [sp for i, sp in enumerate(splits) if i % 3 != 1]}
    assert [sp.ordinal for sp in share[0]] != list(range(len(share[0])))
    pages = []
    for gen in (True, False):
        ex = FragmentExecutor(s.catalogs, {"device": "cpu", "device_generation": gen},
                              share, {})
        pages.append(ex.execute(plan))
        assert ex.kernel_profile.get("deviceGeneratedScans", 0) == int(gen)
    convert.assert_pages_identical(pages[0], pages[1])


@pytest.mark.parametrize("qnum", [1, 3, 6])
def test_fragment_fusion_decisions_match_jax(sessions, qnum):
    """With megakernels on, each fragment of the query fuses (or refuses
    fusion) in the port's FragmentExecutor as in the JAX package's: the
    partial fragments over a scan fuse, a FINAL step over remote pages
    does not (the fused kernel reads scan lanes only)."""
    from trino_tpu.exec.fragment_exec import FragmentExecutor as JExec
    from trino_tpu.plan.fragment import SOURCE
    from trino_tpu.plan.fragment import fragment_plan as jfrag
    from trino_tpu.serde import deserialize_page as jdeser
    from trino_tpu.serde import plan_to_json as jjson
    from trino_tpu.serde import serialize_page as jser
    from trino_tpu.server.scheduler import assign_splits as jassign
    from trino_tpu_torch.exec.fragment_exec import FragmentExecutor as TExec
    from trino_tpu_torch.serde import deserialize_page as tdeser
    from trino_tpu_torch.serde import plan_from_json

    js, ts = sessions
    frags = jfrag(js.plan(QUERIES[qnum][0]))
    order = sorted((f for f in frags if f.id != 0), key=lambda f: f.id)
    order.append(next(f for f in frags if f.id == 0))
    frames, decisions = {}, []
    for f in order:
        splits = jassign(js.catalogs, f, 2 if f.partitioning == SOURCE else 1)[0]
        jin = {s: [jdeser(b) for b in frames[s]] for s in f.source_fragments}
        tin = {s: [tdeser(b) for b in frames[s]] for s in f.source_fragments}
        jx = JExec(js.catalogs, {"megakernels": "on"}, splits, jin)
        tx = TExec(ts.catalogs, {"device": "cpu", "megakernels": "on"}, splits, tin)
        frames[f.id] = [jser(jx.execute(f.root))]
        tx.execute(plan_from_json(jjson(f.root)))
        got = [(x.kernel_profile.get("fusedAggregates", 0),
                x.kernel_profile.get("fusionRejects", 0)) for x in (jx, tx)]
        assert got[0] == got[1], (f.id, got)
        decisions.append(got[1])
    if qnum == 6:
        assert decisions[0] == (1, 0)  # the partial fragment over lineitem
