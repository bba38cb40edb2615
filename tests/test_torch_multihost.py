"""The port's cross-host mesh against the JAX package's.

Every case of tests/test_multihost.py runs through the port's runner
(test_torch_server.replay_module with jax=False): two worker_main
processes on the CPU, each a host with 2 logical shards, under
``cross_host_mesh``; the announced topology, Q1/Q3/Q6 and the grouped
count(DISTINCT) against the port's single host and the sqlite oracle,
the exchange crossing hosts with mesh-mode compiles on each host, and a
host killed with -9 mid-Q3 under retry_policy = task.  The JAX side
stays in this process: the cluster's rows are held here to the JAX
package's single-host DistributedQueryRunner (tests/test_multihost.py
holds the JAX cluster to its own single host).

Beside them: the checks of scripts/multihost_smoke.py; slice_eligible
on the fragments of Q1, Q3, Q6 and the grouped count(DISTINCT) against
the JAX function on the same plans; a slice fragment's PARTIAL output
staying partial (n shards' accumulator rows a group, an empty shard and
an empty task included) and the consumer's FINAL giving the one-device
page; the worker's choice of executor under each condition, and a slice
that fails failing its task with nothing re-run; the autoscaler
admitting host-sized workers; ``bootstrap`` with and without a
coordinator address.
"""
import re
import urllib.request

import pytest

from test_torch_server import _same_rows, replay_module
from tpch_sql import QUERIES

replay_module("test_multihost.py", jax=False)

SF = 0.001
TPCH = (("tpch", "tpch", {"tpch.scale-factor": SF}),)
QD = ("select o_orderpriority, count(distinct o_custkey) from orders "
      "group by o_orderpriority order by o_orderpriority")
STATEMENTS = {"Q1": QUERIES[1][0], "Q3": QUERIES[3][0], "Q6": QUERIES[6][0], "QD": QD}
# scripts/multihost_smoke.py's query: the partial -> final repartition
# of a grouped aggregate over lineitem must cross hosts
SMOKE_SQL = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
             "group by l_returnflag order by l_returnflag")


@pytest.fixture(scope="module")
def jax_single_host():
    from trino_tpu.testing import DistributedQueryRunner

    runner = DistributedQueryRunner(workers=1, catalogs=TPCH)
    try:
        yield runner
    finally:
        runner.stop()


@pytest.mark.parametrize("label", list(STATEMENTS))
def test_cluster_rows_equal_the_jax_single_host(port_test_multihost_mh,
                                                jax_single_host, label):
    sql = STATEMENTS[label]
    got = port_test_multihost_mh.rows(sql)
    want = jax_single_host.rows(sql)
    assert got and _same_rows(want, got), (label, got, want)


def _metrics(uri):
    with urllib.request.urlopen(f"{uri}/metrics", timeout=5.0) as r:
        return r.read().decode()


def _value(text, pattern):
    m = re.search(pattern, text, re.M)
    return float(m.group(1)) if m else 0.0


def test_multihost_smoke_checks(port_test_multihost_mh, port_test_multihost_sh):
    """scripts/multihost_smoke.py through the port: the answer equals the
    single host's, every host ran a mesh-mode fragment, fetches crossed
    hosts with bytes, two host processes, zero failed queries."""
    mh = port_test_multihost_mh
    assert mh.rows(SMOKE_SQL) == port_test_multihost_sh.rows(SMOKE_SQL)
    texts = [_metrics(uri) for _, _, uri in mh.subprocess_workers]
    for text in texts:
        assert _value(text, r'^trino_tpu_compile_events_total\{[^}]*mode="mesh"[^}]*\} (\S+)') > 0
    assert sum(_value(t, r"^trino_tpu_exchange_cross_host_fetch_total (\S+)")
               for t in texts) > 0
    assert sum(_value(t, r"^trino_tpu_exchange_cross_host_fetch_bytes (\S+)")
               for t in texts) > 0
    co = mh.coordinator.coordinator
    assert [q.query_id for q in co.queries.values() if q.state == "FAILED"] == []
    assert co.cluster_topology.process_count() == 2


# -- the slice executor ------------------------------------------------------


def _fragments(pkg, sql):
    """Each package's fragments of `sql` at SF, planned by its session."""
    import importlib

    session = importlib.import_module(f"{pkg}.session")
    parse = importlib.import_module(f"{pkg}.sql.parser").parse
    fragment = importlib.import_module(f"{pkg}.plan.fragment")
    kw = {"device": "cpu"} if pkg == "trino_tpu_torch" else {}
    s = session.tpch_session(SF, **kw)
    return s, fragment.Fragmenter().fragment(s._plan_stmt(parse(sql)))


@pytest.mark.parametrize("label", list(STATEMENTS))
def test_slice_eligible_matches_jax(label):
    from trino_tpu.parallel.mesh_executor import slice_eligible as jax_eligible
    from trino_tpu_torch.parallel import slice_eligible

    _s, pf = _fragments("trino_tpu_torch", STATEMENTS[label])
    _j, jf = _fragments("trino_tpu", STATEMENTS[label])
    port = [(f.id, f.partitioning, slice_eligible(f.root)) for f in pf]
    jax = [(f.id, f.partitioning, jax_eligible(f.root)) for f in jf]
    assert port == jax
    # the source fragments are slices; the root (the final merge) is not
    assert any(e for _i, _p, e in port) and not port[0][2]


def _q1_source_and_final(s, frags):
    """Q1's PARTIAL source fragment and the fragment that merges it."""
    from trino_tpu_torch.parallel import slice_eligible

    (src,) = [f for f in frags if slice_eligible(f.root)]
    (fin,) = [f for f in frags if src.id in f.source_fragments]
    return src, fin


def test_slice_partial_aggregate_stays_partial():
    """Q1's source fragment as three tasks over 2 CPU shards: a task with
    two splits emits 2 x 4 accumulator rows (each shard's own partial
    groups, not merged), a task with one split 4 (its second shard
    empty), a task with none 0.  The consumer's FINAL over the three
    pages, then the root, give the one-device page."""
    from trino_tpu_torch import convert
    from trino_tpu_torch.exec.fragment_exec import FragmentExecutor
    from trino_tpu_torch.parallel import CrossHostFragmentExecutor, default_mesh

    s, frags = _fragments("trino_tpu_torch", QUERIES[1][0])
    src, fin = _q1_source_and_final(s, frags)
    (scan,) = src.scan_tables.values()
    splits = s.catalogs.get(scan[0]).split_manager().get_splits(scan[1], 3, scan[2])
    assert len(splits) == 3
    mesh = default_mesh(2, "cpu")
    pages = []
    for mine, rows in ((splits[:2], 8), (splits[2:], 4), ([], 0)):
        ex = CrossHostFragmentExecutor(s.catalogs, {"device": "cpu"}, {0: mine}, {},
                                       mesh=mesh)
        page = ex.execute(src.root)
        assert page.count == rows and ex.kernel_profile["mesh"]["shards"] == 2
        pages.append(page)
    merged = FragmentExecutor(s.catalogs, {"device": "cpu"}, {}, {src.id: pages}
                              ).execute(fin.root)
    root = frags[0]
    if fin is not root:
        merged = FragmentExecutor(s.catalogs, {"device": "cpu"}, {}, {fin.id: [merged]}
                                  ).execute(root.root)
    s.properties.set("result_cache", False)
    convert.assert_pages_identical(s.execute(QUERIES[1][0]), merged)


def test_slice_reads_a_broadcast_remote_source():
    """Q3's probe fragment with its build side fetched: the remote rows
    are one replicated batch that every shard's join reads, and the
    slice's rows equal FragmentExecutor's on the same inputs."""
    from trino_tpu_torch.exec.fragment_exec import FragmentExecutor
    from trino_tpu_torch.parallel import CrossHostFragmentExecutor, default_mesh, slice_eligible

    s, frags = _fragments("trino_tpu_torch", QUERIES[3][0])
    by_id = {f.id: f for f in frags}
    pages = {}

    def run(f):
        if f.id in pages:
            return pages[f.id]
        remote = {i: [run(by_id[i])] for i in f.source_fragments}
        splits = {i: s.catalogs.get(c).split_manager().get_splits(t, 1, k)
                  for i, (c, t, k) in f.scan_tables.items()}
        pages[f.id] = FragmentExecutor(s.catalogs, {"device": "cpu"}, splits, remote
                                       ).execute(f.root)
        return pages[f.id]

    joins = [f for f in frags if slice_eligible(f.root) and f.source_fragments]
    assert joins
    for f in joins:
        remote = {i: [run(by_id[i])] for i in f.source_fragments}
        (c, t, k), = f.scan_tables.values()
        splits = {0: s.catalogs.get(c).split_manager().get_splits(t, 2, k)}
        ex = CrossHostFragmentExecutor(s.catalogs, {"device": "cpu"}, splits, remote,
                                       mesh=default_mesh(2, "cpu"))
        got = ex.execute(f.root)
        want = FragmentExecutor(s.catalogs, {"device": "cpu"}, splits, remote
                                ).execute(f.root)
        assert ex.exchange_bytes > 0 and got.count == want.count
        assert sorted(map(repr, got.to_pylist())) == sorted(map(repr, want.to_pylist()))


@pytest.mark.parametrize("want, local_devices, eligible, expected", [
    (True, 2, True, "CrossHostFragmentExecutor"),
    ("true", 2, True, "CrossHostFragmentExecutor"),
    (True, 2, False, "FragmentExecutor"),
    (True, 1, True, "FragmentExecutor"),
    (False, 2, True, "FragmentExecutor"),
    ("off", 2, True, "FragmentExecutor"),
    (None, 2, True, "FragmentExecutor"),
])
def test_make_executor_choice(want, local_devices, eligible, expected):
    from trino_tpu_torch.server.worker import TaskManager

    s, frags = _fragments("trino_tpu_torch", QUERIES[1][0])
    src, fin = _q1_source_and_final(s, frags)
    tm = TaskManager(s.catalogs, device="cpu", local_devices=local_devices)
    config = {} if want is None else {"cross_host_mesh": want}
    ex = tm._make_executor(src.root if eligible else fin.root, config, {}, {}, None)
    assert type(ex).__name__ == expected
    if expected == "CrossHostFragmentExecutor":
        assert len(ex.mesh) == local_devices and ex.device.type == "cpu"


@pytest.fixture
def host_cluster():
    """A coordinator and one in-process worker with 2 local shards, the
    cross-host mesh on."""
    from trino_tpu_torch.server.worker import WorkerServer
    from trino_tpu_torch.testing import DistributedQueryRunner
    from trino_tpu_torch.testing.runner import _build_catalogs

    runner = DistributedQueryRunner(workers=0, catalogs=TPCH, device="cpu",
                                    properties={"cross_host_mesh": True,
                                                "result_cache": False})
    w = WorkerServer(_build_catalogs(TPCH), runner.coordinator.uri, device="cpu",
                     local_devices=2).start()
    runner.workers.append(w)
    runner._wait_for_workers(1, 10.0)
    try:
        yield runner
    finally:
        runner.stop()


def _spy(monkeypatch, runs):
    from trino_tpu_torch.exec.fragment_exec import FragmentExecutor
    from trino_tpu_torch.parallel import CrossHostFragmentExecutor, slice_eligible

    for cls in (FragmentExecutor, CrossHostFragmentExecutor):
        def execute(self, plan, _orig=cls.execute):
            runs.append((type(self).__name__, slice_eligible(plan)))
            return _orig(self, plan)
        monkeypatch.setattr(cls, "execute", execute)


def test_worker_runs_eligible_fragments_as_slices(host_cluster, monkeypatch):
    """A mixed plan is one query: Q1's source fragment runs over the
    worker's 2 shards, its final merge on one device, and the rows equal
    the single host's."""
    from trino_tpu_torch.testing import DistributedQueryRunner

    runs = []
    _spy(monkeypatch, runs)
    got = host_cluster.rows(QUERIES[1][0])
    assert ("CrossHostFragmentExecutor", True) in runs
    assert ("FragmentExecutor", False) in runs
    assert ("FragmentExecutor", True) not in runs
    with DistributedQueryRunner(workers=1, catalogs=TPCH, device="cpu") as sh:
        assert got == sh.rows(QUERIES[1][0])


def test_failing_slice_fails_its_task_with_no_rerun(host_cluster, monkeypatch):
    """A slice that raises fails the task and the query; no eligible
    fragment is re-run through FragmentExecutor."""
    from trino_tpu_torch.client.client import ClientError
    from trino_tpu_torch.parallel import CrossHostFragmentExecutor

    runs = []
    _spy(monkeypatch, runs)

    def broken(self, *a, **k):
        raise RuntimeError("injected slice failure")

    monkeypatch.setattr(CrossHostFragmentExecutor, "_run_plan", broken)
    with pytest.raises(ClientError, match="injected slice failure"):
        host_cluster.rows(QUERIES[6][0])
    assert runs and all(r == ("CrossHostFragmentExecutor", True) for r in runs)


def test_autoscaler_admits_host_sized_workers():
    """enable_autoscaler(local_devices=2): the scale-out hook admits a
    worker process with 2 local shards and a process index of its own."""
    from trino_tpu_torch.testing import DistributedQueryRunner

    with DistributedQueryRunner(workers=1, catalogs=TPCH, device="cpu") as r:
        scaler = r.enable_autoscaler(local_devices=2, min_workers=1, max_workers=2,
                                     cooldown_s=3600.0)
        _proc, node_id, _uri = scaler.scale_out_cb()
        hs = r.coordinator.coordinator.cluster_topology.slice_for(node_id)
        assert hs is not None and hs.local_devices == 2
        assert (hs.host, hs.process_index) == ("host0", 0)


def test_bootstrap_with_and_without_an_address(monkeypatch):
    """No coordinator address: the local topology document, with the JAX
    package's fields.  An address (passed or in the environment) asks for
    one device list across hosts, which the port does not build: it
    raises instead of ignoring it (ROADMAP C.4)."""
    from trino_tpu.distributed import bootstrap as jax_bootstrap
    from trino_tpu_torch.distributed import TOPOLOGY_FIELDS, bootstrap

    monkeypatch.delenv("TRINO_TPU_DIST_COORDINATOR", raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    doc, jdoc = bootstrap(), jax_bootstrap()
    assert set(doc) == set(jdoc) == set(TOPOLOGY_FIELDS)
    assert (doc["processIndex"], doc["processCount"]) == (0, 1)
    with pytest.raises(RuntimeError, match="localhost:1234"):
        bootstrap("localhost:1234")
    monkeypatch.setenv("TRINO_TPU_DIST_COORDINATOR", "localhost:4321")
    with pytest.raises(RuntimeError, match="localhost:4321"):
        bootstrap()

