"""The port's system catalog and access control against the JAX package's.

Every table of connectors/system.py read through both packages' sessions
after the same statements (the port on the CPU, result caches off, each
session with a history directory of its own): the rows of the tables
whose contents are deterministic must be byte-identical, the others are
compared on the columns that are (ids, timestamps and walls aside), and
the tables that report engine-specific work (compiles, the census, the
flight recorder, the bandwidth ledger) must carry the JAX package's
columns.  The serving observatory's three tables (plan_signatures,
signature_affinity, slos) carry the JAX schemas, and after the same
observations both packages' rows.  Also SHOW CATALOGS, the names and labels of
``system.runtime.metrics``, the file-based access-control cases of
tests/test_cluster_features.py:116-180 and the authenticators, replayed
against the port, and a denied query that loads no scan and runs no
kernel.
"""
import pytest

import trino_tpu.connectors.system as jax_system
import trino_tpu.session as jsession
import trino_tpu.utils.metrics as jax_metrics
from tpch_sql import QUERIES
from trino_tpu.obs import compile_observatory as jax_co
from trino_tpu.obs import doctor as jax_doctor
from trino_tpu.obs import history as jax_history
from trino_tpu.obs import journal as jax_journal
from trino_tpu_torch import convert
from trino_tpu_torch.connectors import system
from trino_tpu_torch.exec.local import LocalExecutor
from trino_tpu_torch.obs import compile_observatory as co
from trino_tpu_torch.obs import doctor, history, journal
from trino_tpu_torch.security import (
    AccessControl,
    AccessDeniedError,
    FileBasedAccessControl,
    Identity,
    JwtAuthenticator,
    PasswordAuthenticator,
)
from trino_tpu_torch.session import Session, tpch_session
from trino_tpu_torch.utils import metrics

SF = 0.001
SERVING = ("plan_signatures", "signature_affinity", "slos")


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


def test_schemas_are_the_jax_schemas_without_the_serving_tables():
    """Every schema, the serving observatory's three tables included (the
    name is the one this test had while those tables were missing)."""
    want = {t: [(c, str(ty)) for c, ty in cols]
            for t, cols in jax_system.SCHEMAS.items()}
    got = {t: [(c, str(ty)) for c, ty in cols] for t, cols in system.SCHEMAS.items()}
    assert list(got) == list(want) and got == want
    assert len(got) == 24 and set(SERVING) <= set(got)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both packages' sessions after the same statements: a memory table
    with a view and statistics, a lakehouse table with three snapshots,
    a failed query and a TPC-H scan."""
    tmp = tmp_path_factory.mktemp("system")
    for mods in ((journal, doctor, co, history), (jax_journal, jax_doctor, jax_co,
                                                  jax_history)):
        mods[0]._reset_journal()
        mods[1]._reset_diagnoses()
        mods[2]._reset_observatory()
    js = jsession.tpch_session(SF, result_cache=False,
                               query_history_dir=str(tmp / "jh"))
    ts = tpch_session(SF, device="cpu", result_cache=False,
                      query_history_dir=str(tmp / "th"))
    for s, lake in ((js, tmp / "jl"), (ts, tmp / "tl")):
        s.create_catalog("mem", "memory", {})
        s.create_catalog("lake", "lakehouse", {"lake.warehouse-dir": str(lake)})
        for sql in (
            "create table mem.default.t (x bigint, v varchar)",
            "insert into mem.default.t values (1, 'a'), (2, 'b'), (3, null)",
            "analyze mem.default.t",
            "create view mem.default.v as select x from mem.default.t where x > 1",
            "create table lake.default.l as select n_nationkey, n_name from nation",
            "insert into lake.default.l select n_nationkey, n_name from nation "
            "where n_nationkey < 5",
            "delete from lake.default.l where n_nationkey = 3",
            "select count(*) from lineitem",
            "select l_returnflag, count(*) from lineitem group by l_returnflag",
        ):
            s.execute(sql)
        with pytest.raises(Exception):
            s.execute("select no_such_column from nation")
    return js, ts


# (table, the query of its deterministic columns)
IDENTICAL = {
    "catalogs": "select * from system.metadata.catalogs",
    "tables": "select * from system.metadata.tables",
    "columns": "select * from system.jdbc.columns",
    "views": "select * from system.metadata.views",
    "queries": "select state, query, user, rows, error from system.runtime.queries "
               "where state <> 'RUNNING'",
    "completed_queries": "select state, query, user, rows, error, error_code, tenant, "
                         "plan_signature, operators from system.runtime.completed_queries",
    "nodes": "select * from system.runtime.nodes",
    "caches": "select * from system.runtime.caches where name = 'result_cache'",
    "snapshots": "select catalog, table_name, snapshot_id, parent_id, operation, "
                 "data_files, rows, is_current from system.runtime.snapshots",
    "memory": "select * from system.runtime.memory",
    "resource_groups": "select * from system.runtime.resource_groups",
    "table_stats": "select catalog, table_name, columns, row_count, data_version "
                   "from system.runtime.table_stats",
    "events": "select event_type, query_id, task_id, node_id, severity, detail "
              "from system.runtime.events where query_id = 'q_same'",
    "diagnoses": "select verdict, root_cause, error_code, event_ids, findings "
                 "from system.runtime.diagnoses",
}


@pytest.mark.parametrize("table", sorted(IDENTICAL))
def test_system_table_matches_jax(pair, table):
    js, ts = pair
    if table == "events":
        for j in (jax_journal, journal):
            j.emit(j.HEDGE, query_id="q_same", task_id="q_same.1.0.0", reason="slow")
    a, b = js.execute(IDENTICAL[table]), ts.execute(IDENTICAL[table])
    if table in ("tables", "columns", "events"):
        # the JAX page's dictionary also holds the names its filter
        # dropped (other queries): the same rows, other codes
        assert (b.names, b.to_pylist()) == (a.names, a.to_pylist())
    else:
        convert.assert_pages_identical(a, b)
    if table != "resource_groups":
        assert b.count > 0, table


def test_session_properties_rows_match_jax(pair):
    js, ts = pair
    sql = "select name, value, \"default\" from system.metadata.session_properties"
    port = {r[0]: r[1:] for r in ts.execute(sql).to_pylist()}
    jax = {r[0]: r[1:] for r in js.execute(sql).to_pylist() if r[0] in port}
    assert set(port) <= {r[0] for r in js.execute(sql).to_pylist()}
    # each session has a history directory of its own
    assert port.pop("query_history_dir")[1] == jax.pop("query_history_dir")[1] == ""
    assert len(port) == 74 and port == jax
    for name in ("query_history_max_bytes", "query_doctor",
                 "compile_cache", "compile_cache_dir", "compile_prewarm",
                 "compile_observatory_dir", "compile_census_max_families",
                 "straggler_dispersion_factor", "client_page_rows",
                 "resource_group_queue_deadline_s", "memory_admission_timeout_s",
                 "low_memory_killer_policy", "query_max_total_memory_bytes",
                 "exchange_retry_attempts", "exchange_retry_budget_s",
                 "dynamic_filtering", "node_gone_grace_s", "cross_host_mesh") + A7:
        assert name in port
    # the JAX package's properties the port does not take: the CPU re-run
    # and the six of the eager-only executor
    missing = {r[0] for r in js.execute(sql).to_pylist()} - set(port) - {"query_history_dir"}
    assert missing == {"device_cpu_fallback", "group_capacity",
                       "jit_fragments", "padding_ladder", "padding_ladder_file",
                       "topn_initial_factor", "donate_pages"}, missing


# the fault-tolerance, recovery, autoscaler and serving properties
A7 = ("retry_policy", "query_retry_attempts", "fte_max_attempts", "fte_task_timeout_s",
      "fte_speculation_factor", "fte_speculation_min_s", "speculative_execution",
      "adaptive_replan_factor", "coordinator_recovery_dir",
      "coordinator_recovery_window_s", "autoscale_min_workers", "autoscale_max_workers",
      "autoscale_backlog_high", "autoscale_cooldown_s", "autoscale_idle_grace_s",
      "serving_observatory_dir", "serving_observatory_max_bytes",
      "signature_census_max", "slo_latency_target_s", "slo_error_budget",
      "slo_fast_window_s", "slo_slow_window_s", "slo_burn_threshold")


@pytest.mark.parametrize("name, value, bad, default", [
    ("retry_policy", "'task'", "'sometimes'", "'none'"),
    ("adaptive_replan_factor", "2.5", "'x'", "4.0"),
    ("fte_max_attempts", "6", "'many'", "4"),
    ("speculative_execution", "false", "'perhaps'", "true"),
])
def test_a7_properties_set_and_refuse_as_in_jax(pair, name, value, bad, default):
    js, ts = pair
    show = ("select name, value, \"default\" from system.metadata.session_properties "
            f"where name = '{name}'")
    for s in (js, ts):
        s.execute(f"set session {name} = {value}")
    assert ts.execute(show).to_pylist() == js.execute(show).to_pylist()
    for s in (js, ts):
        with pytest.raises(Exception):
            s.execute(f"set session {name} = {bad}")
        s.execute(f"set session {name} = {default}")
    assert ts.execute(show).to_pylist() == js.execute(show).to_pylist()


# the tables whose rows report engine-specific work: the JAX columns, and
# rows after the statements that feed them
ENGINE = ("compiles", "shape_census", "flight_recorder", "kernel_bandwidth",
          "operator_stats", "metrics")


@pytest.mark.parametrize("table", ENGINE)
def test_engine_tables_carry_the_jax_columns(pair, table, monkeypatch):
    from trino_tpu_torch.cache import compile_cache

    js, ts = pair
    if table in ("kernel_bandwidth", "operator_stats"):
        for s in pair:
            s.execute("set session bandwidth_ledger = true")
            s.execute("set session operator_stats = true")
            s.execute("select count(*) from orders where o_orderkey < 100")
    if table == "shape_census":
        co.get_observatory().observe_launch("grouped_count", 6005)
    if table == "compiles":
        # a cache of its own: another test may have encoded Q6's program
        monkeypatch.setattr(ts.caches, "compile_cache", compile_cache.CompileCache())
        ts.execute("set session megakernels = 'on'")
        ts.execute(QUERIES[6][0])
        ts.execute("set session megakernels = 'auto'")
    sql = f"select * from system.runtime.{table}"
    a, b = js.execute(sql), ts.execute(sql)
    assert b.names == a.names
    assert [str(c.type) for c in b.columns] == [str(c.type) for c in a.columns]
    assert b.count > 0, table
    if table == "operator_stats":
        cols = "operator_id, operator_type, input_rows, output_rows, calls"
        q = f"select {cols} from system.runtime.operator_stats"
        for s in pair:
            s.execute("select count(*) from orders where o_orderkey < 100")
        assert ts.execute(q).to_pylist() == js.execute(q).to_pylist()
        for s in pair:
            s.execute("set session operator_stats = false")
            s.execute("set session bandwidth_ledger = false")


@pytest.mark.parametrize("table", SERVING)
def test_serving_tables_match_jax(pair, table):
    """After the same observations each package's serving observatory
    answers its three tables with the same rows."""
    from trino_tpu.obs import serving_observatory as jax_so
    from trino_tpu_torch.obs import serving_observatory as so

    js, ts = pair
    for mod in (jax_so, so):
        mod._reset_observatory()
        obs = mod.get_observatory()
        for i in range(3):
            obs.observe_query(
                signature="sig-sys", tenant="etl", query_id=f"q{i}",
                latency_s=0.2 * (i + 1), ok=i != 2, device_wall_s=0.01,
                host_wall_s=0.02, cache_hit=bool(i), cache_stored=True,
                families=["famX"], node_id="node-1", ts=1000.0 + i, quiet=True)
    try:
        sql = f"select * from system.runtime.{table}"
        a, b = js.execute(sql), ts.execute(sql)
        assert b.count == a.count > 0
        convert.assert_pages_identical(a, b)
    finally:
        for mod in (jax_so, so):
            mod._reset_observatory()


def test_show_catalogs_matches_jax(pair):
    js, ts = pair
    convert.assert_pages_identical(js.execute("show catalogs"), ts.execute("show catalogs"))
    assert ts.execute("show catalogs").to_pylist() == [
        ("lake",), ("mem",), ("system",), ("tpch",)]


def test_system_tables_are_never_result_cached():
    s = tpch_session(SF, device="cpu")
    s.execute("select count(*) from system.runtime.nodes")
    s.execute("select * from system.runtime.queries")
    assert s.caches.result_cache.puts == 0
    s.execute("select count(*) from nation")
    assert s.caches.result_cache.puts == 1


def test_metrics_names_and_labels_are_the_jax_packages(pair):
    """Every series the port registers is one the JAX package registers
    for the same work, under the same name, kind and label keys."""
    js, ts = pair
    q = "select name, kind, labels from system.runtime.metrics"
    jax = js.execute(q).to_pylist()
    port = ts.execute(q).to_pylist()

    def keys(labels):
        return tuple(sorted(p.split("=")[0] for p in labels.strip("{}").split(",") if p))

    jax_kinds = {(n, k, keys(lb)) for n, k, lb in jax}
    port_kinds = {(n, k, keys(lb)) for n, k, lb in port}
    shared = {n for n, _, _ in port_kinds} & {n for n, _, _ in jax_kinds}
    assert {"trino_tpu_cache_op_total", "trino_tpu_journal_events_total",
            "trino_tpu_doctor_diagnoses_total", "trino_tpu_memory_pool_size_bytes",
            "trino_tpu_lake_commits_total", "trino_tpu_lake_commit_seconds",
            "trino_tpu_device_state", "trino_tpu_objstore_ops_total",
            "trino_tpu_stats_analyze_total"} <= shared
    assert {x for x in port_kinds if x[0] in shared} <= jax_kinds
    for name, _, _ in port_kinds:
        assert jax_metrics.METRIC_NAME_RE.match(name), name
    assert metrics.METRIC_NAME_RE.pattern == jax_metrics.METRIC_NAME_RE.pattern
    # the same label values where the work is the same
    sel = ("select labels from system.runtime.metrics where name = "
           "'trino_tpu_lake_commits_total' order by labels")
    assert ts.execute(sel).to_pylist() == js.execute(sel).to_pylist()


def test_registry_instruments_match_jax():
    for mod in (metrics, jax_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("trino_tpu_cache_op_total").inc(2, tier="result", op="hit")
        reg.gauge("trino_tpu_device_state").set(1.0, node="n", device="0")
        h = reg.histogram("trino_tpu_lake_commit_seconds")
        for v in (0.002, 0.02, 0.2, 2.0):
            h.observe(v)
        with pytest.raises(ValueError):
            reg.counter("not_a_metric")
        with pytest.raises(TypeError):
            reg.gauge("trino_tpu_cache_op_total")
    assert (metrics.MetricsRegistry().rows() == jax_metrics.MetricsRegistry().rows())
    port, jax = metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()
    for reg in (port, jax):
        reg.counter("trino_tpu_cache_op_total").inc(2, tier="result", op="hit")
        h = reg.histogram("trino_tpu_lake_commit_seconds")
        for v in (0.002, 0.02, 0.2, 2.0):
            h.observe(v)
    assert port.rows() == jax.rows()


# -- access control (tests/test_cluster_features.py:116-180) -------------


def test_file_based_rules_read_only():
    ac = FileBasedAccessControl({
        "catalogs": [
            {"user": "*", "catalog": "tpch", "allow": "read-only"},
            {"user": "admin", "catalog": "*", "allow": "all"},
        ],
    })
    alice, admin = Identity("alice"), Identity("admin")
    ac.check_can_select(alice, "tpch", "nation", ["n_name"])
    with pytest.raises(AccessDeniedError):
        ac.check_can_insert(alice, "tpch", "nation")
    with pytest.raises(AccessDeniedError):
        ac.check_can_select(alice, "memory", "t", [])
    ac.check_can_insert(admin, "memory", "t")


def test_table_level_rules():
    ac = FileBasedAccessControl({
        "catalogs": [{"user": "*", "catalog": "*", "allow": "all"}],
        "tables": [{"user": "*", "catalog": "tpch", "table": "nation",
                    "privileges": ["SELECT"]}],
    })
    i = Identity("bob")
    ac.check_can_select(i, "tpch", "nation", [])
    with pytest.raises(AccessDeniedError):
        ac.check_can_select(i, "tpch", "orders", [])
    with pytest.raises(AccessDeniedError):
        ac.check_can_delete(i, "tpch", "nation")


READ_ONLY_EXCEPT_ADMIN = {"catalogs": [
    {"user": "admin", "catalog": "*", "allow": "all"},
    {"user": "*", "catalog": "tpch", "allow": "read-only"},
]}


def test_session_enforces_select():
    js = jsession.tpch_session(SF)
    ts = tpch_session(SF, device="cpu")
    for s in (js, ts):
        s.access_control.add(FileBasedAccessControl(READ_ONLY_EXCEPT_ADMIN))
        assert s.execute("select count(*) from nation").to_pylist() == [(25,)]
    with pytest.raises(AccessDeniedError) as err:
        ts.execute("select * from system.runtime.nodes")
    with pytest.raises(Exception) as jerr:
        js.execute("select * from system.runtime.nodes")
    assert str(err.value) == str(jerr.value)
    assert ts.execute("select state from system.runtime.nodes",
                      user="admin").to_pylist() == [("active",)]
    failed = [h for h in ts.query_history if h["state"] == "FAILED"]
    assert failed[-1]["user"] == "user" and failed[-1]["error_code"] == "INTERNAL_ERROR"


def test_session_enforces_writes():
    pair = (jsession.Session(), Session(device="cpu"))
    for s in pair:
        s.create_catalog("memory", "memory", {})
        s.access_control.add(FileBasedAccessControl({"catalogs": [
            {"user": "writer", "catalog": "*", "allow": "all"},
            {"user": "*", "catalog": "*", "allow": "read-only"},
        ]}))
    for s in pair:
        with pytest.raises(AccessDeniedError if s is pair[1] else Exception):
            s.execute("create table t (a bigint)")
        s.execute("create table t (a bigint)", user="writer")
        s.execute("insert into t values (1)", user="writer")
        for sql in ("insert into t values (2)", "delete from t",
                    "create table t2 as select * from t", "drop table t",
                    "create view vv as select * from t"):
            with pytest.raises(AccessDeniedError if s is pair[1] else Exception):
                s.execute(sql)
        assert s.execute("select * from t").to_pylist() == [(1,)]
        s.execute("drop table t", user="writer")


def test_denied_query_loads_no_scan_and_runs_no_kernel(monkeypatch):
    """Access control runs on the plan, before any scan loads or any
    kernel launches: a denied Q6 never reaches the executor (nor its
    EXPLAIN ANALYZE, nor an ANALYZE)."""
    runs = []
    real = LocalExecutor.execute
    monkeypatch.setattr(LocalExecutor, "execute",
                        lambda self, plan: runs.append(plan) or real(self, plan))
    s = tpch_session(SF, device="cpu", result_cache=False, megakernels="on")
    s.access_control.add(FileBasedAccessControl({"catalogs": [
        {"user": "analyst", "catalog": "tpch", "allow": "read-only"}]}))
    misses = s._scan_cache.misses
    for sql in (QUERIES[6][0], "explain analyze " + QUERIES[6][0],
                "analyze lineitem (l_quantity)"):
        with pytest.raises(AccessDeniedError, match="Cannot access catalog tpch"):
            s.execute(sql)
    assert runs == [] and s._scan_cache.misses == misses
    assert s.last_kernel_profile is None and s.last_scan_bytes == 0
    assert s.execute(QUERIES[6][0], user="analyst").count == 1
    assert len(runs) == 1 and s._scan_cache.misses == misses + 1
    assert s.last_diagnosis["verdict"] == doctor.HEALTHY


def test_set_session_and_execute_query_checks():
    class NoSet(AccessControl):
        def check_can_set_session(self, identity, name):
            if identity.user != "admin":
                raise AccessDeniedError(f"Access Denied: Cannot set {name}")

    class NoGuests(AccessControl):
        def check_can_execute_query(self, identity):
            if identity.user == "guest":
                raise AccessDeniedError("Access Denied: Cannot execute query")

    s = tpch_session(SF, device="cpu")
    s.access_control.add(NoSet())
    s.access_control.add(NoGuests())
    with pytest.raises(AccessDeniedError, match="Cannot set spill_enabled"):
        s.execute("set session spill_enabled = false")
    assert s.properties.get("spill_enabled") is True
    s.execute("set session spill_enabled = false", user="admin")
    assert s.properties.get("spill_enabled") is False
    with pytest.raises(AccessDeniedError, match="Cannot execute query"):
        s.execute("select 1", user="guest")
    assert s.execute("select 1").to_pylist() == [(1,)]


def test_password_and_jwt_authenticators():
    auth = PasswordAuthenticator({"alice": "secret"})
    assert auth.authenticate("alice", "secret").user == "alice"
    with pytest.raises(AccessDeniedError):
        auth.authenticate("alice", "wrong")
    with pytest.raises(AccessDeniedError):
        auth.authenticate("mallory", "secret")
    from trino_tpu.security import JwtAuthenticator as JaxJwt

    jwt = JwtAuthenticator("k", audience="trino")
    token = jwt.sign({"sub": "bob", "aud": "trino"})
    assert token == JaxJwt("k").sign({"sub": "bob", "aud": "trino"})
    assert jwt.authenticate_token(token).user == "bob"
    with pytest.raises(AccessDeniedError, match="wrong audience"):
        jwt.authenticate_token(JwtAuthenticator("k").sign({"sub": "bob"}))
    with pytest.raises(AccessDeniedError, match="invalid JWT"):
        JwtAuthenticator("other").authenticate_token(token)
    with pytest.raises(AccessDeniedError, match="expired"):
        jwt.authenticate_token(jwt.sign({"sub": "bob", "aud": "trino", "exp": 1}))


def test_every_new_property_acts(tmp_path):
    """The eight properties of this slice each change what the session
    does (a property accepted that does nothing would be a fault)."""
    from trino_tpu_torch.cache import compile_cache
    from trino_tpu_torch.ops import kernels as kn

    hd, od, cd = (str(tmp_path / k) for k in ("h", "o", "c"))
    try:
        s = tpch_session(SF, device="cpu", result_cache=False, megakernels="on",
                         query_history_dir=hd, query_history_max_bytes=1 << 18,
                         compile_observatory_dir=od, compile_census_max_families=3,
                         compile_cache_dir=cd, compile_prewarm=False)
        assert s.history.directory == hd and s.history.max_bytes == 1 << 18
        obs = co.get_observatory()
        assert obs.directory == od and obs.census.max_families == 3
        assert kn.build_dir() == cd and s.last_prewarm is None
        s.execute(QUERIES[6][0])
        assert history.read_history_dir(hd) and co.read_observatory_dir(od)
        assert s.last_diagnosis is not None
        s.execute("set session query_doctor = false")
        s.last_diagnosis = None
        s.execute("select 1")
        assert s.last_diagnosis is None
        s.execute("set session compile_cache = false")
        before = s.caches.compile_cache.stats()
        s.execute(QUERIES[6][0])
        assert s.caches.compile_cache.stats() == before
        s2 = tpch_session(SF, device="cpu", compile_cache_dir=cd)  # prewarm on
        assert s2.last_prewarm["entries"] >= 1
    finally:
        co._reset_observatory()
        history._reset_stores()
        kn.set_build_dir(None)
        compile_cache.shared_compile_cache().attach_persistent(None)
