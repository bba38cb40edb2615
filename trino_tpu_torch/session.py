"""Session facade of the port: SQL in, Pages out.

Counterpart of trino_tpu/session.py.  Reference parity: the in-process
query path of testing/PlanTester.java:250 / StandaloneQueryRunner —
parse -> analyze/plan -> optimize -> execute (exec/local.LocalExecutor)
— with the session machinery around it:
  - typed session properties and SET / SHOW SESSION, catalog properties
    included (SystemSessionProperties; config.SessionProperties);
  - per-phase spans (utils/tracing.TRACER) and query lifecycle events to
    registered listeners (utils/events);
  - views, SQL functions, USE, transaction control, prepared statements
    (PREPARE / EXECUTE ... USING / DEALLOCATE / DESCRIBE INPUT|OUTPUT),
    ANALYZE and SHOW STATS (stats/analyze.py), EXPLAIN [ANALYZE]
    (obs/opstats.py operator timeline, the kernel profile with the
    launches of each CUDA kernel, obs/bandwidth.py ledger);
  - the result cache (cache/): deterministic queries over versioned
    tables are answered from earlier pages, invalidated by writes;
  - a LocalMemoryManager sized by `query_max_memory_bytes` arbitrates
    each query's host and device reservations; the scan cache is
    registered with it as revocable, and queries over the limit stream
    or spill;
  - the fault path: a DeviceSupervisor (runtime/) guards the card, the
    seeded FaultInjector of `fault_injection` (one per spec text) feeds
    it, the memory manager and the result cache, failed queries go to
    the incident journal (obs/journal.py, on disk under
    `event_journal_dir`);
  - the connectors: tpch, tpcds, memory, blackhole, hive (parquet, ORC,
    CSV and JSON through pyarrow, where it is installed) and lakehouse
    (snapshots and time travel on the object store of fs/), and the
    `system` catalog (connectors/system.py) over the session's state;
  - the observatories: every query is written to the crash-safe query
    history (obs/history.py, on disk under `query_history_dir`) when it
    starts and when it ends, diagnosed by the query doctor at finalize
    (obs/doctor.py, `query_doctor`), and its compiles are recorded by
    the compile observatory (obs/compile_observatory.py, on disk under
    `compile_observatory_dir`); the encoded megakernel programs are held
    by the process's compile cache (cache/compile_cache.py, with the
    kernel libraries and a program index under `compile_cache_dir`);
  - access control (security.py): the statement's identity must be
    allowed to run queries, and its plan's scans and writes are checked
    before any scan loads or any kernel launches.
With `distributed = true` a query runs over a mesh of logical shards
(parallel/mesh_executor.py).  Not in this slice: the server and its
cross-host executors.

Sessions run on the CUDA card unless created with device="cpu"; without
a card and without that request, creating one raises.
"""
from __future__ import annotations

import time
import uuid
from typing import Optional

from . import device as D
from . import types as T
from .cache import (
    CacheManager,
    CompileCache,
    FragmentResultCache,
    plan_signature,
    shared_compile_cache,
)
from .catalog import CatalogManager, Metadata
from .config import SessionProperties
from .connectors.blackhole import BlackholeConnectorFactory
from .connectors.lakehouse import LakehouseConnectorFactory
from .connectors.memory import MemoryConnectorFactory
from .connectors.system import SystemConnectorFactory
from .connectors.tpcds import TpcdsConnectorFactory
from .connectors.tpch import TpchConnectorFactory
from .exec.local import DeviceScanCache, LocalExecutor
from .expr.lower import ProjectionMemo
from .memory import LocalMemoryManager
from .page import Page, column_from_pylist, page_from_pydict
from .plan import nodes as P
from .obs import compile_observatory, doctor, journal
from .obs.history import get_store as _history_store
from .plan.optimizer import optimize
from .runtime import DeviceSupervisor
from .security import AccessControlManager, Identity
from .sql import ast
from .sql.analyzer import Analyzer
from .sql.parser import parse
from .utils.events import EventListenerManager
from .utils.tracing import TRACER

# statements that change planning state: cached plans and capacity hints
# are stale after them (read-only EXECUTE / SHOW / EXPLAIN keep them)
_REPLANNING = (ast.Prepare, ast.Deallocate, ast.CreateFunction,
               ast.DropFunction, ast.CreateTable, ast.DropTable, ast.Use,
               ast.SetSession, ast.CreateView, ast.DropView)
_WRITES = (ast.Insert, ast.CreateTableAs, ast.Delete, ast.Update,
           ast.MergeInto)


def _ok_page() -> Page:
    return page_from_pydict([("result", T.BOOLEAN)], {"result": [True]})


def _rows_page(n: int) -> Page:
    return page_from_pydict([("rows", T.BIGINT)], {"rows": [n]})


def _varchar_page(name: str, lines) -> Page:
    return Page([column_from_pylist(T.VARCHAR, list(lines))], len(lines), [name])


class Session:
    def __init__(
        self,
        catalog: Optional[str] = None,
        config: Optional[dict] = None,
        device=None,
        user: str = "user",
    ):
        self.device = D.resolve(device)
        self.catalogs = CatalogManager()
        self.catalogs.register_factory(TpchConnectorFactory())
        self.catalogs.register_factory(TpcdsConnectorFactory())
        self.catalogs.register_factory(MemoryConnectorFactory())
        self.catalogs.register_factory(BlackholeConnectorFactory())
        try:
            from .connectors.hive import HiveConnectorFactory

            self.catalogs.register_factory(HiveConnectorFactory())
        except ImportError:  # pyarrow not installed: no hive catalogs
            pass
        self.catalogs.register_factory(LakehouseConnectorFactory())
        self.default_catalog = catalog
        self.properties = SessionProperties(config)
        self.metadata = Metadata(self.catalogs)
        self.events = EventListenerManager()
        self.tracer = TRACER
        # PREPARE name FROM ... (the reference keeps these per client
        # session) and the CREATE FUNCTION registry
        self.prepared: dict = {}
        self.sql_functions: dict = {}
        self.identity = Identity(user)
        self.access_control = AccessControlManager()
        # system.runtime.queries / completed_queries: the crash-safe store
        # shared by every session of the process (one per directory)
        self.history = _history_store(
            self.properties.get("query_history_dir") or None,
            max_bytes=int(self.properties.get("query_history_max_bytes")
                          or (1 << 20)),
        )
        # per-node memory arbitration: host pools and the device tier
        self.memory_manager = LocalMemoryManager(
            self.properties.get("query_max_memory_bytes"), node_id="session")
        # the supervised device boundary: one per node, like the memory
        # manager (quarantine is node-local)
        self.device_supervisor = DeviceSupervisor(node_id="session",
                                                  device=self.device)
        # FaultInjector instances per spec text: rules are stateful (nth
        # counters), so the same spec must keep reusing one injector
        self._fault_injectors: dict = {}
        # the process-global incident journal: memory-only until a
        # directory upgrades it to the crash-safe segment store
        if self.properties.get("event_journal_dir"):
            journal.configure(
                self.properties.get("event_journal_dir"),
                max_bytes=int(self.properties.get("event_journal_max_bytes")
                              or (1 << 20)),
            )
        # the process-global compile observatory: a directory upgrades it
        # to the crash-safe segment store
        fams = int(self.properties.get("compile_census_max_families")
                   or compile_observatory.DEFAULT_MAX_FAMILIES)
        if self.properties.get("compile_observatory_dir"):
            compile_observatory.configure(
                self.properties.get("compile_observatory_dir"),
                census_max_families=fams)
        elif fams != compile_observatory.DEFAULT_MAX_FAMILIES:
            # resize the census without re-pointing (or dropping) the
            # directory an earlier session configured
            compile_observatory.configure(
                compile_observatory.get_observatory().directory,
                census_max_families=fams)
        # the ranked verdict of the last doctored query, and the stats of
        # the last prewarm of the persistent compile cache
        self.last_diagnosis: Optional[dict] = None
        self.last_prewarm: Optional[dict] = None
        # ANALYZE runs (system.runtime.table_stats): (catalog, table) ->
        # the last run's columns, row count, data version and timings
        self.analyzed_tables: dict = {}
        # the built-in system catalog (system.runtime.* and friends)
        self.catalogs.register_factory(SystemConnectorFactory())
        self.catalogs.create_catalog("system", "system", {"session": self})
        # cross-query scan cache (device-resident scan lanes), revoked
        # first under memory pressure (_executor registers what it holds)
        self._scan_cache = DeviceScanCache(device=self.device)
        self.caches = CacheManager(
            FragmentResultCache(
                max_bytes=self.properties.get("result_cache_max_bytes"),
                on_event=self.events.cache_event,
            ),
            shared_compile_cache(),
            self._scan_cache,
        )
        self._attach_compile_cache()
        self._plan_cache: dict = {}
        self._capacity_hints: dict = {}
        # streaming fragment DAGs keyed by id(plan)
        self._fragment_cache: dict = {}
        # host dictionary projections reused across queries
        self._projection_memo = ProjectionMemo()
        self.last_kernel_profile: Optional[dict] = None
        # the query whose run made last_kernel_profile (the doctor reads
        # a profile only for its own query)
        self._profile_query_id: Optional[str] = None
        # the scan working set of the last query (0 when served from the
        # result cache)
        self.last_scan_bytes = 0
        # operator timeline of the last instrumented execution (EXPLAIN
        # ANALYZE / operator_stats = true)
        self.last_timeline: Optional[dict] = None

    def create_catalog(self, name: str, connector: str, config: dict):
        self.catalogs.create_catalog(name, connector, config)
        if self.default_catalog is None:
            self.default_catalog = name

    @property
    def query_history(self) -> list:
        """The history store as system.runtime.queries reads it: the
        latest record of every query of every session sharing the store."""
        return [{
            "query_id": r.get("queryId"), "state": r.get("state"),
            "sql": r.get("sql"), "user": r.get("user"),
            "created": r.get("created"), "finished": r.get("finished"),
            "rows": r.get("rows"), "error": r.get("error"),
            "error_code": r.get("errorCode"),
        } for r in self.history.entries()]

    def _attach_compile_cache(self) -> None:
        """compile_cache_dir: the kernel libraries and the program index
        live there (the package's build directory when empty); with
        compile_prewarm the libraries are built (on the card) and the
        indexed programs encoded, once a directory and process."""
        cc = self.caches.compile_cache
        cache_dir = self.properties.get("compile_cache_dir")
        cc.attach_persistent(cache_dir or None)
        if cache_dir and self.properties.get("compile_prewarm"):
            warm = cc.prewarm(cache_dir, build=self.device.type == "cuda")
            if warm is not None:
                self.last_prewarm = warm

    def _executor(self, **overrides) -> LocalExecutor:
        """The executor of one query under the session's properties
        (`overrides` replace config keys: EXPLAIN ANALYZE's instrumented
        run is otherwise the run `execute` performs)."""
        # the bytes the cache holds, not its budget (a quarter of the
        # card, above the default limit): only real pressure revokes it
        self.memory_manager.unregister_revocable("scan-cache")
        self.memory_manager.register_revocable(
            "scan-cache", self._scan_cache.bytes, self._scan_cache.drop_all,
        )
        props = self.properties
        self._attach_compile_cache()
        inj = self._fault_injector()
        self.memory_manager.fault_injector = inj
        sup = self.device_supervisor.configure(props)
        sup.fault_injector = inj
        config = {
            "device": self.device,
            "device_supervisor": sup,
            "distributed": bool(props.get("distributed")),
            "broadcast_join_threshold_rows": props.get("broadcast_join_threshold_rows"),
            "megakernels": props.get("megakernels"),
            "device_generation": props.get("device_generation"),
            "scan_cache": (
                self._scan_cache if props.get("scan_cache_enabled") else None
            ),
            "capacity_hints": self._capacity_hints,
            "projection_memo": self._projection_memo,
            "memory_limit_bytes": props.get("query_max_memory_bytes"),
            "spill_enabled": props.get("spill_enabled"),
            "memory_manager": self.memory_manager,
            "memory_blocked_timeout_s": props.get("memory_blocked_timeout_s"),
            "double_buffer_depth": props.get("double_buffer_depth"),
            "fragment_cache": self._fragment_cache,
            # compile_cache = false detaches the shared tier: the
            # executor encodes into a cache of its own
            "compile_cache": (self.caches.compile_cache
                              if props.get("compile_cache") else CompileCache()),
            # operator_stats = true times every operator (synchronizing
            # the card after each one)
            "collect_node_stats": bool(props.get("operator_stats")),
            "bandwidth_ledger": bool(props.get("bandwidth_ledger")),
        }
        config.update(overrides)
        if config["distributed"]:
            # one shard on each of num_devices logical devices (0: one a
            # visible card; one on the CPU)
            from .parallel.mesh_executor import MeshExecutor, default_mesh

            mesh = default_mesh(props.get("num_devices") or None, self.device)
            return MeshExecutor(self.catalogs, mesh, config)
        return LocalExecutor(self.catalogs, config)

    # ------------------------------------------------------------------
    def plan(self, sql: str, optimized: bool = True) -> P.PlanNode:
        stmt = parse(sql)
        if isinstance(stmt, ast.Explain):
            stmt = stmt.query
        return self._plan_stmt(stmt, optimized)

    def _plan_stmt(self, stmt, optimized: bool = True) -> P.PlanNode:
        with self.tracer.span("analyze_plan"):
            analyzer = Analyzer(self.metadata, self.default_catalog,
                                self.sql_functions)
            plan = analyzer.plan_statement(stmt)
        if optimized:
            with self.tracer.span("optimize"):
                plan = optimize(plan, self.metadata, self.properties)
        return plan

    def explain(self, sql: str) -> str:
        return P.plan_to_string(self.plan(sql))

    # ------------------------------------------------------------------
    def execute(self, sql: str, user: Optional[str] = None) -> Page:
        """Run one statement as `user` (the session's identity when None):
        recorded in the query history when it starts and when it ends,
        and diagnosed by the doctor at finalize."""
        identity = Identity(user) if user else self.identity
        query_id = f"q_{uuid.uuid4().hex[:12]}"
        created = self.events.query_created(query_id, sql)
        entry = {"query_id": query_id, "sql": sql, "state": "RUNNING",
                 "user": identity.user, "created": created}
        self.history.put(entry)
        try:
            with self.tracer.span("query", query_id=query_id):
                with self.tracer.span("parse"):
                    stmt = parse(sql)
                self.access_control.check_can_execute_query(identity)
                page = self._execute_statement(stmt, sql, query_id, identity)
            self.events.query_completed(query_id, sql, "FINISHED", created,
                                        page.count)
            entry.update(state="FINISHED", finished=time.time(),
                         rows=page.count, wall_s=time.time() - created)
            # only this query's timeline (last_timeline outlives queries
            # for system.runtime.operator_stats)
            tl = self.last_timeline
            if tl and tl.get("queryId") == query_id:
                entry["operators"] = tl.get("operators")
            self.history.put(entry)
            self._finalize_doctor(query_id, created)
            return page
        except Exception as e:
            code = doctor.classify_error(e)
            self.events.query_completed(query_id, sql, "FAILED", created,
                                        error=str(e))
            entry.update(state="FAILED", finished=time.time(), error=str(e),
                         error_code=code, wall_s=time.time() - created)
            self.history.put(entry)
            journal.emit(journal.QUERY_FAILED, query_id=query_id,
                         severity=journal.ERROR, error=str(e)[:400],
                         errorCode=code)
            self._finalize_doctor(query_id, created, error=e)
            raise
        finally:
            # export the completed spans on every completion path (a no-op
            # without an attached OTLP exporter)
            self.tracer.flush()

    def _finalize_doctor(self, query_id: str, created: float, error=None):
        """The doctor's pass at query finalize (`query_doctor`): the
        journal, the operator timeline and the kernel profile of this
        query into a ranked verdict (system.runtime.diagnoses)."""
        if not self.properties.get("query_doctor"):
            return
        now = time.time()
        tl = self.last_timeline
        diag = doctor.diagnose_query(
            query_id, window=(created, now),
            timeline=tl if (tl or {}).get("queryId") == query_id else None,
            profile=(self.last_kernel_profile
                     if self._profile_query_id == query_id else None),
            error=error, wall_s=now - created,
        )
        doctor.record_diagnosis(diag)
        self.last_diagnosis = diag

    def _execute_statement(self, stmt, sql: str, query_id: str,
                           identity: Optional[Identity] = None) -> Page:
        identity = identity or self.identity
        if isinstance(stmt, _REPLANNING):
            self._plan_cache.clear()
            self._capacity_hints.clear()
        utility = self._utility(stmt, sql, query_id, identity)
        if utility is not None:
            return utility
        if isinstance(stmt, ast.Query):
            plan = self._plan_cache.get(sql)
            if plan is None:
                plan = self._plan_stmt(stmt)
                # nondeterministic plans carry query-time folded constants
                # (now() timestamps, rand() seeds): caching the plan by SQL
                # text would replay the first execution's values forever
                if plan_signature(plan).deterministic:
                    self._plan_cache[sql] = plan
                    for k in list(self._plan_cache)[:-256]:
                        self._plan_cache.pop(k, None)
        elif isinstance(stmt, _WRITES):
            # writes change data: cached plans and capacity hints are
            # stale (the scan cache keys by the table's data version)
            self._plan_cache.clear()
            self._capacity_hints.clear()
            plan = self._plan_stmt(stmt)
        else:
            raise NotImplementedError(
                f"{type(stmt).__name__} is not in this slice of the port"
            )
        # before any scan loads or any kernel launches
        self._check_plan_access(plan, identity)
        rkey = None
        if isinstance(stmt, ast.Query):
            rkey, page = self.cached_result(plan)
            if page is not None:
                return page
        executor = self._executor()
        # the fragment executors of streamed and spilled runs copy the
        # config: journal events and breadcrumbs carry the real query id
        executor.query_id = executor.config["query_id"] = query_id
        with self.tracer.span("execute", query_id=query_id):
            t0 = time.time()
            page = executor.execute(plan)
            wall = time.time() - t0
        self.last_scan_bytes = executor.scan_bytes
        self.last_kernel_profile = executor.kernel_profile
        self._profile_query_id = query_id
        if executor.node_stats:
            from .obs import opstats

            self.last_timeline = {
                "queryId": query_id, "wallS": wall,
                "operators": opstats.frames_from_plan(
                    plan, executor.node_stats,
                    blocked_memory_s=executor.blocked_memory_s),
            }
            if getattr(executor, "mesh_tasks", None):
                # a mesh run: one task a shard in the stage timeline, and
                # the straggler detector scores the shards as it scores
                # worker tasks
                det = opstats.StragglerDetector(
                    factor=float(self.properties.get("straggler_dispersion_factor")))
                tl = opstats.timeline_from_tasks(executor.mesh_tasks, detector=det)
                self.last_timeline["stages"] = tl["stages"]
                if det.flags:
                    self.last_timeline["stragglers"] = det.flags
        if rkey is not None:
            self.store_result(rkey, page)
        if isinstance(plan.source, P.TableWriter):
            self.caches.invalidate_table(plan.source.catalog, plan.source.table)
        return page

    def _check_plan_access(self, plan: P.PlanNode, identity) -> None:
        """Table-level authorization over a planned statement: SELECT on
        every scanned table, INSERT/DELETE/CREATE on write targets (the
        checks StatementAnalyzer and the planner make in the reference)."""
        ac = self.access_control

        def walk(n: P.PlanNode):
            if isinstance(n, P.TableScan):
                ac.check_can_select(identity, n.catalog, n.table,
                                    [c for _, c in n.assignments])
            if isinstance(n, P.TableWriter):
                if n.create_schema is not None:
                    ac.check_can_create_table(identity, n.catalog, n.table)
                elif n.count_symbol is not None:  # UPDATE rewrites rows
                    ac.check_can_insert(identity, n.catalog, n.table)
                    ac.check_can_delete(identity, n.catalog, n.table)
                elif n.report_deleted:
                    ac.check_can_delete(identity, n.catalog, n.table)
                else:
                    ac.check_can_insert(identity, n.catalog, n.table)
            for src in n.sources:
                walk(src)

        walk(plan)

    # -- utility statements --------------------------------------------
    def _utility(self, stmt, sql: str, query_id: str,
                 identity: Identity) -> Optional[Page]:
        """The page of a statement that runs no query plan, or None."""
        if isinstance(stmt, ast.SetSession):
            self.access_control.check_can_set_session(identity, stmt.name)
            if "." in stmt.name:
                # per-catalog session property, validated against the
                # connector's declared metadata
                cat, _, prop = stmt.name.partition(".")
                conn = self.catalogs.get(cat)
                meta = conn.session_property_metadata().get(prop)
                if meta is None:
                    raise KeyError(f"unknown catalog session property: {stmt.name}")
                value = (meta.parse(stmt.value)
                         if isinstance(stmt.value, str) else stmt.value)
                conn.set_session_property(prop, value)
            else:
                self.properties.set(stmt.name, stmt.value)
            return _ok_page()
        if isinstance(stmt, ast.ShowSession):
            rows = list(self.properties.show())
            for cat in self.catalogs.names():
                conn = self.catalogs.get(cat)
                for name, meta in sorted(conn.session_property_metadata().items()):
                    rows.append((f"{cat}.{name}", str(conn.get_session_property(name)),
                                 str(meta.default), meta.description))
            cols = ("name", "value", "default", "description")
            return page_from_pydict([(c, T.VARCHAR) for c in cols],
                                    {c: [r[i] for r in rows] for i, c in enumerate(cols)})
        if isinstance(stmt, (ast.CreateView, ast.DropView, ast.ShowCreateView)):
            return self._view_statement(stmt, identity)
        if isinstance(stmt, ast.ShowTables):
            conn = self.catalogs.get(self.default_catalog)
            tables = sorted(set(conn.metadata().list_tables())
                            | set(self.metadata.list_views(self.default_catalog)))
            return page_from_pydict([("table", T.VARCHAR)], {"table": tables})
        if isinstance(stmt, ast.ShowColumns):
            view = self.metadata.lookup_view(stmt.table, self.default_catalog)
            if view is not None:
                cols = list(view.columns)
            else:
                _, schema = self.metadata.resolve_table(stmt.table, self.default_catalog)
                cols = [(c.name, str(c.type)) for c in schema.columns]
            return page_from_pydict([("column", T.VARCHAR), ("type", T.VARCHAR)],
                                    {"column": [c for c, _ in cols],
                                     "type": [t for _, t in cols]})
        if isinstance(stmt, (ast.CreateFunction, ast.DropFunction, ast.ShowFunctions)):
            return self._function_statement(stmt)
        if isinstance(stmt, ast.Use):
            self.catalogs.get(stmt.name[0])  # raises if unknown
            self.default_catalog = stmt.name[0]
            return _ok_page()
        if isinstance(stmt, ast.TransactionControl):
            if stmt.kind == "rollback":
                raise ValueError(
                    "ROLLBACK is not supported: statements auto-commit "
                    "(one transaction per query)"
                )
            return _ok_page()
        if isinstance(stmt, ast.ShowStats):
            return self._show_stats(stmt)
        if isinstance(stmt, ast.Analyze):
            return self.execute_analyze(stmt, identity)
        if isinstance(stmt, ast.ShowCreateTable):
            catalog, schema = self.metadata.resolve_table(stmt.table, self.default_catalog)
            cols = ",\n   ".join(f"{c.name} {c.type}" for c in schema.columns)
            return _varchar_page("create_table",
                                 [f"CREATE TABLE {catalog}.{schema.name} (\n   {cols}\n)"])
        if isinstance(stmt, ast.ShowSchemas):
            self.catalogs.get(stmt.catalog or self.default_catalog)  # raises if unknown
            # catalogs here are single-schema: the flattened layout
            return _varchar_page("schema", ["default", "information_schema"])
        if isinstance(stmt, ast.ShowCatalogs):
            return _varchar_page("catalog", sorted(self.catalogs.names()))
        if isinstance(stmt, (ast.Prepare, ast.Deallocate, ast.ExecutePrepared,
                             ast.Describe)):
            return self._prepared_statement(stmt, sql, query_id, identity)
        if isinstance(stmt, ast.Explain):
            if stmt.analyze:
                return self._explain_analyze(stmt.query, query_id, identity)
            return self._explain(stmt)
        if isinstance(stmt, (ast.CreateTable, ast.DropTable)):
            return self._ddl(stmt, identity)
        return None

    def _view_statement(self, stmt, identity: Identity) -> Page:
        from .catalog import ViewDefinition

        if isinstance(stmt, ast.ShowCreateView):
            view = self.metadata.lookup_view(stmt.name, self.default_catalog)
            if view is None:
                raise KeyError(f"view not found: {'.'.join(stmt.name)}")
            return _varchar_page("create_view", [
                f"CREATE VIEW {view.catalog}.{view.name} AS\n{view.original_sql}"])
        catalog, name = self.metadata.resolve_new_table(stmt.name, self.default_catalog)
        if isinstance(stmt, ast.DropView):
            self.access_control.check_can_drop_table(identity, catalog, name)
            self.metadata.drop_view(stmt.name, self.default_catalog, stmt.if_exists)
            return _ok_page()
        # views are named schema objects: the create-table rule governs
        # them (the reference's checkCanCreateView has the same default)
        self.access_control.check_can_create_table(identity, catalog, name)
        # plan the query now: validates it and captures the view's
        # declared column names and types
        plan = Analyzer(self.metadata, self.default_catalog,
                        self.sql_functions).plan_statement(stmt.query)
        types = plan.source.output_types()
        cols = tuple((n, str(types[s])) for n, s in zip(plan.names, plan.symbols))
        seen = set()
        for n, _t in cols:
            if n.lower() in seen:
                raise ValueError(f"duplicate view column name {n}")
            seen.add(n.lower())
        self.metadata.create_view(
            ViewDefinition(catalog, name, stmt.query_sql, stmt.query, cols,
                           context_catalog=self.default_catalog),
            stmt.replace,
        )
        return _ok_page()

    def _function_statement(self, stmt) -> Page:
        from .expr.functions import SIGNATURES
        from .sql.analyzer import AGGREGATES, SqlFunction

        if isinstance(stmt, ast.ShowFunctions):
            names = sorted(set(SIGNATURES) | AGGREGATES | set(self.sql_functions))
            kinds = ["sql" if n in self.sql_functions
                     else "aggregate" if n in AGGREGATES else "scalar"
                     for n in names]
            return page_from_pydict([("function", T.VARCHAR), ("kind", T.VARCHAR)],
                                    {"function": names, "kind": kinds})
        name = stmt.name.lower()
        if isinstance(stmt, ast.DropFunction):
            if name not in self.sql_functions:
                if stmt.if_exists:
                    return _ok_page()
                raise KeyError(f"function not found: {name}")
            del self.sql_functions[name]
            return _ok_page()
        if name in self.sql_functions and not stmt.replace:
            raise ValueError(f"function {name} already exists")
        T.parse_type(stmt.return_type)  # validate eagerly
        for _, pt in stmt.params:
            T.parse_type(pt)
        self.sql_functions[name] = SqlFunction(
            name, tuple((p.lower(), t) for p, t in stmt.params),
            stmt.return_type, stmt.body,
        )
        return _ok_page()

    def _prepared_statement(self, stmt, sql: str, query_id: str,
                            identity: Identity) -> Page:
        key = stmt.name.lower()
        if isinstance(stmt, ast.Prepare):
            self.prepared[key] = stmt.statement
            return _ok_page()
        if key not in self.prepared:
            raise KeyError(f"prepared statement not found: {stmt.name}")
        target = self.prepared[key]
        if isinstance(stmt, ast.Deallocate):
            del self.prepared[key]
            return _ok_page()
        if isinstance(stmt, ast.ExecutePrepared):
            bound = ast.substitute_parameters(target, stmt.args)
            nparams = ast.count_parameters(bound)
            if nparams:
                raise ValueError(
                    f"{nparams} parameter(s) left unbound; "
                    f"EXECUTE ... USING must supply all values"
                )
            return self._execute_statement(bound, sql, query_id, identity)
        n = ast.count_parameters(target)
        if stmt.kind == "input":
            return page_from_pydict([("position", T.BIGINT), ("type", T.VARCHAR)],
                                    {"position": list(range(1, n + 1)),
                                     "type": ["unknown"] * n})
        # DESCRIBE OUTPUT: plan with NULL-bound parameters for typing
        bound = ast.substitute_parameters(
            target, tuple(ast.Literal("null", None) for _ in range(n)))
        plan = self._plan_stmt(bound)
        types = plan.source.output_types()
        return page_from_pydict([("column", T.VARCHAR), ("type", T.VARCHAR)],
                                {"column": list(plan.names),
                                 "type": [str(types[s]) for s in plan.symbols]})

    def _explain(self, stmt) -> Page:
        plan = self._plan_stmt(stmt.query)
        if stmt.plan_type == "distributed":
            from .plan.fragment import fragment_plan

            parts = []
            for f in fragment_plan(plan):
                parts.append(
                    f"Fragment {f.id} [{f.partitioning}"
                    + (f" keys={list(f.partition_keys)}" if f.partition_keys else "")
                    + f" -> output {f.output_partitioning}]")
                parts.append("\n".join(
                    "  " + line for line in P.plan_to_string(f.root).split("\n")))
            text = "\n".join(parts)
        else:
            text = P.plan_to_string(plan, costs=self._costs(plan))
        return _varchar_page("Query Plan", text.split("\n"))

    def _costs(self, plan) -> Optional[dict]:
        """The cost model's per-node estimates, or None where it cannot
        cost the plan (as in the JAX package, EXPLAIN then prints none)."""
        from .plan.cost import annotate

        try:
            return annotate(plan, self.metadata, self.properties)
        except Exception:  # noqa: BLE001 — estimates are optional
            return None

    def _ddl(self, stmt, identity: Identity) -> Page:
        """CREATE TABLE [IF NOT EXISTS] / DROP TABLE [IF EXISTS] (the JAX
        package's)."""
        from .spi import ColumnSchema, TableSchema

        catalog, table = self.metadata.resolve_new_table(
            stmt.table, self.default_catalog
        )
        if isinstance(stmt, ast.DropTable):
            self.access_control.check_can_drop_table(identity, catalog, table)
        else:
            self.access_control.check_can_create_table(identity, catalog, table)
        md = self.catalogs.get(catalog).metadata()
        if isinstance(stmt, ast.DropTable):
            if stmt.if_exists and table not in md.list_tables():
                return _rows_page(0)
            md.drop_table(table)
            self.caches.invalidate_table(catalog, table)
            return _rows_page(0)
        if self.metadata.lookup_view(stmt.table, self.default_catalog):
            raise ValueError(f"view with that name already exists: {table}")
        if stmt.if_not_exists and table in md.list_tables():
            return _rows_page(0)
        md.create_table(TableSchema(table, tuple(
            ColumnSchema(c.lower(), T.parse_type(t)) for c, t in stmt.columns
        )))
        return _rows_page(0)

    # -- the result cache ------------------------------------------------
    def _result_cache_key(self, plan):
        """(digest, params, table versions), or None when the plan must
        not be result-cached: the tier is off, the plan nondeterministic,
        or a scanned connector is not cacheable."""
        if not self.properties.get("result_cache"):
            return None
        sig = plan_signature(plan)
        if not sig.deterministic:
            return None
        versions = []
        for cat, tab in sig.tables:
            try:
                conn = self.catalogs.get(cat)
            except Exception:  # noqa: BLE001 — an unknown catalog: no key
                return None
            if not getattr(conn, "cacheable", True):
                return None
            versions.append((cat, tab, conn.data_version(tab)))
        return (sig.digest, sig.params, tuple(versions))

    def cached_result(self, plan):
        """(key, page) of a planned query: key None when uncacheable, a
        page on a hit (the query then runs nothing)."""
        key = self._result_cache_key(plan)
        if key is None:
            return None, None
        rc = self.caches.result_cache
        # SET SESSION result_cache_max_bytes resizes the live budget
        rc.max_bytes = int(self.properties.get("result_cache_max_bytes"))
        page = rc.get(key, injector=self._fault_injector())
        if page is None:
            return key, None
        self.last_scan_bytes = 0  # served from cache: nothing was scanned
        self.last_kernel_profile = None  # and no kernel ran
        # relabel with this plan's output names: the digest is alias-
        # invariant, so the cached page may carry another query's names
        return key, Page(list(page.columns), page.count, list(plan.names))

    def _fault_injector(self):
        """The session's FaultInjector of the fault_injection property,
        one per spec text (rules hold nth-counters, so the same spec must
        keep reusing one injector), or None when the property is empty."""
        spec = self.properties.get("fault_injection")
        if not spec:
            return None
        key = spec if isinstance(spec, str) else repr(spec)
        inj = self._fault_injectors.get(key)
        if inj is None:
            from .utils.faults import FaultInjector

            inj = self._fault_injectors[key] = FaultInjector.from_spec(spec)
        return inj

    def store_result(self, key, page: Page) -> None:
        # the scanned tables ride in the key's version component
        tables = tuple((c, t) for c, t, _v in key[2])
        self.caches.result_cache.put(key, page, tables=tables)

    # -- EXPLAIN ANALYZE -------------------------------------------------
    def _explain_analyze(self, query, query_id: str, identity: Identity) -> Page:
        """Execute with per-node instrumentation and print the plan with
        rows and walls, the operator timeline, the kernel profile (each
        CUDA kernel's launches), the compiles by cause, the bandwidth
        ledger and the doctor's verdict (ExplainAnalyzeOperator +
        PlanPrinter; single node)."""
        from .obs import opstats
        from .ops import kernels as kn

        plan = self._plan_stmt(query)
        self._check_plan_access(plan, identity)
        t_created = time.time()  # the doctor's window
        # the session's run, instrumented; its point is per-operator
        # accounting, so always with the ledger
        executor = self._executor(collect_node_stats=True,
                                  bandwidth_ledger=True)
        executor.query_id = executor.config["query_id"] = query_id
        before = dict(kn.LAUNCHES)
        t0 = time.perf_counter()
        page = executor.execute(plan)
        wall = time.perf_counter() - t0
        launches = {k: v - before.get(k, 0) for k, v in kn.LAUNCHES.items()}
        prof = executor.kernel_profile
        self.last_kernel_profile = prof
        self._profile_query_id = query_id
        text = P.plan_to_string(plan, executor.node_stats)
        text += (f"\n\nQuery: {page.count} output rows in {wall * 1000:.2f}ms "
                 f"(single node)")
        frames = opstats.frames_from_plan(
            plan, executor.node_stats, costs=self._costs(plan),
            blocked_memory_s=executor.blocked_memory_s)
        self.last_timeline = {"queryId": query_id, "wallS": wall, "operators": frames}
        text += "\n\n" + opstats.format_timeline(frames, wall)
        summary = prof.get("summary") or {}
        text += (
            f"\n\nKernel profile ({self.device}):"
            f"\n  runs: {summary.get('executions', 0)}"
            f" over {summary.get('actualRows', 0)} scanned rows"
            f"\n  scans generated on the device: {prof.get('deviceGeneratedScans', 0)},"
            f" by the host: {prof.get('hostGeneratedScans', 0)}"
            f"\n  transfers: {summary.get('h2dBytes', 0)}B host->device, "
            f"{summary.get('d2hBytes', 0)}B device->host"
        )
        launched = {k: v for k, v in sorted(launches.items()) if v}
        text += "\n  kernel launches: " + (
            ", ".join(f"{k} {v}" for k, v in launched.items()) or "none")
        if prof.get("fusedAggregates"):
            text += (f"\n  fused aggregates: {prof['fusedAggregates']} "
                     f"({prof.get('fusedTerms', 0)} terms)")
        # the compile observatory's causes: nvcc builds and program encodes
        # (first_compile, persistent_load, shape_miss) and retry-ladder
        # re-runs (ladder_rung); none on a warm run
        by_cause = summary.get("compilesByCause") or {}
        text += "\n\nCompiles:"
        if any(by_cause.values()):
            for cause in compile_observatory.CAUSES:
                if by_cause.get(cause):
                    text += f"\n  {cause}: {by_cause[cause]}"
        else:
            text += "\n  (no compiles this query)"
        bandwidth = prof.get("bandwidth") or []
        if bandwidth:
            text += (
                f"\n\nDevice memory bandwidth ledger ({summary.get('effectiveGbps', 0.0):.2f}"
                f" GB/s effective, {summary.get('rooflinePct', 0.0):.3f}% of"
                f" {summary.get('rooflineGbps', 0.0):.0f} GB/s):"
            )
            for e in bandwidth:
                text += (
                    f"\n  run {e['kernel']} [{e['mode']}]: {e['gbps']:.2f} GB/s "
                    f"({e['rooflinePct']:.3f}% roofline), in {e['inputBytes']}B, "
                    f"out {e['outputBytes']}B, inter {e['intermediateBytes']}B over "
                    f"{e['deviceWallS'] * 1000:.2f}ms device wall"
                )
        # the doctor's verdict over the same evidence (the interactive
        # "why was this slow" surface)
        if self.properties.get("query_doctor"):
            diag = doctor.diagnose_query(
                query_id, window=(t_created, time.time()),
                timeline=self.last_timeline, profile=prof, wall_s=wall)
            doctor.record_diagnosis(diag)
            self.last_diagnosis = diag
            text += "\n\n" + doctor.format_diagnosis(diag)
        return _varchar_page("Query Plan", text.split("\n"))

    # -- ANALYZE / SHOW STATS --------------------------------------------
    def _show_stats(self, stmt) -> Page:
        catalog, schema = self.metadata.resolve_table(stmt.table, self.default_catalog)
        stats = self.metadata.table_statistics(catalog, schema.name)
        names, dvs, nfs, lows, highs = [], [], [], [], []
        for c in schema.columns:
            cs = stats.columns.get(c.name)
            names.append(c.name)
            dvs.append(None if cs is None else cs.distinct_count)
            nfs.append(None if cs is None else cs.null_fraction)
            lows.append(None if cs is None or cs.min_value is None
                        else str(cs.min_value))
            highs.append(None if cs is None or cs.max_value is None
                         else str(cs.max_value))
        # summary row (the reference's NULL-column row_count row)
        for col in (names, dvs, nfs, lows, highs):
            col.append(None)
        rc = [None] * len(schema.columns) + [float(stats.row_count)]
        return page_from_pydict(
            [("column_name", T.VARCHAR), ("distinct_values_count", T.DOUBLE),
             ("nulls_fraction", T.DOUBLE), ("row_count", T.DOUBLE),
             ("low_value", T.VARCHAR), ("high_value", T.VARCHAR)],
            {"column_name": names, "distinct_values_count": dvs,
             "nulls_fraction": nfs, "row_count": rc,
             "low_value": lows, "high_value": highs},
        )

    def execute_analyze(self, stmt, identity: Optional[Identity] = None,
                        execute_plan=None) -> Page:
        """ANALYZE <table> [(cols)]: collect, store and register (the
        system.runtime.table_stats row); cached plans were costed without
        these statistics.  The coordinator passes `execute_plan` to run
        the synthesized aggregations through the distributed fragment
        scheduler instead of the in-process executor."""
        from .utils.metrics import counter

        catalog, schema = self.metadata.resolve_table(stmt.table, self.default_catalog)
        self.access_control.check_can_select(
            identity or self.identity, catalog, schema.name,
            list(stmt.columns) or [c.name for c in schema.columns])
        started = time.time()
        stats = self.collect_statistics(catalog, schema, stmt.columns,
                                        execute_plan=execute_plan)
        version = self.metadata.store_table_statistics(catalog, schema.name, stats)
        self.analyzed_tables[(catalog, schema.name)] = {
            "catalog": catalog, "table": schema.name,
            "columns": tuple(stmt.columns or (c.name for c in schema.columns)),
            "row_count": float(stats.row_count),
            "data_version": int(version),
            "analyzed_at": started,
            "duration_s": max(0.0, time.time() - started),
        }
        self._plan_cache.clear()
        self._capacity_hints.clear()
        counter("trino_tpu_stats_analyze_total").inc()
        return _rows_page(int(stats.row_count))

    def collect_statistics(self, catalog: str, schema, columns=(),
                           execute_plan=None):
        """Run the synthesized ANALYZE aggregations (ordinary SQL through
        the planner and executor, or `execute_plan`) and assemble a
        TableStatistics."""
        from .stats import analyze_queries, assemble, column_tasks

        buckets = max(1, int(self.properties.get("analyze_histogram_buckets")))
        tasks = column_tasks(schema, columns)
        qualified = f"{catalog}.default.{schema.name}"
        if execute_plan is None:
            execute_plan = self._executor().execute
        chunk_results = []
        with self.tracer.span("analyze_collect", table=qualified):
            for csql, chunk in analyze_queries(qualified, tasks, buckets):
                page = execute_plan(self._plan_stmt(parse(csql)))
                row = [c.to_python(page.count)[0] if page.count else None
                       for c in page.columns]
                chunk_results.append((chunk, row))
        return assemble(chunk_results, buckets)


def tpch_session(sf: float = 0.01, device=None, **config) -> Session:
    """One-liner entry: a session over the TPC-H generator connector at
    scale factor `sf`, on the CUDA card unless device="cpu"."""
    s = Session(config=config, device=device)
    s.create_catalog("tpch", "tpch", {"tpch.scale-factor": sf})
    return s


def tpcds_session(sf: float = 0.01, device=None, **config) -> Session:
    """A session over the TPC-DS generator connector at scale factor
    `sf`, on the CUDA card unless device="cpu"."""
    s = Session(config=config, device=device)
    s.create_catalog("tpcds", "tpcds", {"tpcds.scale-factor": sf})
    return s
