"""Session facade of the port: SQL in, Pages out.

Counterpart of trino_tpu/session.py, trimmed to the query path:
parse -> analyze/plan -> optimize -> execute (exec/local.LocalExecutor)
for SELECT and the writes (INSERT, CREATE TABLE AS, DELETE, UPDATE,
MERGE), CREATE TABLE, DROP TABLE, SHOW TABLES and EXPLAIN.  Session
properties are the JAX package's (config.SessionProperties); the
executor reads `megakernels` and the memory properties: a
LocalMemoryManager sized by `query_max_memory_bytes` arbitrates each
query's host and device reservations, the scan cache is registered with
it as revocable, and queries over the limit stream or spill
(`spill_enabled`, `double_buffer_depth`, `memory_blocked_timeout_s`).
Not in this slice: SET SESSION, EXPLAIN ANALYZE, views, prepared
statements, the device supervisor, the result cache, the doctor, the
journal and the distributed executors.

Sessions run on the CUDA card unless created with device="cpu"; without
a card and without that request, creating one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from . import device as D
from . import types as T
from .catalog import CatalogManager, Metadata
from .config import SessionProperties
from .expr import ir
from .connectors.memory import MemoryConnectorFactory
from .connectors.tpcds import TpcdsConnectorFactory
from .connectors.tpch import TpchConnectorFactory
from .exec.local import DeviceScanCache, LocalExecutor
from .expr.lower import ProjectionMemo
from .memory import LocalMemoryManager
from .page import Page, column_from_pylist, page_from_pydict
from .plan import nodes as P
from .plan.optimizer import optimize
from .sql import ast
from .sql.analyzer import Analyzer
from .sql.parser import parse


class Session:
    def __init__(
        self,
        catalog: Optional[str] = None,
        config: Optional[dict] = None,
        device=None,
    ):
        self.device = D.resolve(device)
        self.catalogs = CatalogManager()
        self.catalogs.register_factory(TpchConnectorFactory())
        self.catalogs.register_factory(TpcdsConnectorFactory())
        self.catalogs.register_factory(MemoryConnectorFactory())
        self.default_catalog = catalog
        self.properties = SessionProperties(config)
        self.metadata = Metadata(self.catalogs)
        self.sql_functions: dict = {}
        # per-node memory arbitration: host pools and the device tier
        self.memory_manager = LocalMemoryManager(
            self.properties.get("query_max_memory_bytes"))
        # cross-query scan cache (device-resident scan lanes), revoked
        # first under memory pressure (_executor registers what it holds)
        self._scan_cache = DeviceScanCache(device=self.device)
        self._plan_cache: dict = {}
        self._capacity_hints: dict = {}
        # streaming fragment DAGs keyed by id(plan)
        self._fragment_cache: dict = {}
        # host dictionary projections reused across queries
        self._projection_memo = ProjectionMemo()
        self.last_kernel_profile: Optional[dict] = None

    def create_catalog(self, name: str, connector: str, config: dict):
        self.catalogs.create_catalog(name, connector, config)
        if self.default_catalog is None:
            self.default_catalog = name

    def _executor(self) -> LocalExecutor:
        # the bytes the cache holds, not its budget (a quarter of the
        # card, above the default limit): only real pressure revokes it
        self.memory_manager.unregister_revocable("scan-cache")
        self.memory_manager.register_revocable(
            "scan-cache", self._scan_cache.bytes, self._scan_cache.drop_all,
        )
        return LocalExecutor(self.catalogs, {
            "device": self.device,
            "megakernels": self.properties.get("megakernels"),
            "scan_cache": (
                self._scan_cache
                if self.properties.get("scan_cache_enabled") else None
            ),
            "capacity_hints": self._capacity_hints,
            "projection_memo": self._projection_memo,
            "memory_limit_bytes": self.properties.get("query_max_memory_bytes"),
            "spill_enabled": self.properties.get("spill_enabled"),
            "memory_manager": self.memory_manager,
            "memory_blocked_timeout_s": self.properties.get("memory_blocked_timeout_s"),
            "double_buffer_depth": self.properties.get("double_buffer_depth"),
            "fragment_cache": self._fragment_cache,
        })

    # ------------------------------------------------------------------
    def plan(self, sql: str, optimized: bool = True) -> P.PlanNode:
        stmt = parse(sql)
        if isinstance(stmt, ast.Explain):
            stmt = stmt.query
        return self._plan_stmt(stmt, optimized)

    def _plan_stmt(self, stmt, optimized: bool = True) -> P.PlanNode:
        analyzer = Analyzer(self.metadata, self.default_catalog,
                            self.sql_functions)
        plan = analyzer.plan_statement(stmt)
        if optimized:
            plan = optimize(plan, self.metadata, self.properties)
        return plan

    def explain(self, sql: str) -> str:
        return P.plan_to_string(self.plan(sql))

    # ------------------------------------------------------------------
    def execute(self, sql: str) -> Page:
        stmt = parse(sql)
        if isinstance(stmt, ast.Explain):
            if stmt.analyze:
                raise NotImplementedError(
                    "EXPLAIN ANALYZE is not in this slice of the port"
                )
            text = P.plan_to_string(self._plan_stmt(stmt.query))
            lines = text.split("\n")
            return Page([column_from_pylist(T.VARCHAR, lines)], len(lines),
                        ["Query Plan"])
        if isinstance(stmt, (ast.CreateTable, ast.DropTable)):
            return self._ddl(stmt)
        if isinstance(stmt, ast.ShowTables):
            conn = self.catalogs.get(self.default_catalog)
            tables = sorted(conn.metadata().list_tables())
            return page_from_pydict([("table", T.VARCHAR)], {"table": tables})
        if isinstance(stmt, ast.Query):
            plan = self._plan_cache.get(sql)
            if plan is None:
                plan = self._plan_stmt(stmt)
                # nondeterministic plans carry query-time folded constants
                # (now() timestamps, rand() seeds): caching the plan by SQL
                # text would replay the first execution's values forever
                if plan_is_deterministic(plan):
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
        executor = self._executor()
        page = executor.execute(plan)
        self.last_kernel_profile = executor.kernel_profile
        if isinstance(plan.source, P.TableWriter):
            self._scan_cache.evict_table(plan.source.catalog, plan.source.table)
        return page

    def _ddl(self, stmt) -> Page:
        """CREATE TABLE [IF NOT EXISTS] / DROP TABLE [IF EXISTS] (the JAX
        package's, without access control)."""
        from .spi import ColumnSchema, TableSchema

        self._plan_cache.clear()
        self._capacity_hints.clear()
        catalog, table = self.metadata.resolve_new_table(
            stmt.table, self.default_catalog
        )
        md = self.catalogs.get(catalog).metadata()
        zero = page_from_pydict([("rows", T.BIGINT)], {"rows": [0]})
        if isinstance(stmt, ast.DropTable):
            if stmt.if_exists and table not in md.list_tables():
                return zero
            md.drop_table(table)
            self._scan_cache.evict_table(catalog, table)
            return zero
        if self.metadata.lookup_view(stmt.table, self.default_catalog):
            raise ValueError(f"view with that name already exists: {table}")
        if stmt.if_not_exists and table in md.list_tables():
            return zero
        md.create_table(TableSchema(table, tuple(
            ColumnSchema(c.lower(), T.parse_type(t)) for c, t in stmt.columns
        )))
        return zero


_WRITES = (ast.Insert, ast.CreateTableAs, ast.Delete, ast.Update,
           ast.MergeInto)


def _plan_exprs(plan: P.PlanNode):
    """Every ir.Expr reachable from any node field (predicates,
    projections, aggregates, ...)."""

    def from_val(v):
        if isinstance(v, P.PlanNode):
            return
        if isinstance(v, ir.Expr):
            yield v
        elif isinstance(v, tuple):
            for x in v:
                yield from from_val(x)
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                yield from from_val(getattr(v, f.name))

    stack = [plan]
    while stack:
        n = stack.pop()
        stack.extend(n.sources)
        for f in dataclasses.fields(n):
            yield from from_val(getattr(n, f.name))


def plan_is_deterministic(plan: P.PlanNode) -> bool:
    """True when no expression of the plan calls a nondeterministic
    function and no constant was folded from one (the reference's
    plan_signature(plan).deterministic)."""
    return all(ir.is_deterministic(e) for e in _plan_exprs(plan))


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
