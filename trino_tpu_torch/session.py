"""Session facade of the port: SQL in, Pages out.

Counterpart of trino_tpu/session.py, trimmed to the query path:
parse -> analyze/plan -> optimize -> execute (exec/local.LocalExecutor)
for SELECT, and EXPLAIN.  Session properties are the JAX package's
(config.SessionProperties); the executor reads `megakernels`.  DML, the
result cache, views, prepared statements, the doctor, the journal and
the distributed executors are not in this slice.

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
from .connectors.tpch import TpchConnectorFactory
from .exec.local import DeviceScanCache, LocalExecutor
from .page import Page, column_from_pylist
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
        self.default_catalog = catalog
        self.properties = SessionProperties(config)
        self.metadata = Metadata(self.catalogs)
        self.sql_functions: dict = {}
        # cross-query scan cache (device-resident scan lanes)
        self._scan_cache = DeviceScanCache(device=self.device)
        self._plan_cache: dict = {}
        self._capacity_hints: dict = {}
        self.last_kernel_profile: Optional[dict] = None

    def create_catalog(self, name: str, connector: str, config: dict):
        self.catalogs.create_catalog(name, connector, config)
        if self.default_catalog is None:
            self.default_catalog = name

    def _executor(self) -> LocalExecutor:
        return LocalExecutor(self.catalogs, {
            "device": self.device,
            "megakernels": self.properties.get("megakernels"),
            "scan_cache": (
                self._scan_cache
                if self.properties.get("scan_cache_enabled") else None
            ),
            "capacity_hints": self._capacity_hints,
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
        if not isinstance(stmt, ast.Query):
            raise NotImplementedError(
                f"{type(stmt).__name__} is not in this slice of the port"
            )
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
        executor = self._executor()
        page = executor.execute(plan)
        self.last_kernel_profile = executor.kernel_profile
        return page


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
