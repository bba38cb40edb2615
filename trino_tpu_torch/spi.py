"""Connector SPI — the plugin boundary.

Reference parity: core/trino-spi/src/main/java/io/trino/spi/connector/
(Plugin.java:36, ConnectorMetadata, ConnectorSplitManager,
ConnectorPageSourceProvider -> ConnectorPageSource.getNextPage:59).

The engine sees data sources only through these interfaces; connectors
(connectors/tpch.py, memory.py, blackhole.py) implement them.  Pages are
host-side numpy columns; upload to HBM happens at the operator boundary
(the LazyBlock analog — spi/block/LazyBlock.java:32).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import types as T
from .page import Page


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    type: T.Type


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: Tuple[ColumnSchema, ...]

    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column_type(self, name: str) -> T.Type:
        for c in self.columns:
            if c.name == name:
                return c.type
        raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class ColumnStatistics:
    """Per-column stats for the CBO (spi/statistics/ColumnStatistics).

    ``histogram`` is an optional equi-height histogram — a tuple of
    ``(low, high, fraction)`` buckets over the non-null rows (plain
    tuples: hashable and JSON-round-trippable for persistence) —
    produced by ANALYZE from the device-sort quantiles.

    A decimal column's ``min_value``/``max_value`` are in value units
    (0.08), as ANALYZE and parquet footers give them, unless
    ``decimal_lanes`` says they are in its scaled int64 lanes' units
    (8 at scale 2), as the tpch connector gives them."""

    distinct_count: Optional[float] = None
    null_fraction: float = 0.0
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    histogram: Optional[Tuple[Tuple[float, float, float], ...]] = None
    decimal_lanes: bool = False


@dataclasses.dataclass(frozen=True)
class TableStatistics:
    """Reference: spi/statistics/TableStatistics via
    ConnectorMetadata.getTableStatistics (TpchMetadata supplies these
    for the reference's CBO)."""

    row_count: float
    columns: Dict[str, ColumnStatistics] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Split:
    """A unit of parallel scan work (spi/connector/ConnectorSplit)."""

    table: str
    ordinal: int
    total: int
    info: dict = dataclasses.field(default_factory=dict)


class ConnectorMetadata:
    def list_tables(self) -> List[str]:
        raise NotImplementedError

    def get_table_schema(self, table: str) -> TableSchema:
        raise NotImplementedError

    def get_table_statistics(self, table: str) -> TableStatistics:
        raise NotImplementedError

    def store_table_statistics(
        self, table: str, stats: TableStatistics, data_version: int
    ) -> None:
        """Persist ANALYZE results keyed by the table's data_version
        (ConnectorMetadata.finishStatisticsCollection analog).  A later
        get_table_statistics MUST NOT serve these once data_version has
        moved on — DML invalidates stats exactly like it invalidates the
        result cache.  Connectors without durable storage may leave this
        unimplemented; the engine keeps a session-side overlay instead."""
        raise NotImplementedError(
            f"{type(self).__name__} does not store statistics"
        )

    # -- writes (ConnectorMetadata.beginCreateTable/beginInsert/...; a
    # connector that leaves these unimplemented is read-only) ----------
    def create_table(self, schema: TableSchema) -> None:
        raise NotImplementedError(f"{type(self).__name__} is read-only")

    def drop_table(self, table: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} is read-only")


class SplitManager:
    def get_splits(
        self, table: str, desired: int, constraint=None
    ) -> List[Split]:
        """constraint: optional per-column domains — entries are
        (column, lo, hi) inclusive ranges OR (column, lo, hi, values)
        where `values` is a sorted tuple of exactly-admissible values
        (discrete ValueSet / IN-list pushdown); unpack defensively
        (TupleDomain pushdown) — connectors MAY prune splits with it."""
        raise NotImplementedError

    def subdivide(self, split: Split, parts: int) -> List[Split]:
        """`split` cut into at most `parts` splits that together read what
        it reads (a streamed task's tiles of its own splits).  A connector
        that cannot cut a split returns it whole."""
        return [split]


class PageSource:
    """Streaming page iterator (ConnectorPageSource.getNextPage)."""

    def pages(self) -> Iterator[Page]:
        raise NotImplementedError

    def dictionaries(self) -> Dict[str, np.ndarray]:
        """Host dictionaries for varchar columns produced by this source."""
        return {}


class PageSourceProvider:
    def create_page_source(
        self, split: Split, columns: Sequence[str]
    ) -> PageSource:
        raise NotImplementedError


class PageSink:
    """Write-side mirror of PageSource (spi/connector/ConnectorPageSink:
    appendPage/finish).  One sink per write operation; finish() commits
    and returns the row count."""

    def append(self, page: Page) -> None:
        raise NotImplementedError

    def finish(self) -> int:
        raise NotImplementedError


class PageSinkProvider:
    """spi/connector/ConnectorPageSinkProvider."""

    def create_sink(self, table: str, columns: Sequence[str],
                    overwrite: bool = False) -> PageSink:
        """overwrite=True replaces the table contents atomically at
        finish() — the rewrite slot used by DELETE (the reference routes
        row-level deletes through MergeWriterNode; here the engine computes
        the kept rows and rewrites)."""
        raise NotImplementedError


class Connector:
    """One mounted catalog (spi/connector/Connector)."""

    name: str
    # deterministic sources (generators, immutable tables) may be cached
    # across queries; mutable/live sources must set this False or bump
    # data_version() on every change.  A cacheable connector's loaded rows
    # are a function of (splits, columns, data_version): pushdown reaches
    # them only through get_splits (the scan cache keys by the splits,
    # never by the constraint, and holds lanes by column)
    cacheable: bool = True

    def data_version(self, table: Optional[str] = None) -> int:
        """Per-table data-version fingerprint: the cache-invalidation SPI.

        Every cache tier keys on this value — the device scan cache, the
        compiled-fragment cache and the fragment result cache all embed
        (catalog, table, data_version(table)) in their keys, so a version
        bump makes stale entries unaddressable without any explicit
        invalidation protocol.  Contract:

        - MUST change whenever the visible contents of ``table`` change
          (INSERT/DELETE/overwrite, external file mutation, ...).
        - SHOULD be scoped to ``table`` (an INSERT into A must not churn
          cached results scanning B); ``table=None`` asks for a whole-
          catalog version (any-table-changed counter).
        - MUST be stable within a process for unchanged data, and SHOULD
          be stable ACROSS processes (derive from content/mtimes, not
          from salted ``hash()``) so persistent compile-cache keys built
          from it survive restarts.

        The default (constant 0) is correct for immutable sources
        (generators, static files); mutable connectors either bump a
        counter per write (connectors/memory) or fingerprint the backing
        storage (connectors/hive walks the table directory's mtimes).
        Sources that cannot honor the contract must set ``cacheable``
        False instead."""
        return 0

    def session_property_metadata(self) -> dict:
        """Per-catalog session properties this connector understands
        (spi/session PropertyMetadata via Connector
        .getSessionProperties): name -> config.PropertyMetadata.
        SET SESSION <catalog>.<name> = value routes here."""
        return {}

    def set_session_property(self, name: str, value) -> None:
        """Apply a validated per-catalog session property (the
        ConnectorSession property bag; sessions own their
        CatalogManager, so connector instances are session-scoped)."""
        meta = self.session_property_metadata().get(name)
        if meta is not None and meta.parse is int and int(value) <= 0:
            raise ValueError(
                f"catalog session property {name} must be positive"
            )
        if not hasattr(self, "session_props"):
            self.session_props = {}
        self.session_props[name] = value

    def get_session_property(self, name: str):
        """Current value of a per-catalog session property, falling
        back to its declared metadata default — the single read path
        (no duplicated defaults at call sites)."""
        props = getattr(self, "session_props", {})
        if name in props:
            return props[name]
        meta = self.session_property_metadata().get(name)
        return meta.default if meta is not None else None

    def table_functions(self) -> dict:
        """Connector-provided polymorphic table functions
        (spi/function/table ConnectorTableFunction seam): name ->
        callable(*scalar_args) returning (schema, rows) where schema
        is [(column, Type), ...]."""
        return {}

    def metadata(self) -> ConnectorMetadata:
        raise NotImplementedError

    def split_manager(self) -> SplitManager:
        raise NotImplementedError

    def page_source_provider(self) -> PageSourceProvider:
        raise NotImplementedError

    def page_sink_provider(self) -> PageSinkProvider:
        raise NotImplementedError(f"connector {self.name} is read-only")


class Plugin:
    """Reference: spi/Plugin.java:36 — a factory of connector factories."""

    def connector_factories(self) -> Dict[str, "ConnectorFactory"]:
        return {}


class ConnectorFactory:
    name: str

    def create(self, catalog_name: str, config: dict) -> Connector:
        raise NotImplementedError
