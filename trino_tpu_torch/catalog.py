"""Catalog management: mounted connectors + metadata facade.

Reference parity: metadata/MetadataManager (facade over connectors),
connector/CatalogManager + DefaultCatalogFactory (etc/catalog/*.properties
-> ConnectorFactory.create per catalog).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .spi import Connector, ConnectorFactory, TableSchema, TableStatistics


@dataclasses.dataclass(frozen=True)
class ViewDefinition:
    """Stored CREATE VIEW definition (metadata/ViewDefinition.java:28:
    originalSql + column list, expanded at analysis time by the
    StatementAnalyzer's view branch — here Analyzer._plan_table)."""

    catalog: str
    name: str
    original_sql: str  # the view's query text, as written
    query: object  # parsed ast.Node of the query
    columns: Tuple[Tuple[str, str], ...]  # (name, type text) at creation
    # session default catalog when the view was created: unqualified
    # names inside the view resolve against THIS, not whatever catalog
    # the querying session happens to have selected (the reference's
    # ViewDefinition stores catalog+schema for the same reason)
    context_catalog: Optional[str] = None


class CatalogManager:
    def __init__(self):
        self._factories: Dict[str, ConnectorFactory] = {}
        self._catalogs: Dict[str, Connector] = {}

    def register_factory(self, factory: ConnectorFactory):
        self._factories[factory.name] = factory

    def create_catalog(self, name: str, connector_name: str, config: dict):
        factory = self._factories[connector_name]
        self._catalogs[name] = factory.create(name, config)

    def get(self, name: str) -> Connector:
        if name not in self._catalogs:
            raise KeyError(f"catalog not found: {name}")
        return self._catalogs[name]

    def names(self) -> List[str]:
        return list(self._catalogs)


class Metadata:
    """MetadataManager analog: resolution entry point for the analyzer."""

    def __init__(self, catalogs: CatalogManager):
        self.catalogs = catalogs
        # session-lived view registry keyed (catalog, view_name); the
        # reference delegates durability to connector metastores, which
        # the memory-connector-style store mirrors for every catalog
        self.views: Dict[Tuple[str, str], ViewDefinition] = {}
        # ANALYZE overlay for connectors without durable stats storage:
        # (catalog, table) -> (data_version at collection, stats).  Served
        # only while the connector's data_version still matches, so DML
        # invalidates overlay stats exactly like stored ones.
        self.analyzed: Dict[Tuple[str, str], Tuple[int, TableStatistics]] = {}

    def _qualify(self, parts, default_catalog: Optional[str]):
        if len(parts) == 3:
            return parts[0], parts[2]
        if len(parts) == 2:
            return default_catalog, parts[1]
        return default_catalog, parts[0]

    def lookup_view(
        self, parts, default_catalog: Optional[str]
    ) -> Optional[ViewDefinition]:
        catalog, name = self._qualify(parts, default_catalog)
        if catalog is None:
            return None
        return self.views.get((catalog, name.lower()))

    def create_view(self, view: ViewDefinition, replace: bool):
        key = (view.catalog, view.name.lower())
        if not replace and key in self.views:
            raise ValueError(f"view already exists: {view.name}")
        # a view must not shadow a real table (the reference raises
        # TABLE_ALREADY_EXISTS at analysis)
        try:
            tables = self.catalogs.get(view.catalog).metadata().list_tables()
        except (KeyError, NotImplementedError):
            tables = []
        if view.name.lower() in tables:
            raise ValueError(
                f"table with that name already exists: {view.name}"
            )
        self.views[key] = view

    def drop_view(self, parts, default_catalog, if_exists: bool):
        catalog, name = self._qualify(parts, default_catalog)
        key = (catalog, name.lower())
        if key not in self.views:
            if if_exists:
                return False
            raise KeyError(f"view not found: {'.'.join(parts)}")
        del self.views[key]
        return True

    def list_views(self, catalog: str) -> List[str]:
        return sorted(n for c, n in self.views if c == catalog)

    def resolve_table(
        self, parts, default_catalog: Optional[str]
    ) -> "tuple[str, TableSchema]":
        """parts: (table,) | (schema, table) | (catalog, schema, table)."""
        if len(parts) == 3:
            catalog, _schema, table = parts
        elif len(parts) == 2:
            catalog, table = default_catalog, parts[1]
        else:
            catalog, table = default_catalog, parts[0]
        if catalog is None:
            raise ValueError(f"no catalog specified for table {'.'.join(parts)}")
        conn = self.catalogs.get(catalog)
        md = conn.metadata()
        if parts[-1] not in md.list_tables():
            raise KeyError(f"table not found: {catalog}.{parts[-1]}")
        return catalog, md.get_table_schema(parts[-1])

    def resolve_new_table(
        self, parts, default_catalog: Optional[str]
    ) -> "tuple[str, str]":
        """(catalog, table) for a table that need not exist (DDL targets)."""
        if len(parts) == 3:
            catalog, _schema, table = parts
        elif len(parts) == 2:
            catalog, table = default_catalog, parts[1]
        else:
            catalog, table = default_catalog, parts[0]
        if catalog is None:
            raise ValueError(f"no catalog specified for table {'.'.join(parts)}")
        return catalog, table

    def table_statistics(self, catalog: str, table: str) -> TableStatistics:
        from .utils.metrics import counter

        conn = self.catalogs.get(catalog)
        entry = self.analyzed.get((catalog, table))
        if entry is not None:
            version, stats = entry
            if conn.data_version(table) == version:
                counter("trino_tpu_stats_served_total").inc()
                return stats
            del self.analyzed[(catalog, table)]
        stats = conn.metadata().get_table_statistics(table)
        # connector-stored ANALYZE results (histograms prove provenance)
        # count as serves too; bare row-count fallbacks count as misses
        if any(
            c.histogram is not None or c.distinct_count is not None
            for c in stats.columns.values()
        ):
            counter("trino_tpu_stats_served_total").inc()
        else:
            counter("trino_tpu_stats_missed_total").inc()
        return stats

    def store_table_statistics(
        self, catalog: str, table: str, stats: TableStatistics
    ) -> int:
        """Route ANALYZE output to the connector's durable store when it
        has one, else to the session overlay; either way keyed by the
        data_version snapshotted here.  Returns that version."""
        conn = self.catalogs.get(catalog)
        version = conn.data_version(table)
        # merge over whatever is currently served so a column-subset
        # ANALYZE refines rather than erases the other columns' stats
        try:
            base = self.table_statistics(catalog, table)
            merged = dict(base.columns)
            merged.update(stats.columns)
            stats = TableStatistics(stats.row_count, merged)
        except Exception:
            pass
        try:
            conn.metadata().store_table_statistics(table, stats, version)
            self.analyzed.pop((catalog, table), None)
        except NotImplementedError:
            self.analyzed[(catalog, table)] = (version, stats)
        return version
