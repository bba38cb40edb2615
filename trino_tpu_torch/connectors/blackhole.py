"""Blackhole connector: null source for perf tests.

Counterpart of trino_tpu/connectors/blackhole.py (copied).

Reference parity: plugin/trino-blackhole — tables produce a configurable
number of synthetic rows (and swallow writes); used to benchmark operator
paths without real IO.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .. import types as T
from ..page import Column, Page
from ..spi import (
    ColumnSchema,
    Connector,
    ConnectorFactory,
    ConnectorMetadata,
    PageSource,
    PageSourceProvider,
    Split,
    SplitManager,
    TableSchema,
    TableStatistics,
)


class BlackholeConnector(Connector):
    def __init__(self, name: str, config: dict):
        self.name = name
        self.rows = int(config.get("blackhole.rows-per-table", 1000))
        self._schemas: Dict[str, TableSchema] = {
            "numbers": TableSchema(
                "numbers",
                (
                    ColumnSchema("n", T.BIGINT),
                    ColumnSchema("v", T.DOUBLE),
                ),
            )
        }

    def metadata(self):
        conn = self

        class MD(ConnectorMetadata):
            def list_tables(self):
                return list(conn._schemas)

            def get_table_schema(self, table):
                return conn._schemas[table]

            def get_table_statistics(self, table):
                return TableStatistics(float(conn.rows), {})

        return MD()

    def split_manager(self):
        conn = self

        class SM(SplitManager):
            def get_splits(self, table, desired, constraint=None):
                k = max(1, desired)
                return [Split(table, i, k) for i in range(k)]

        return SM()

    def page_source_provider(self):
        conn = self

        class PSP(PageSourceProvider):
            def create_page_source(self, split, columns):
                return _Source(conn, split, columns)

        return PSP()


class _Source(PageSource):
    def __init__(self, conn: BlackholeConnector, split: Split, columns):
        self.conn = conn
        self.split = split
        self.columns = list(columns)

    def pages(self):
        lo = self.conn.rows * self.split.ordinal // self.split.total
        hi = self.conn.rows * (self.split.ordinal + 1) // self.split.total
        n = hi - lo
        idx = np.arange(lo, hi, dtype=np.int64)
        cols = []
        for c in self.columns:
            if c == "n":
                cols.append(Column(T.BIGINT, idx))
            else:
                cols.append(Column(T.DOUBLE, (idx * 0.5).astype(np.float64)))
        yield Page(cols, n, self.columns)


class BlackholeConnectorFactory(ConnectorFactory):
    name = "blackhole"

    def create(self, catalog_name: str, config: dict) -> BlackholeConnector:
        return BlackholeConnector(catalog_name, config)
