"""In-memory table connector.

Counterpart of trino_tpu/connectors/memory.py (plugin/trino-memory:
MemoryConnector, MemoryMetadata, MemoryPagesStore): tables held as host
numpy columns, a scriptable data source for tests and the target of
CREATE TABLE [AS] / INSERT / DELETE / UPDATE / MERGE through the
PageSink SPI; rows can also be loaded with the Python API
(create_table).

The page sink stores what the JAX package's sink stores — every row's
Python value re-encoded with column_from_pylist — but computes it column
by column with numpy (varchar dictionaries unified in first-appearance
order, NULL slots zeroed), so a write of millions of rows takes seconds.
Array, map and wide-decimal columns take the row-by-row path.
"""
from __future__ import annotations

from collections import OrderedDict
from decimal import ROUND_HALF_UP, Decimal
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as T
from ..page import Column, Page, column_from_pylist
from ..spi import (
    ColumnSchema,
    Connector,
    ConnectorFactory,
    ConnectorMetadata,
    PageSink,
    PageSinkProvider,
    PageSource,
    PageSourceProvider,
    Split,
    SplitManager,
    TableSchema,
    TableStatistics,
)


class _Store:
    def __init__(self):
        self.tables: Dict[str, Page] = {}
        self.schemas: Dict[str, TableSchema] = {}
        self.version = 0  # bumped on every write (scan-cache invalidation)
        # per-table change counters (Connector.data_version(table)): an
        # INSERT into A must not invalidate cached scans of B
        self.versions: Dict[str, int] = {}
        # ANALYZE results keyed by the data_version they were collected
        # at; served only while the table hasn't been written since
        self.stats: Dict[str, Tuple[int, TableStatistics]] = {}
        # the sink's reading of a written column's dictionary (_distinct),
        # by dictionary object: a varchar column whose dictionary holds
        # one entry per row (TPC-H's o_clerk) is read once per source
        self.distinct: "OrderedDict[int, tuple]" = OrderedDict()

    def bump(self, table: str) -> None:
        self.version += 1
        self.versions[table] = self.versions.get(table, 0) + 1


class MemoryMetadata(ConnectorMetadata):
    def __init__(self, store: _Store):
        self.store = store

    def list_tables(self) -> List[str]:
        return list(self.store.tables)

    def get_table_schema(self, table: str) -> TableSchema:
        return self.store.schemas[table]

    def get_table_statistics(self, table: str) -> TableStatistics:
        entry = self.store.stats.get(table)
        if entry is not None:
            version, stats = entry
            if version == self.store.versions.get(table, 0):
                return stats
            del self.store.stats[table]  # DML since ANALYZE: stale
        page = self.store.tables[table]
        return TableStatistics(float(page.count), {})

    def store_table_statistics(
        self, table: str, stats: TableStatistics, data_version: int
    ) -> None:
        if table not in self.store.tables:
            raise KeyError(f"table {table} does not exist")
        self.store.stats[table] = (int(data_version), stats)

    # -- writes (MemoryMetadata.beginCreateTable/beginInsert analog) ----
    def create_table(self, schema: TableSchema) -> None:
        if schema.name in self.store.tables:
            raise ValueError(f"table {schema.name} already exists")
        self.store.bump(schema.name)
        cols = [column_from_pylist(c.type, []) for c in schema.columns]
        self.store.tables[schema.name] = Page(
            cols, 0, [c.name for c in schema.columns]
        )
        self.store.schemas[schema.name] = schema

    def drop_table(self, table: str) -> None:
        if table not in self.store.tables:
            raise KeyError(f"table {table} does not exist")
        self.store.bump(table)
        del self.store.tables[table]
        del self.store.schemas[table]


class MemorySplitManager(SplitManager):
    def __init__(self, store: _Store):
        self.store = store

    def get_splits(self, table: str, desired: int, constraint=None) -> List[Split]:
        return [Split(table, 0, 1)]


class MemoryPageSource(PageSource):
    def __init__(self, store: _Store, split: Split, columns: Sequence[str]):
        self.store = store
        self.split = split
        self.columns = list(columns)

    def pages(self):
        page = self.store.tables[self.split.table]
        cols = [page.by_name(c) for c in self.columns]
        yield Page(cols, page.count, self.columns)

    def dictionaries(self) -> Dict[str, np.ndarray]:
        page = self.store.tables[self.split.table]
        out = {}
        for c in self.columns:
            col = page.by_name(c)
            if col.dictionary is not None:
                out[c] = col.dictionary
        return out


class MemoryPageSourceProvider(PageSourceProvider):
    def __init__(self, store: _Store):
        self.store = store

    def create_page_source(self, split: Split, columns) -> MemoryPageSource:
        return MemoryPageSource(self.store, split, columns)


# a decimal with fewer significant digits survives the sink's round trip
# through a float64 (its shortest repr is the decimal itself)
_EXACT_DECIMAL = 10**15

# (column or None for a column the write leaves out, row count)
Piece = Tuple[Optional[Column], int]


def _valid(col: Column, n: int) -> np.ndarray:
    if col.validity is None:
        return np.ones(n, dtype=bool)
    return np.asarray(col.validity)[:n].astype(bool)


def _rows_path(typ: T.Type, pieces: Sequence[Piece]) -> Column:
    """The row-by-row re-encoding (the JAX package's sink)."""
    data: list = []
    for col, n in pieces:
        data.extend([None] * n if col is None else col.to_python(n))
    return column_from_pylist(typ, data)


def _first_appearance(u: np.ndarray, k: int) -> np.ndarray:
    """The distinct ids of `u` (each in [0, k)) in order of first
    occurrence.  Reads `u` in chunks that double in size and stops once
    every id present has been seen: a handful of values over millions of
    rows costs one short chunk, not a sort of them all."""
    present = np.zeros(k, dtype=bool)
    present[u] = True
    want = int(present.sum())
    seen = np.zeros(k, dtype=bool)
    found = 0
    out = []
    start, chunk = 0, 1 << 16
    while found < want:
        ids, at = np.unique(u[start:start + chunk], return_index=True)
        fresh = ~seen[ids]
        ids = ids[fresh][np.argsort(at[fresh], kind="stable")]
        seen[ids] = True
        found += len(ids)
        out.append(ids)
        start += chunk
        chunk *= 2
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


# the sink keeps its readings of the dictionaries with at least
# _DISTINCT_MIN entries (a smaller one is read again in milliseconds),
# the _DISTINCT_KEPT most recent
_DISTINCT_MIN = 1 << 16
_DISTINCT_KEPT = 8


def _distinct(d: np.ndarray, cache) -> Tuple[list, np.ndarray]:
    """A dictionary's distinct strings in entry order, and each entry's
    index among them; kept in `cache` (an OrderedDict, or None) by the
    dictionary object, which the entry holds so its id stays its own."""
    hit = cache.get(id(d)) if cache is not None else None
    if hit is not None and hit[0] is d:
        cache.move_to_end(id(d))
        return hit[1], hit[2]
    local: Dict[str, int] = {}
    ids = np.fromiter((local.setdefault(str(x), len(local)) for x in d),
                      dtype=np.int64, count=len(d))
    names = list(local)
    if cache is not None and len(d) >= _DISTINCT_MIN:
        cache[id(d)] = (d, names, ids)
        while len(cache) > _DISTINCT_KEPT:
            cache.popitem(last=False)
    return names, ids


def _dictionary_column(typ: T.Type, pieces: Sequence[Piece], cache=None) -> Column:
    """Varchar pieces -> one column whose dictionary lists the distinct
    strings in order of first appearance among the rows (a row whose
    code is negative reads as NULL), as column_from_pylist builds it."""
    index: Dict[str, int] = {}
    parts = []
    for col, n in pieces:
        u = np.full(n, -1, dtype=np.int64)
        if col is not None and n:
            codes = np.asarray(col.values)[:n].astype(np.int64)
            names, ids = _distinct(col.dictionary, cache)
            unified = np.array([index.setdefault(x, len(index)) for x in names],
                               dtype=np.int64)
            remap = unified[ids]
            live = _valid(col, n) & (codes >= 0)
            u[live] = remap[codes[live]]
        parts.append(u)
    u = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
    live = u >= 0
    ids = _first_appearance(u[live], len(index))
    new_code = np.full(len(index), -1, dtype=np.int64)
    new_code[ids] = np.arange(len(ids))
    codes = np.full(len(u), -1, dtype=np.int32)
    codes[live] = new_code[u[live]]
    dictionary = np.array(list(index), dtype=object)[ids]
    return Column(typ, codes, None if live.all() else live, dictionary)


def _decimal_round_trip(v: int, scale: int) -> int:
    """One unscaled decimal through the row path: a float of its value,
    then Decimal(str(float)) rescaled, rounded half up."""
    f = v / 10**scale
    return int((Decimal(str(f)) * 10**scale).to_integral_value(ROUND_HALF_UP))


def _value_column(typ: T.Type, pieces: Sequence[Piece]) -> Column:
    """Fixed-width pieces -> one column: NULL slots zeroed, values as the
    row path leaves them (the same bits, except decimals of 15 or more
    significant digits, which go through a float as the row path's do)."""
    dt = typ.np_dtype
    vals, oks = [], []
    for col, n in pieces:
        if col is None:
            vals.append(np.zeros(n, dtype=dt))
            oks.append(np.zeros(n, dtype=bool))
            continue
        ok = _valid(col, n)
        v = np.asarray(col.values)[:n].astype(dt)
        vals.append(np.where(ok, v, np.zeros((), dtype=dt)))
        oks.append(ok)
    v = np.concatenate(vals) if vals else np.zeros(0, dtype=dt)
    ok = np.concatenate(oks) if oks else np.zeros(0, dtype=bool)
    if typ.is_decimal and typ.scale:
        for i in np.flatnonzero(ok & ((v >= _EXACT_DECIMAL) | (v <= -_EXACT_DECIMAL))):
            v[i] = _decimal_round_trip(int(v[i]), typ.scale)
    return Column(typ, v, None if ok.all() else ok)


def rebuild_column(typ: T.Type, pieces: Sequence[Piece], cache=None) -> Column:
    """The stored column for the pieces a write leaves behind, equal to
    column_from_pylist over their rows' Python values (`cache`: the
    store's _distinct readings)."""
    if (getattr(typ, "is_array", False) or getattr(typ, "is_map", False)
            or getattr(typ, "wide", False) or typ.name == "unknown"):
        return _rows_path(typ, pieces)
    if typ.is_dictionary:
        return _dictionary_column(typ, pieces, cache)
    return _value_column(typ, pieces)


class MemoryPageSink(PageSink):
    """MemoryPagesStore.add analog: buffers the appended pages and
    rebuilds the stored columns at finish() (rebuild_column)."""

    def __init__(self, store: _Store, table: str, columns, overwrite: bool):
        self.store = store
        self.table = table
        self.columns = list(columns)
        self.overwrite = overwrite
        self.pages: List[Page] = []
        self.rows = 0

    def append(self, page: Page) -> None:
        self.pages.append(page)
        self.rows += page.count

    def finish(self) -> int:
        schema = self.store.schemas[self.table]
        old = self.store.tables[self.table]
        cols = []
        for c in schema.columns:
            pieces: List[Piece] = (
                [] if self.overwrite else [(old.by_name(c.name), old.count)]
            )
            if c.name in self.columns:
                pieces += [(p.by_name(c.name), p.count) for p in self.pages]
            else:
                pieces.append((None, self.rows))  # unmentioned -> NULL
            cols.append(rebuild_column(c.type, pieces, self.store.distinct))
        count = (0 if self.overwrite else old.count) + self.rows
        self.store.tables[self.table] = Page(
            cols, count, [c.name for c in schema.columns]
        )
        self.store.bump(self.table)
        return self.rows


class MemoryPageSinkProvider(PageSinkProvider):
    def __init__(self, store: _Store):
        self.store = store

    def create_sink(self, table: str, columns, overwrite: bool = False):
        if table not in self.store.tables:
            raise KeyError(f"table {table} does not exist")
        return MemoryPageSink(self.store, table, columns, overwrite)


class MemoryConnector(Connector):
    def __init__(self, name: str):
        self.name = name
        self.store = _Store()

    def data_version(self, table=None) -> int:
        if table is None:
            return self.store.version
        return self.store.versions.get(table, 0)

    def create_table(self, name: str, schema, data: dict):
        """schema: list of (col, Type); data: col -> python values."""
        self.store.bump(name)
        cols = [column_from_pylist(t, data[c]) for c, t in schema]
        counts = {len(c) for c in cols}
        if len(counts) != 1:
            raise ValueError("create_table: columns of different lengths")
        self.store.tables[name] = Page(cols, counts.pop(), [c for c, _ in schema])
        self.store.schemas[name] = TableSchema(
            name, tuple(ColumnSchema(c, t) for c, t in schema)
        )

    def metadata(self):
        return MemoryMetadata(self.store)

    def split_manager(self):
        return MemorySplitManager(self.store)

    def page_source_provider(self):
        return MemoryPageSourceProvider(self.store)

    def page_sink_provider(self):
        return MemoryPageSinkProvider(self.store)


class MemoryConnectorFactory(ConnectorFactory):
    name = "memory"

    def create(self, catalog_name: str, config: dict) -> MemoryConnector:
        return MemoryConnector(catalog_name)
