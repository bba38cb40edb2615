"""ANALYZE synthesis: statistics collection as ordinary SQL.

Counterpart of trino_tpu/stats/analyze.py (copied; pure Python).
Reference parity: sql/rewrite/StatementRewrite turning ANALYZE into a
statistics-aggregation plan (QueryPlanner.planStatisticsAggregation):
the collection query is an aggregation through the normal planner and
executor, so its reductions (count / min / max / approx_distinct /
approx_percentile) run on the device like any query.

Per rangeable (numeric/date/timestamp) column c, one chunk query
contributes::

    count(c), approx_distinct(c),
    min(CAST(c AS DOUBLE)), max(CAST(c AS DOUBLE)),
    approx_percentile(CAST(c AS DOUBLE), j/b)  for j = 0..b

and ``assemble`` folds the single result row of each chunk into a
``TableStatistics`` (NDV clamped to the non-null count, quantile ends
clamped to the exact min/max, equi-height histogram from the
boundaries).  Non-rangeable columns (varchar, boolean, ...) get
count / NDV / null-fraction only.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from .. import types as T
from ..spi import ColumnStatistics, TableSchema, TableStatistics
from .histogram import equi_height_from_quantiles

# columns per synthesized query; bounds the width of any one fragment
# (a b-bucket rangeable column contributes b+5 aggregates)
CHUNK_COLUMNS = 4


@dataclasses.dataclass(frozen=True)
class ColumnTask:
    """One column's slice of the collection plan."""

    name: str
    type_name: str
    rangeable: bool  # castable to DOUBLE with a meaningful order

    def expressions(self, buckets: int) -> List[str]:
        q = self.name
        exprs = [f"count({q})", f"approx_distinct({q})"]
        if self.rangeable:
            cast = f"CAST({q} AS DOUBLE)"
            exprs += [f"min({cast})", f"max({cast})"]
            exprs += [
                f"approx_percentile({cast}, {j / buckets!r})"
                for j in range(buckets + 1)
            ]
        return exprs


def _rangeable(t: T.Type) -> bool:
    return T.is_numeric(t) or t.name in ("date", "timestamp")


def column_tasks(
    schema: TableSchema, columns: Sequence[str] = ()
) -> List[ColumnTask]:
    """Tasks for the requested columns (all, when none named)."""
    known = {c.name for c in schema.columns}
    for name in columns:
        if name not in known:
            raise KeyError(
                f"Column '{name}' does not exist in table '{schema.name}'"
            )
    want = set(columns) if columns else known
    return [
        ColumnTask(c.name, c.type.name, _rangeable(c.type))
        for c in schema.columns
        if c.name in want
    ]


def analyze_queries(
    qualified: str,
    tasks: Sequence[ColumnTask],
    buckets: int,
) -> List[Tuple[str, Tuple[ColumnTask, ...]]]:
    """Chunked collection SQL: [(sql, tasks_in_chunk), ...].

    Every chunk leads with count(*) so each query is self-contained
    (and an empty table short-circuits identically in all of them).
    """
    out = []
    chunks = [
        tuple(tasks[i:i + CHUNK_COLUMNS])
        for i in range(0, len(tasks), CHUNK_COLUMNS)
    ] or [()]
    for chunk in chunks:
        exprs = ["count(*)"]
        for t in chunk:
            exprs.extend(t.expressions(buckets))
        sql = f"SELECT {', '.join(exprs)} FROM {qualified}"
        out.append((sql, chunk))
    return out


def _as_float(v) -> Optional[float]:
    return None if v is None else float(v)


def assemble(
    chunk_results: Sequence[Tuple[Tuple[ColumnTask, ...], Sequence]],
    buckets: int,
) -> TableStatistics:
    """Fold each chunk's single result row into TableStatistics."""
    row_count = 0.0
    columns = {}
    for tasks, row in chunk_results:
        vals = list(row)
        row_count = float(vals[0] or 0)
        pos = 1
        for t in tasks:
            nonnull = float(vals[pos] or 0)
            ndv = float(vals[pos + 1] or 0)
            pos += 2
            lo = hi = None
            hist = None
            if t.rangeable:
                lo = _as_float(vals[pos])
                hi = _as_float(vals[pos + 1])
                qs = [_as_float(v) for v in vals[pos + 2:pos + 3 + buckets]]
                pos += 2 + buckets + 1
                if lo is not None and hi is not None and None not in qs:
                    # KMV quantiles are approximate; the aggregation also
                    # carried the exact extremes, so pin the ends to them
                    qs = [min(max(q, lo), hi) for q in qs]
                    qs[0], qs[-1] = lo, hi
                    hist = equi_height_from_quantiles(qs) or None
            if row_count <= 0:
                columns[t.name] = ColumnStatistics(0.0, 0.0, None, None)
                continue
            columns[t.name] = ColumnStatistics(
                distinct_count=min(ndv, nonnull),
                null_fraction=min(1.0, max(0.0, 1.0 - nonnull / row_count)),
                min_value=lo,
                max_value=hi,
                histogram=hist,
            )
    return TableStatistics(row_count=row_count, columns=columns)
