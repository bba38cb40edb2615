"""Table & column statistics: ANALYZE's collection SQL and assembly
(analyze.py) and the equi-height histograms the cost model reads
(histogram.py).  Counterpart of trino_tpu/stats/."""
from .analyze import ColumnTask, analyze_queries, assemble, column_tasks
from .histogram import (
    equi_height_from_quantiles,
    le_fraction,
    range_fraction,
)

__all__ = [
    "ColumnTask",
    "analyze_queries",
    "assemble",
    "column_tasks",
    "equi_height_from_quantiles",
    "le_fraction",
    "range_fraction",
]
