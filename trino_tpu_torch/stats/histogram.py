"""Equi-height histograms and the selectivity math over them.

Reference parity: io.trino.cost.FilterStatsCalculator estimating range
predicates against a StatisticRange; we additionally carry an explicit
equi-height histogram (buckets of equal row fraction between quantile
boundaries) because the quantiles fall out of the same device sort the
ANALYZE aggregation already runs (approx_percentile over the KMV
sample), so per-bucket interpolation is free.

A histogram is a tuple of ``(low, high, fraction)`` buckets ordered by
``low``, fractions summing to ~1.0 over the non-null rows.  Plain
tuples keep ``ColumnStatistics`` hashable and trivially
JSON-serializable for the hive sidecar.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

Bucket = Tuple[float, float, float]
Histogram = Tuple[Bucket, ...]


def equi_height_from_quantiles(qs: Sequence[float]) -> Histogram:
    """Build an equi-height histogram from b+1 quantile boundaries.

    Each adjacent boundary pair becomes a bucket holding 1/b of the
    rows.  Repeated boundaries (heavy values spanning several
    quantiles) are merged into one fatter bucket so zero-width buckets
    only ever appear as genuine point masses.
    """
    qs = [float(q) for q in qs if q is not None]
    if len(qs) < 2:
        return ()
    b = len(qs) - 1
    frac = 1.0 / b
    buckets = []
    for lo, hi in zip(qs, qs[1:]):
        if buckets and buckets[-1][0] == lo and buckets[-1][1] == hi:
            prev = buckets[-1]
            buckets[-1] = (prev[0], prev[1], prev[2] + frac)
        else:
            buckets.append((lo, hi, frac))
    return tuple(buckets)


def le_fraction(hist: Histogram, v: float) -> Optional[float]:
    """Fraction of (non-null) rows with value <= v, by interpolation."""
    if not hist:
        return None
    total = 0.0
    acc = 0.0
    for lo, hi, frac in hist:
        total += frac
        if v >= hi:
            acc += frac
        elif v < lo:
            pass
        elif hi > lo:
            acc += frac * (v - lo) / (hi - lo)
        else:  # zero-width bucket: point mass at lo == hi
            acc += frac if v >= hi else 0.0
    if total <= 0.0:
        return None
    return min(1.0, max(0.0, acc / total))


def range_fraction(
    hist: Histogram,
    low: Optional[float],
    high: Optional[float],
) -> Optional[float]:
    """Fraction of rows in [low, high] (None = unbounded on that side)."""
    if not hist:
        return None
    hi_frac = le_fraction(hist, high) if high is not None else 1.0
    lo_frac = le_fraction(hist, low) if low is not None else 0.0
    if hi_frac is None or lo_frac is None:
        return None
    return min(1.0, max(0.0, hi_frac - lo_frac))
