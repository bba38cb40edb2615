"""End-to-end statistics over every request of a window.

Every request sent inside the window counts, also one answered after its
close, which is waited for.  A rate is the count of those answered over
the seconds from the window's start to the last answer: all the work
and all the time it took (a count of a few dozen long requests inside a
fixed span would move in steps of several percent).  A percentile is
taken over the latency of every answered request, by Python's
`statistics.quantiles` ("exclusive" method).  A failed request is
counted, never timed."""
from __future__ import annotations

import statistics
from typing import List, Optional, Sequence


def percentile(values: Sequence[float], p: int) -> Optional[float]:
    """The p-th percentile (1 <= p <= 99) of all values; None under 2."""
    vals = sorted(values)
    if len(vals) < 2:
        return None
    return statistics.quantiles(vals, n=100)[p - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median: the spread the benchmark's bounds are set from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


class Window:
    """The requests of one measured window (closed loop)."""

    def __init__(self, start: float, seconds: float):
        self.start = start
        self.seconds = float(seconds)
        self.end = start + self.seconds
        self.requests: List[dict] = []

    def answered(self) -> List[dict]:
        return [r for r in self.requests if r["ok"]]

    def span(self) -> float:
        """Seconds from the window's start to its last answer."""
        return max([self.seconds] + [r["done"] - self.start for r in self.requests])

    def failed(self) -> int:
        return sum(1 for r in self.requests if not r["ok"])
