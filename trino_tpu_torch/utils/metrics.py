"""Process-global counters.

Counterpart of trino_tpu/utils/metrics.py, its counters only: the
statistics code counts ANALYZE runs and the table statistics it serves
or misses under the JAX package's names (``trino_tpu_stats_*_total``).
Gauges, histograms, labels, the Prometheus text rendering (the HTTP
``/metrics`` endpoint) and the ``system.runtime.metrics`` rows wait for
the server and the system connector, their first readers.
"""
from __future__ import annotations

import threading
from typing import Dict


class Counter:
    """Monotonic counter."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError("counter cannot decrease")
        with self._lock:
            self._value += value

    def value(self) -> float:
        with self._lock:
            return self._value


_COUNTERS: Dict[str, Counter] = {}
_LOCK = threading.Lock()


def counter(name: str) -> Counter:
    """The process's counter of that name, created on first use."""
    with _LOCK:
        c = _COUNTERS.get(name)
        if c is None:
            c = _COUNTERS[name] = Counter(name)
        return c
