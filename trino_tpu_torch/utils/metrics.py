"""Process-global metrics registry.

Counterpart of trino_tpu/utils/metrics.py: the same three instrument
kinds under the same ``trino_tpu_*`` names and labels, so both packages'
``system.runtime.metrics`` rows carry the same series:

- ``Counter``   — monotonically increasing totals (``_total`` / ``_bytes``)
- ``Gauge``     — point-in-time values that can go up and down
- ``Histogram`` — fixed-bucket latency distributions (``_seconds``) with
  p50/p95/p99 estimated by linear interpolation inside the bucket

All instruments accept optional labels on observation, so one metric
family (e.g. ``trino_tpu_cache_op_total``) fans out into per-label
series (``{tier="result",op="hit"}``).  The module-level ``REGISTRY`` is
process-global.  Metric names must match ``trino_tpu_<subsystem>_<name>``
and end in ``_total``, ``_bytes``, ``_seconds`` or ``_state``, enforced
at registration.  ``render_prometheus`` gives the Prometheus text
exposition that the HTTP ``/metrics`` endpoints serve.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

METRIC_SUBSYSTEMS = (
    "query",
    "scheduler",
    "exchange",
    "spool",
    "cache",
    "fault",
    "task",
    "kernel",
    "event",
    "memory",
    "stats",
    "device",
    "straggler",
    "node",
    "journal",
    "doctor",
    "resource_group",
    "autoscaler",
    "compile",
    "coordinator",
    "signature",
    "slo",
    "objstore",
    "lake",
    "host",
)

METRIC_NAME_RE = re.compile(
    r"^trino_tpu_(%s)(_[a-z0-9]+)*_(total|bytes|seconds|state)$"
    % "|".join(METRIC_SUBSYSTEMS)
)

# Byte-volume buckets (64 KiB .. 16 GiB, x4 steps) for ``_bytes``
# histograms such as the bandwidth ledger's per-dispatch byte volume.
BYTES_BUCKETS = tuple(float(1 << s) for s in range(16, 35, 2))

# Latency buckets in seconds; tuned for sub-millisecond kernels up to
# multi-second distributed queries.
DEFAULT_BUCKETS = (
    0.001,
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
    30.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_labels(key: LabelKey, extra: str = "") -> str:
    parts = ['%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"')) for k, v in key]
    if extra:
        parts.append(extra)
    if not parts:
        return ""
    return "{%s}" % ",".join(parts)


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonic counter, optionally labelled."""

    kind = "counter"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if value < 0:
            raise ValueError("counter cannot decrease")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def series(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())

    def render(self) -> List[str]:
        lines = ["# HELP %s %s" % (self.name, self.help), "# TYPE %s counter" % self.name]
        series = self.series() or [((), 0.0)]
        for key, v in series:
            lines.append("%s%s %s" % (self.name, _format_labels(key), _fmt_value(v)))
        return lines


class Gauge:
    """Point-in-time value; supports set/inc/dec."""

    kind = "gauge"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._values: Dict[LabelKey, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels: str) -> None:
        self.inc(-value, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def series(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._values.items())

    def render(self) -> List[str]:
        lines = ["# HELP %s %s" % (self.name, self.help), "# TYPE %s gauge" % self.name]
        series = self.series() or [((), 0.0)]
        for key, v in series:
            lines.append("%s%s %s" % (self.name, _format_labels(key), _fmt_value(v)))
        return lines


class Histogram:
    """Fixed-bucket histogram with cumulative Prometheus buckets.

    Quantiles are estimated per the classic ``histogram_quantile``
    approach: find the bucket the target rank lands in and linearly
    interpolate between its bounds.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._totals: Dict[LabelKey, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = [0] * (len(self.buckets) + 1)
                self._counts[key] = counts
            idx = len(self.buckets)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    idx = i
                    break
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + float(value)
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, **labels: str) -> int:
        with self._lock:
            return self._totals.get(_label_key(labels), 0)

    def sum(self, **labels: str) -> float:
        with self._lock:
            return self._sums.get(_label_key(labels), 0.0)

    def quantile(self, q: float, **labels: str) -> float:
        """Estimate the q-quantile (0 < q <= 1) across one label series."""
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.get(key)
            total = self._totals.get(key, 0)
            if not counts or total == 0:
                return 0.0
            rank = q * total
            seen = 0.0
            for i, c in enumerate(counts):
                if c == 0:
                    continue
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
                if seen + c >= rank:
                    frac = (rank - seen) / c
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                seen += c
            return self.buckets[-1]

    def series(self) -> List[Tuple[LabelKey, List[int], float, int]]:
        with self._lock:
            return [
                (key, list(self._counts[key]), self._sums.get(key, 0.0), self._totals.get(key, 0))
                for key in sorted(self._counts)
            ]

    def render(self) -> List[str]:
        lines = ["# HELP %s %s" % (self.name, self.help), "# TYPE %s histogram" % self.name]
        series = self.series()
        if not series:
            series = [((), [0] * (len(self.buckets) + 1), 0.0, 0)]
        for key, counts, total_sum, total in series:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[i]
                lines.append(
                    "%s_bucket%s %d"
                    % (self.name, _format_labels(key, 'le="%s"' % _fmt_value(b)), cum)
                )
            lines.append(
                "%s_bucket%s %d" % (self.name, _format_labels(key, 'le="+Inf"'), total)
            )
            lines.append("%s_sum%s %s" % (self.name, _format_labels(key), _fmt_value(total_sum)))
            lines.append("%s_count%s %d" % (self.name, _format_labels(key), total))
        return lines


class MetricsRegistry:
    """Get-or-create home for all instruments in the process."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.RLock()

    def _get_or_create(self, name: str, factory):
        # the name is checked when its instrument is made: the hot paths
        # (a cache lookup, a launch) find theirs without the pattern match
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                if not METRIC_NAME_RE.match(name):
                    raise ValueError(
                        "metric name %r violates trino_tpu_<subsystem>_<name>"
                        "{_total|_bytes|_seconds|_state} convention" % name
                    )
                m = factory()
                self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._get_or_create(name, lambda: Counter(name, help))
        if not isinstance(m, Counter):
            raise TypeError("metric %r already registered as %s" % (name, m.kind))
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._get_or_create(name, lambda: Gauge(name, help))
        if not isinstance(m, Gauge):
            raise TypeError("metric %r already registered as %s" % (name, m.kind))
        return m

    def histogram(
        self, name: str, help: str = "", buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        m = self._get_or_create(name, lambda: Histogram(name, help, buckets))
        if not isinstance(m, Histogram):
            raise TypeError("metric %r already registered as %s" % (name, m.kind))
        return m

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[object]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def render_prometheus(self) -> str:
        lines: List[str] = []
        for m in self.metrics():
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, float]:
        """Flat ``name{labels} -> value`` map for bench artifacts."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            if isinstance(m, (Counter, Gauge)):
                for key, v in m.series():
                    out[m.name + _format_labels(key)] = v
            elif isinstance(m, Histogram):
                for key, _counts, total_sum, total in m.series():
                    out[m.name + "_count" + _format_labels(key)] = total
                    out[m.name + "_sum" + _format_labels(key)] = total_sum
        return out

    def rows(self) -> Dict[str, List]:
        """Column-oriented rows for the ``system.runtime.metrics`` table."""
        names: List[str] = []
        kinds: List[str] = []
        labels: List[str] = []
        values: List[float] = []
        p50s: List[Optional[float]] = []
        p95s: List[Optional[float]] = []
        p99s: List[Optional[float]] = []
        for m in self.metrics():
            if isinstance(m, (Counter, Gauge)):
                for key, v in m.series():
                    names.append(m.name)
                    kinds.append(m.kind)
                    labels.append(_format_labels(key))
                    values.append(float(v))
                    p50s.append(None)
                    p95s.append(None)
                    p99s.append(None)
            elif isinstance(m, Histogram):
                for key, _counts, _sum, total in m.series():
                    lbl = dict(key)
                    names.append(m.name)
                    kinds.append(m.kind)
                    labels.append(_format_labels(key))
                    values.append(float(total))
                    p50s.append(m.quantile(0.50, **lbl))
                    p95s.append(m.quantile(0.95, **lbl))
                    p99s.append(m.quantile(0.99, **lbl))
        return {
            "name": names,
            "kind": kinds,
            "labels": labels,
            "value": values,
            "p50": p50s,
            "p95": p95s,
            "p99": p99s,
        }

    def reset(self) -> None:
        """Drop all instruments (test isolation only)."""
        with self._lock:
            self._metrics.clear()


REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", buckets: Optional[Sequence[float]] = None) -> Histogram:
    return REGISTRY.histogram(name, help, buckets)


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()
