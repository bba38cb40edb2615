"""Rates and percentiles are taken over every query of a window."""
import statistics

import pytest

from portbench.core import stats
from portbench.core.spec import Spec


def _window(latencies, ok=None, start=100.0, seconds=10.0):
    w = stats.Window(start, seconds)
    t = start
    for i, lat in enumerate(latencies):
        w.requests.append({"sent": t, "done": t + lat / 1e3,
                           "ok": True if ok is None else ok[i]})
        t += lat / 1e3
    return w


def _record(w):
    return {"answered": len(w.answered()), "span_s": w.span(), "queries": len(w.requests),
            "requests": [{"template": "q", "ok": r["ok"],
                          "latency_ms": (r["done"] - r["sent"]) * 1e3} for r in w.requests]}


def test_percentile_is_over_all_values():
    vals = list(range(1, 1001))
    assert stats.percentile(vals, 50) == statistics.quantiles(vals, n=100)[49]
    assert stats.percentile(vals, 95) == pytest.approx(950.95)
    # not a median of chunk medians
    chunks = [vals[i:i + 100] for i in range(0, 1000, 100)]
    assert stats.percentile(vals, 95) != statistics.median(
        statistics.quantiles(c, n=100)[94] for c in chunks)
    assert stats.percentile([3.0], 50) is None


def test_rate_counts_every_answer_until_the_last():
    # 11 queries of 1 s each: the last is sent at 10 s, before the window
    # of 10.5 s closes, and answered at 11 s
    w = _window([1000.0] * 11, seconds=10.5)
    spec = Spec.load()
    assert spec.metric_reader("qps").read(_record(w)) == pytest.approx(11 / 11.0)


def test_failed_queries_are_counted_not_timed():
    w = _window([100.0, 5000.0, 100.0, 100.0], ok=[True, False, True, True], seconds=1.0)
    rec = _record(w)
    spec = Spec.load()
    assert w.failed() == 1
    assert spec.metric_reader("qps").read(rec) == pytest.approx(3 / 5.3)
    assert spec.metric_reader("latency_p95_ms.node").read(rec) == pytest.approx(100.0)
    assert spec.metric_reader("latency_p50_ms.node").read(rec) == pytest.approx(100.0)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)
