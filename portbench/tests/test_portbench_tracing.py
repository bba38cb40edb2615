"""The readers of the program's spans: the scan cache's hit share, the
host's line count per query, the idle shares under the scan and operator
spans, and the retry ladder's re-runs per query.  Each is held to a
synthetic record, to a record of a program that opens none of its spans
(it reads nothing), and to a run on the CPU at SF 0.01."""
import json

import pytest

from portbench.core.spec import Spec
from portbench.run import execute

SPAN_READERS = ("scan_cache_hit_pct", "scan_count_ms_per_query", "plan_reruns_per_query")
IDLE_READERS = ("scan_idle_pct", "operator_idle_pct")


def _read(name, record):
    return Spec.load().metric_reader(name).read(record)


def _span(name, start, end, **attributes):
    return {"name": name, "start": start, "end": end, "attributes": attributes}


def _record(spans, idle_gaps=None, window_s=50.0, queries=4):
    rec = {"spans": spans, "queries": queries}
    if idle_gaps is not None:
        rec["device"] = {"window_s": window_s, "busy_s": 10.0, "idle_gaps": idle_gaps}
    return rec


SPANS = [
    _span("execute", 0.0, 10.0),
    _span("scan_load", 0.0, 2.0, table="lineitem", cache="miss", rows=100),
    _span("scan_count", 0.1, 1.9, orders_lo=0, orders_hi=25, rows=100),
    _span("scan_load", 2.0, 2.1, table="orders", cache="hit", rows=25),
    _span("scan_load", 2.1, 2.2, table="customer", cache="hit", rows=5),
    _span("scan_load", 2.2, 2.3, table="nation", cache="uncached", rows=25),
    _span("scan_load", 2.3, 3.0, table="lineitem", cache="miss", rows=100),
    _span("scan_count", 2.4, 2.9, orders_lo=0, orders_hi=25, rows=100),
    _span("plan_run", 3.0, 5.0, attempt=0, rerun="wide_mul"),
    _span("plan_run", 5.0, 6.0, attempt=1),
    _span("plan_run", 6.0, 7.0, attempt=0),
    _span("operator", 3.0, 4.0, op="Aggregate"),
]
GAPS = [["scan_count", 20.0], ["execute", 3.0], ["operator", 2.0], ["scan_generate", 1.5],
        ["launch", 0.5], ["scan_load", 0.25], ["outside any span", 0.1]]


@pytest.mark.parametrize("name,want", [
    ("scan_cache_hit_pct", 50.0),       # 2 hits, 2 misses; uncached left out
    ("scan_count_ms_per_query", 575.0),  # (1.8 + 0.5) s over 4 queries
    ("plan_reruns_per_query", 0.25),     # one attempt-1 run over 4 queries
    ("scan_idle_pct", 43.5),             # (20 + 1.5 + 0.25) s of a 50 s window
    ("operator_idle_pct", 5.0),          # (2 + 0.5) s of a 50 s window
])
def test_each_reader_on_a_synthetic_record(name, want):
    assert _read(name, _record(SPANS, GAPS)) == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_READERS + IDLE_READERS)
def test_a_program_without_the_spans_reads_nothing(name):
    """The spans of a program that predates them: only the session's."""
    spans = [_span("query", 0.0, 10.0), _span("parse", 0.0, 0.1),
             _span("execute", 0.2, 10.0)]
    assert _read(name, _record(spans, [["execute", 30.0]])) is None


@pytest.mark.parametrize("name", IDLE_READERS)
def test_the_idle_readers_need_a_device_trace(name):
    assert _read(name, _record(SPANS)) is None
    assert _read(name, dict(_record(SPANS), device=None)) is None


def test_a_name_off_the_top_ten_counts_as_nothing():
    """The trace keeps the ten names with the most idle time: a scan span
    that fell off the list adds nothing."""
    gaps = [["scan_count", 5.0]] + [[f"other{i}", 1.0] for i in range(9)]
    assert _read("scan_idle_pct", _record(SPANS, gaps)) == pytest.approx(10.0)


def test_a_window_without_a_cache_lookup_reads_no_hit_share():
    spans = [_span("scan_load", 0.0, 1.0, table="nation", cache="uncached", rows=25)]
    assert _read("scan_cache_hit_pct", _record(spans)) is None
    assert _read("scan_count_ms_per_query", _record(spans)) == 0.0


def _deployment_lines(err):
    """The deployment's own counters before and after the window, from
    the run's standard error."""
    line = next(ln for ln in err.splitlines()
                if ln.startswith("[run] deployment before the window"))
    before, after = line.split("before the window ", 1)[1].split(", after ")
    return json.loads(before), json.loads(after)


def test_a_cpu_run_reports_the_span_readers_and_not_the_idle_ones(capsys):
    res = execute("node-power", 21, 2.0, 1, device="cpu", overrides={"scale_factor": 0.01})
    assert res["correct"]
    got = res["metrics"]
    assert set(SPAN_READERS) <= set(got)
    assert not set(IDLE_READERS) & set(got)
    assert got["scan_cache_hit_pct"]["unit"] == "%"
    assert got["scan_count_ms_per_query"]["value"] >= 0.0
    assert got["plan_reruns_per_query"]["value"] >= 0.0
    # the spans' hit share is the deployment's own over the window
    before, after = _deployment_lines(capsys.readouterr().err)
    hits = after["scan_cache"]["hits"] - before["scan_cache"]["hits"]
    misses = after["scan_cache"]["misses"] - before["scan_cache"]["misses"]
    assert got["scan_cache_hit_pct"]["value"] == pytest.approx(100.0 * hits / (hits + misses))
