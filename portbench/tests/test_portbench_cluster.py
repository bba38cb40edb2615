"""The cluster cell, `cluster-power`, driven end to end on the CPU at a tiny
scale and memory limit, so that both workers stream their PARTIAL
fragments: its correct verdict, its four span readers, the control that
must fail it, and the files its entries name."""
import os

import pytest

from portbench.core.spec import Spec
from portbench.run import execute

CELL = "cluster-power"
READERS = ("stream_tiles_per_query", "exchange_ms_per_query", "serde_ms_per_query",
           "schedule_ms_per_query")


def _tiny(sf=0.01, limit=300_000):
    session = dict(Spec.load().config("tpch-sf10-cluster")["session"],
                   query_max_memory_bytes=limit)
    return {"scale_factor": sf, "session": session}


def _read(name, record):
    return Spec.load().metric_reader(name).read(record)


def _span(name, start, end, **attributes):
    return {"name": name, "start": start, "end": end, "attributes": attributes}


SPANS = [
    _span("query", 0.0, 3.0),
    _span("schedule", 0.0, 0.02, fragments=3, tasks=5),
    _span("stream_tile", 0.1, 0.4, fragment=1, tile=0, rows=10),
    _span("stream_tile", 0.4, 0.7, fragment=1, tile=1, rows=10),
    _span("stream_tile", 0.1, 0.6, fragment=1, tile=0, rows=12),
    _span("serde_encode", 0.7, 0.701, bytes=100, rows=4, pages=1),
    _span("exchange_fetch", 0.5, 0.8, bytes=100),
    _span("exchange_transfer", 0.78, 0.785, task="t1", bytes=100),
    _span("exchange_transfer", 0.79, 0.79, task="t1", bytes=0),
    _span("serde_decode", 0.79, 0.793, bytes=100, rows=4, pages=1),
    _span("schedule", 1.0, 1.03, fragments=2, tasks=3),
]


@pytest.mark.parametrize("name,want", [
    ("stream_tiles_per_query", 1.5),    # 3 tiles over 2 queries
    ("exchange_ms_per_query", 2.5),     # (5 + 0) ms over 2 queries: the wait left out
    ("serde_ms_per_query", 2.0),        # (1 + 3) ms over 2 queries
    ("schedule_ms_per_query", 25.0),    # (20 + 30) ms over 2 queries
])
def test_each_reader_on_a_synthetic_record(name, want):
    assert _read(name, {"spans": SPANS, "queries": 2}) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_spans_reads_nothing(name):
    """The spans of a program that predates them: the session's and the
    task's (a cluster's fetches read a number from any program)."""
    spans = [_span("query", 0.0, 10.0), _span("task", 0.1, 9.0)]
    assert _read(name, {"spans": spans, "queries": 3}) is None
    assert _read(name, {"spans": SPANS, "queries": 0}) is None


def test_a_sound_run_is_correct_and_a_traced_one_reads_the_server_path():
    res = execute(CELL, 3000000101, 2.0, 0, device="cpu", overrides=_tiny())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"qps", "setup_s"}
    assert all(v["value"] == 0 for v in res["checks"].values())
    traced = execute(CELL, 3000000102, 2.0, 1, device="cpu", overrides=_tiny())
    assert traced["correct"]
    assert set(traced["metrics"]) == set(READERS)
    assert traced["metrics"]["stream_tiles_per_query"]["value"] > 0
    for name in READERS[1:]:
        assert traced["metrics"][name]["value"] > 0 and traced["metrics"][name]["unit"] == "ms"


def test_the_float64_control_comes_out_not_correct():
    """At SF 0.2 Q1's sums pass 2**53 units of their last digit, so the
    reference computed in float64 and cast back misses them (at SF 0.01
    a DOUBLE is still exact); the window reaches Q1, the third query."""
    res = execute(CELL, 3000000103, 6.0, 0, device="cpu", overrides=_tiny(0.2, 6_000_000),
                  control="float64")
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0
    assert res["checks"]["widest_gap_units"]["value"] > 0


def test_the_cell_names_only_files_that_exist():
    spec = Spec.load()
    cell = spec.cell(CELL)
    entry = spec.config_entry(cell["config"])
    config = spec.config(cell["config"])
    assert os.path.isfile(os.path.join(spec.root, entry["file"]))
    assert os.path.isfile(os.path.join(spec.pkg, "deploy", config["deploy"] + ".py"))
    assert set(entry["reduced"]) <= set(config)
    traffic = spec.traffic(cell["traffic"])
    for name in traffic["order"]:
        assert os.path.isfile(os.path.join(spec.pkg, "reference",
                                           spec.query(name)["reference"] + ".py"))
    names = [m["name"] for m in spec.end_to_end(CELL) + spec.per_layer(CELL)]
    assert {"qps", "setup_s"} <= set(names) and set(READERS) <= set(names)
    for name in names:
        assert os.path.isfile(os.path.join(spec.pkg, "metrics", name + ".py")), name
    assert not set(READERS) & {m["name"] for m in spec.per_layer("node-power")}
