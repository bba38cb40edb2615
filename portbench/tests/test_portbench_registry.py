"""A configuration, a traffic mix, a query template and a per-layer
metric are each added as a new file plus a new BENCHMARK.json entry,
without an edit to any file already there, and a run finds them."""
import json
import os
import shutil

import pytest

from portbench.core.spec import Spec

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


@pytest.fixture
def tree(tmp_path):
    """A copy of the checkout's benchmark, to add files to."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = {p: (pkg / p).read_bytes() for p in _files(pkg)}
    yield tmp_path, pkg
    for p, b in before.items():
        assert (pkg / p).read_bytes() == b, f"{p} was edited"


def _files(pkg):
    return [os.path.relpath(os.path.join(d, f), pkg) for d, _, fs in os.walk(pkg) for f in fs]


def test_new_files_and_entries_make_a_new_cell(tree):
    from portbench.run import execute

    root, pkg = tree
    cfg = json.loads((pkg / "configs" / "tpch-sf30-node.json").read_text())
    cfg.update(name="tpch-tiny-node", scale_factor=0.01)
    (pkg / "configs" / "tpch-tiny-node.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "q1q6.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "order": ["q1", "q6cheap"]}))
    q6 = json.loads((pkg / "queries" / "q6.json").read_text())
    q6.update(name="q6cheap")
    (pkg / "queries" / "q6cheap.json").write_text(json.dumps(q6))
    (pkg / "metrics" / "answers_per_query.py").write_text(
        "def read(record):\n    return record['answered'] / record['queries']\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tpch-tiny-node", "source": "a test", "reduced": [],
                           "file": "portbench/configs/tpch-tiny-node.json", "why": "a test"})
    doc["workloads"].append({"name": "tiny-q1q6", "config": "tpch-tiny-node",
                             "traffic": "q1q6", "chips": 1, "why": "a test"})
    next(m for m in doc["end_to_end"] if m["name"] == "qps")["workloads"].append("tiny-q1q6")
    doc["per_layer"].append({"name": "answers_per_query", "unit": "1", "better": "higher",
                             "source": "host_clock", "layer": "client", "moves": "qps",
                             "workloads": ["tiny-q1q6"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))

    spec = Spec.load(str(root), str(pkg))
    assert [m["name"] for m in spec.per_layer("tiny-q1q6")] == ["answers_per_query"]
    assert [m["name"] for m in spec.per_layer("node-power")] == [
        m["name"] for m in Spec.load().per_layer("node-power")]
    res = execute("tiny-q1q6", 3, 2.0, 1, device="cpu", spec=spec)
    assert res["correct"] and res["attempted"] >= 1
    assert res["metrics"] == {"answers_per_query": {"value": 1.0, "unit": "1"}}
    res = execute("tiny-q1q6", 3, 1.0, 0, device="cpu", spec=spec)
    assert set(res["metrics"]) == {"qps", "setup_s"}


def test_names_that_leave_their_folder_are_refused(tree):
    root, pkg = tree
    spec = Spec.load(str(root), str(pkg))
    for bad in ("../run", "a/b", ".hidden", ""):
        with pytest.raises(ValueError):
            spec.traffic(bad)

