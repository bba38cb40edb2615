"""A run driven end to end on the CPU at SF 0.01 (the look for a card
skipped), its correct verdict, the control and the faults it must catch,
and the command's refusals.  `cuda` tests run the command on a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.run import execute

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
TINY = {"scale_factor": 0.01}


def _run(seconds=2.0, trace=0, control=None, seed=11):
    return execute("node-power", seed, seconds, trace, device="cpu", overrides=TINY,
                   control=control)


def test_a_sound_run_is_correct_and_reports_its_metrics():
    res = _run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"qps", "setup_s"}
    assert list(res)[-1] == "checks"
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())
    traced = _run(trace=1, seed=12)
    assert traced["correct"]
    assert {"plan_ms_per_query", "latency_p50_ms.node", "latency_p95_ms.node"} <= set(
        traced["metrics"])


def test_a_query_off_the_in_memory_path_is_not_correct():
    """The configuration states that every query stays in memory: with a
    limit that makes the node stream, its answers are right and the run
    is not correct."""
    res = execute("node-power", 15, 2.0, 0, device="cpu", overrides=dict(
        TINY, session={"result_cache": False, "query_max_memory_bytes": 200_000}))
    assert res["checks"]["left_memory_path"]["value"] > 0
    assert res["checks"]["wrong_answers"]["value"] == 0 and not res["correct"]


def test_the_control_comes_out_not_correct():
    """float32 here; the float64 control, which only Q1's sums at the
    cell's own size show, runs on the card (below)."""
    res = _run(control="float32", seed=13)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] == res["attempted"]
    assert res["checks"]["widest_gap_units"]["value"] > 0


def _answer_altered(monkeypatch):
    """The aggregate's answer altered where it is produced: one unit more
    in the first output lane of every final aggregation."""
    from trino_tpu_torch.ops import aggregation

    real = aggregation.finalize

    def finalize(specs, accs, *a, **kw):
        out = real(specs, accs, *a, **kw)
        name = next(iter(out))
        v, ok = out[name]
        return dict(out, **{name: (v + 1, ok)})

    monkeypatch.setattr(aggregation, "finalize", finalize)


def _half_the_rows(monkeypatch):
    """Half of the batch left out: every other generated row is marked
    NULL, so the sums and means are taken over the rest."""
    from trino_tpu_torch.connectors import tpch_device

    real = tpch_device.device_lanes

    def device_lanes(*a, **kw):
        out = real(*a, **kw)
        return {c: (v, ok.clone().index_fill_(0, ok.new_tensor(
            range(1, ok.shape[0], 2), dtype=__import__("torch").int64), False))
            for c, (v, ok) in out.items()}

    monkeypatch.setattr(tpch_device, "device_lanes", device_lanes)


def _stale_answer(monkeypatch):
    """A step that returns its state unchanged: each query answers with the
    first page its template gave."""
    from trino_tpu_torch.session import Session

    real = Session._execute_statement
    seen = {}

    def stale(self, stmt, sql, *a, **kw):
        page = real(self, stmt, sql, *a, **kw)
        return seen.setdefault(sql.split(" where ")[0], page)

    monkeypatch.setattr(Session, "_execute_statement", stale)


@pytest.mark.parametrize("fault", [_answer_altered, _half_the_rows, _stale_answer],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_comes_out_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _run(seed=14)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_without_a_card_the_command_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "node-power",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_in_a_directory_of_only_the_benchmark_the_command_fails(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "node-power",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_the_command_on_a_card(card):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "node-power",
                          "--seed", "2026", "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"qps", "setup_s"}


@pytest.mark.cuda
def test_the_float64_control_on_a_card_is_not_correct(card):
    """At the cell's own size (SF 30) Q1's DOUBLE sums, cast back to their
    scale, miss the exact answer by many units of the last digit."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "node-power",
                          "--seed", "2027", "--seconds", "10", "--trace", "0",
                          "--control", "float64"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert not res["correct"] and res["checks"]["widest_gap_units"]["value"] > 1
