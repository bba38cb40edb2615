"""The benchmark of trino_tpu_torch, the PyTorch and CUDA port.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run brings up the cell's deployment, warms each of its query
templates once (the validation parameters' places in the seed's
shuffle of each parameter's domain, core/qgen.py), drives its
closed loop for `--seconds`, holds every answer of the window to the
plain reference, and prints one JSON line last on standard output:
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a profiled window.  The numbers compared for
`correct` are printed beside their limits, last on standard error and
last in the line.  Without a CUDA card (or with fewer than the cell
asks for) the run fails and prints no result.

Everything is found by name from BENCHMARK.json (see core/spec.py).
The kernels build into portbench/.cache/build of the checkout; only a
checkout's first run compiles.  `--control float64` (or float32) puts
the reference computed in that floating point, each answer cast back to
its column's scale, in the program's place, to show the comparison
fails it.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BUILD_DIR = os.path.join(PKG, ".cache", "build")
TRACER_SPANS = 1 << 20  # the program tracer's ring holds the whole window


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def execute(workload, seed, seconds, trace, device="cuda", overrides=None,
            control=None, spec=None):
    """One run; returns the result line's object.  `device` and
    `overrides` (keys of the configuration, such as a smaller scale)
    let a CPU test drive a run end to end."""
    import torch

    from portbench.core import check, guard, loop, qgen, stats
    from portbench.core import trace as T
    from portbench.core.spec import Spec, metric_entry
    from portbench.reference.tpchgen import TpchData

    spec = spec or Spec.load()
    cell = spec.cell(workload)
    config = dict(spec.config(cell["config"]), **(overrides or {}))
    traffic = spec.traffic(cell["traffic"])
    templates = {name: spec.query(name) for name in traffic["order"]}
    e2e = [m["name"] for m in spec.end_to_end(workload)]
    layer = [m["name"] for m in spec.per_layer(workload)]
    on_card = device == "cuda"

    built = set(os.listdir(BUILD_DIR)) if os.path.isdir(BUILD_DIR) else set()
    dep = spec.deploy(config["deploy"]).Deployment(config, BUILD_DIR, device)
    dep.start()
    clients = dep.clients(int(traffic["clients"]))
    values = qgen.Values(seed, templates)
    for name in sorted(templates):
        clients[0](qgen.render(templates[name], values.warm(name, templates[name])))
    if on_card:
        torch.cuda.synchronize()
    before = dep.info()
    new = sorted(set(os.listdir(BUILD_DIR)) - built) if os.path.isdir(BUILD_DIR) else []
    _log(f"[run] kernel libraries built in this run's set-up: {new or 'none'}")

    prof = calls = None
    if trace:
        tracer = dep.tracer()
        tracer.spans = collections.deque(maxlen=TRACER_SPANS)
        calls = T.KernelCalls(dep.kernels_module())
        calls.install()
        if on_card:
            prof = T.Profile().__enter__()
    epoch0 = time.time()
    setup_s = time.perf_counter() - T_PROCESS
    window = loop.run_window(seconds, clients, values, traffic["order"], templates)
    epoch1 = time.time()
    if prof is not None:
        prof.__exit__(None, None, None)
    if calls is not None:
        calls.uninstall()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    after = dep.info()
    left_memory_path = dep.left_memory_path(epoch0, time.time())

    requests = [{"template": r["template"], "ok": r["ok"],
                 "latency_ms": (r["done"] - r["sent"]) * 1e3} for r in window.requests]
    record = {"cell": workload, "setup_s": setup_s, "span_s": window.span(),
              "answered": len(window.answered()), "queries": len(window.requests),
              "requests": requests}
    if trace:
        record["spans"] = T.tracer_spans(dep.tracer(), epoch0, epoch1)
        record["device"] = prof.reduce(record["spans"], calls) if prof is not None else None
    names = layer if trace else e2e
    metrics = {}
    for name in names:
        value = spec.metric_reader(name).read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": metric_entry(spec, name)["unit"]}

    counts = collections.Counter(r["template"] for r in window.requests)
    _log(f"[run] {workload} seed {seed}: {len(window.requests)} queries sent in "
         f"{window.seconds:.0f} s ({dict(sorted(counts.items()))}), "
         f"{record['answered']} answered by {record['span_s']:.3f} s, {window.failed()} "
         f"failed; setup {setup_s:.3f} s")
    for r in window.requests:
        if not r["ok"]:
            _log(f"[run] failed {r['template']} {r['params']}: {r.get('error')}")
    lat = collections.defaultdict(list)
    for r in requests:
        if r["ok"]:
            lat[r["template"]].append(r["latency_ms"])
    for name, v in sorted(lat.items()):
        _log(f"[run] {name}: n {len(v)}, p50 {stats.percentile(v, 50)} ms, "
             f"max {max(v):.3f} ms")
    _log(f"[run] deployment before the window {json.dumps(before)}, "
         f"after {json.dumps(after)}")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    _log(f"[run] peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    breakdown = None
    dev = record.get("device")
    if dev is not None:
        device_info.update(busy_s=dev["busy_s"], window_s=dev["window_s"])
        limit = _power_limit()
        for name, k in dev["kernels"].items():
            share = 100 * k["least_s"] / k["device_s"] if k["device_s"] > 0 else None
            _log(f"[trace] {name}: {k['calls']} calls, {k['bytes']} bytes, "
                 f"{k['ops']} ops, device {k['device_s']:.6f} s, least {k['least_s']:.6f} s, "
                 f"share {share} % ({limit})")
        _log(f"[trace] {dev['events']} events reduced in {dev['reduce_s']:.1f} s; "
             f"{dev['uncorrelated_kernel_events']} kernel events given by name")
        breakdown = {"device_ops": [[n[:200], s] for n, s in dev["device_ops"]],
                     "idle_gaps": [[n[:200], s] for n, s in dev["idle_gaps"]]}

    dep.stop()
    data = TpchData(config["scale_factor"], device)
    verdict = check.judge(spec, templates, window.requests, data, left_memory_path, control)
    _log(f"[check] {verdict['compared']} answers of {verdict['distinct']} distinct "
         f"parameter sets held to the reference in {verdict['seconds']:.1f} s"
         + (f" (control: the reference in {control} in the program's place)" if control else ""))
    bad = guard.loaded()
    if bad:
        raise SystemExit(f"[guard] loaded in the benchmark's process: {sorted(bad)}")
    checks = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in verdict["numbers"].items()}
    for k, v in checks.items():
        _log(f"[check] {k} {v['value']} limit {v['limit']}")
    result = {"correct": verdict["correct"], "attempted": len(window.requests),
              "failed": window.failed(), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("float64", "float32"))
    args = ap.parse_args(argv)

    from portbench.core.spec import Spec

    from portbench.core.roofline import DEVICE

    spec = Spec.load()
    chips = int(spec.cell(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[run] needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    kinds = {torch.cuda.get_device_name(i) for i in range(chips)}
    if kinds != {DEVICE}:
        print(f"[run] the peaks are of the {DEVICE}; found {sorted(kinds)}", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, args.trace,
                     control=args.control, spec=spec)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    import traceback

    try:
        rc = main()
    except SystemExit as e:  # argparse, or the guard's message
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
        rc = e.code if isinstance(e.code, int) else 1
    except Exception:  # the traceback on stderr, no result, a failing code
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # a client thread whose query never came runs on as a daemon;
    # nothing is left to write
    os._exit(rc)
