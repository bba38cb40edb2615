#!/usr/bin/env python
"""The port's tracer against the device trace: its clock and its cost.

    python scripts/span_clock.py [--spans 1000] [--device cuda]

Opens `--spans` spans of the port's tracer (trino_tpu_torch.utils.tracing)
under torch.profiler, each around one kernel launch and a synchronize, and
matches each span with the kernel it launched (the n-th kernel event with
the n-th span).  Prints one JSON line: the largest distance by which a
kernel's interval falls outside its span (`outside_us`: 0 where every
kernel lies inside, as the idle-gap attribution of a traced benchmark run
needs) and how many spans it fell outside of, the smallest and median
margins inside (negative where outside), and the microseconds one span costs
on this host (`span_us`, over `--cost-spans` empty spans nested in one).
On a CPU device the kernel is the host operator's event."""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def measure(n: int = 1000, device: str = "cuda", cost_spans: int = 100_000) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from trino_tpu_torch.utils.tracing import Tracer

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    x = torch.zeros(1 << 20, device=dev)
    tracer = Tracer(max_spans=n + cost_spans + 1)
    x.add_(1)  # the launch's own first-call set-up stays outside the spans
    if on_card:
        torch.cuda.synchronize(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        for i in range(n):
            with tracer.span("clock", i=i):
                x.add_(1)
                if on_card:
                    torch.cuda.synchronize(dev)
    spans = sorted((s for s in tracer.spans if s.name == "clock"), key=lambda s: s.start)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted(
        (e for e in prof.profiler.kineto_results.events()
         if not e.is_user_annotation()
         and (e.device_type() == cuda if on_card else e.name() == "aten::add_")),
        key=lambda e: e.start_ns())
    if len(kernels) != len(spans):
        raise SystemExit(f"{len(kernels)} kernel events for {len(spans)} spans")
    before = [s.start - e.start_ns() / 1e9 for s, e in zip(spans, kernels)]
    after = [(e.start_ns() + e.duration_ns()) / 1e9 - s.end for s, e in zip(spans, kernels)]

    tracer.clear()
    with tracer.span("parent"):
        t0 = time.perf_counter()
        for _ in range(cost_spans):
            with tracer.span("cost"):
                pass
        took = time.perf_counter() - t0
    return {
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "spans": n,
        "outside_us": max(0.0, max(before + after)) * 1e6,
        "outside_spans": sum(1 for b, a in zip(before, after) if max(b, a) > 0),
        "start_margin_min_us": -max(before) * 1e6,
        "start_margin_median_us": -statistics.median(before) * 1e6,
        "end_margin_min_us": -max(after) * 1e6,
        "end_margin_median_us": -statistics.median(after) * 1e6,
        "span_us": took / cost_spans * 1e6,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", type=int, default=1000)
    ap.add_argument("--cost-spans", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.spans, args.device, args.cost_spans)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
