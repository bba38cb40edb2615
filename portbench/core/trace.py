"""The traced run: the profiler's device events, the kernels' ranges and
the program's spans, reduced to one record that the per-layer readers
(`portbench/metrics/*.py`) read.

Device time comes from `torch.profiler` (CUPTI), never from host clocks:
busy time is the union of the device events' intervals inside the
window.  The four CUDA kernel entry points of `ops.kernels` are wrapped
from outside in `record_function` ranges; a call's device time is the
device work launched inside its range (matched by the runtime calls'
correlation ids on the range's thread), so the share reads the same
work whatever kernel implements it.  The work a call needs (bytes and
operations) is computed from its arguments by `roofline.work`.  The
benchmark's own device work (the count of table sectors a probe
touches) runs in a range of its own and is left out of everything."""
from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Dict, List, Optional

import torch

from . import roofline

KERNEL_RANGE = "portbench.kernel."
HARNESS_RANGE = "portbench.harness"
KERNELS = ("fused_agg_sums", "grouped_count", "grouped_sum_i64", "direct_probe")
# the port's kernels by the name their device events carry: a launch
# whose runtime call the profiler did not see is given to its entry point
# by this name
DEVICE_NAMES = {"fused_agg_kernel": "fused_agg_sums",
                "grouped_count_kernel": "grouped_count",
                "grouped_sum_kernel": "grouped_sum_i64",
                "direct_probe_kernel": "direct_probe"}


class KernelCalls:
    """Wraps the kernel entry points of `module` while installed."""

    def __init__(self, module):
        self.module = module
        self.calls: List[tuple] = []  # (entry point, bytes, ops, sectors tensor)
        self._orig: Dict[str, object] = {}
        self._lock = threading.Lock()

    def install(self) -> None:
        from torch.profiler import record_function

        for name in KERNELS:
            orig = self._orig[name] = getattr(self.module, name)

            def wrapped(*args, _name=name, _orig=orig, **kw):
                with record_function(KERNEL_RANGE + _name):
                    out = _orig(*args, **kw)
                with record_function(HARNESS_RANGE):
                    nbytes, ops, pending = roofline.work(_name, args, kw, out)
                with self._lock:
                    self.calls.append((_name, nbytes, ops, pending))
                return out

            setattr(self.module, name, wrapped)

    def uninstall(self) -> None:
        for name, orig in self._orig.items():
            setattr(self.module, name, orig)
        self._orig.clear()

    def totals(self) -> Dict[str, dict]:
        """{entry point: {calls, bytes, ops}}, the sectors read back now."""
        out: Dict[str, dict] = {}
        for name, nbytes, ops, pending in self.calls:
            t = out.setdefault(name, {"calls": 0, "bytes": 0, "ops": 0})
            t["calls"] += 1
            t["bytes"] += nbytes + (int(pending) * roofline.SECTOR if pending is not None else 0)
            t["ops"] += ops
        return out


def _union(intervals: List[tuple], lo: int, hi: int) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _gaps(intervals: List[tuple], lo: int, hi: int) -> List[tuple]:
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


class Profile:
    """The profiler over the measured window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.start_ns = self.end_ns = 0

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        self.prof.__exit__(*exc)

    def reduce(self, spans: List[dict], calls: Optional[KernelCalls]) -> dict:
        """The record the readers take: busy and window seconds, kernel
        launches, per entry point device seconds with bytes and ops, the
        top device operations and the idle gaps by the host's span."""
        t0 = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        lo, hi = self.start_ns, self.end_ns
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                dev.append(e)
            else:
                host.append(e)
        # host ranges of the kernels and of the benchmark's own work, and
        # the runtime calls by thread (sorted by start) for the matching
        ranges = [e for e in host if e.name().startswith(KERNEL_RANGE)
                  or e.name() == HARNESS_RANGE]
        runtime = collections.defaultdict(list)
        for e in host:
            if e.name().startswith(("cuda", "cu")) and not e.is_user_annotation():
                runtime[e.start_thread_id()].append((e.start_ns(), e.correlation_id()))
        for v in runtime.values():
            v.sort()
        owner: Dict[int, str] = {}
        for r in ranges:
            calls_on = runtime.get(r.start_thread_id(), [])
            i = bisect.bisect_left(calls_on, (r.start_ns(), -1))
            while i < len(calls_on) and calls_on[i][0] <= r.end_ns():
                owner[calls_on[i][1]] = r.name()
                i += 1
        kernel_s: Dict[str, float] = collections.defaultdict(float)
        busy, ops_time, launches = [], collections.defaultdict(float), 0
        unmatched = 0
        for e in dev:
            if e.is_user_annotation():
                continue
            who = owner.get(e.correlation_id())
            if who == HARNESS_RANGE:
                continue
            s, d = e.start_ns(), e.duration_ns()
            busy.append((s, s + d))
            name = e.name()
            ops_time[name] += d / 1e9
            if not name.startswith(("Memcpy", "Memset")):
                launches += 1
            if who is not None:
                kernel_s[who[len(KERNEL_RANGE):]] += d / 1e9
            else:
                entry = next((v for k, v in DEVICE_NAMES.items() if k in name), None)
                if entry is not None:
                    kernel_s[entry] += d / 1e9
                    unmatched += 1
        busy_ns = _union(busy, lo, hi)
        gaps = _gaps(busy, lo, hi)
        by_span: Dict[str, float] = collections.defaultdict(float)
        for (s, e), name in zip(gaps, _spans_at(spans, [(s + e) / 2e9 for s, e in gaps])):
            by_span[name] += (e - s) / 1e9
        work = calls.totals() if calls is not None else {}
        kernels = {}
        for name in KERNELS:
            if name in work or name in kernel_s:
                w = work.get(name, {"calls": 0, "bytes": 0, "ops": 0})
                kernels[name] = dict(w, device_s=kernel_s.get(name, 0.0),
                                     least_s=roofline.least_seconds(w["bytes"], w["ops"]))
        return {
            "window_s": (hi - lo) / 1e9,
            "busy_s": busy_ns / 1e9,
            "launches": launches,
            "kernels": kernels,
            "uncorrelated_kernel_events": unmatched,
            "device_ops": sorted(ops_time.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(by_span.items(), key=lambda kv: -kv[1])[:10],
            "reduce_s": time.perf_counter() - t0,
            "events": len(dev) + len(host),
        }


def _spans_at(spans: List[dict], times: List[float]) -> List[str]:
    """For each time (epoch seconds), the innermost program span open
    then (the shortest that covers it), or "outside any span"."""
    import numpy as np

    if not spans:
        return ["outside any span"] * len(times)
    st = np.array([s["start"] for s in spans])
    en = np.array([s["end"] for s in spans])
    ln = en - st
    out = []
    for k in range(0, len(times), 512):
        t = np.array(times[k:k + 512])[:, None]
        cover = (st[None, :] <= t) & (en[None, :] >= t)
        pick = np.where(cover, ln[None, :], np.inf).argmin(axis=1)
        out += [spans[i]["name"] if cover[r, i] else "outside any span"
                for r, i in enumerate(pick)]
    return out


def tracer_spans(tracer, lo: float, hi: float) -> List[dict]:
    """The program tracer's finished spans that started inside [lo, hi]
    (epoch seconds)."""
    return [{"name": s.name, "start": s.start, "end": s.end,
             "attributes": dict(s.attributes)}
            for s in list(tracer.spans) if s.end is not None and lo <= s.start <= hi]
