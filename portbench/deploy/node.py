"""A single node: the coordinator runs each query in-process
(`trino_tpu_torch.session.tpch_session`), with TPC-H scans generated on
the card and kept in the session's scan cache.  The session's memory
limit is the card's size, and the configuration states that every query
stays on the in-memory path: a query that streams or spills is counted
(`left_memory_path`), and the run is then not correct."""
from __future__ import annotations

import gc
import time

import torch

from portbench.core import rows as R


def left_memory(profile) -> bool:
    """Whether an executor's kernel profile shows the out-of-core path."""
    p = profile or {}
    return bool(p.get("outOfCore") or p.get("forcedStreaming") or p.get("streamedFragments"))


class Deployment:
    def __init__(self, config: dict, build_dir: str, device: str = "cuda"):
        self.config = config
        self.build_dir = build_dir
        self.device = device
        self.session = None
        self.plan_lookups = 0
        self.plan_hits = 0
        self.out_of_core = []  # epoch seconds of each query that left memory

    def start(self) -> None:
        from trino_tpu_torch.memory import detect_device_bytes
        from trino_tpu_torch.ops import kernels
        from trino_tpu_torch.session import tpch_session

        kernels.set_build_dir(self.build_dir)
        # the card's size (on the CPU, where tests rehearse a run, the
        # property's default)
        limit = detect_device_bytes(device=self.device)
        props = dict(self.config.get("session", {}))
        if limit is not None:
            props["query_max_memory_bytes"] = limit
        self.session = tpch_session(self.config["scale_factor"], device=self.device, **props)

    def clients(self, n: int):
        if n != 1:
            raise ValueError("a node deployment takes one client (one session)")
        return [self._run]

    def _run(self, sql: str) -> list:
        s = self.session
        self.plan_lookups += 1
        self.plan_hits += sql in s._plan_cache
        page = s.execute(sql)
        prof = s.last_kernel_profile or {}
        if left_memory(prof):
            self.out_of_core.append(time.time())
        return R.canonical(page.to_pylist(), [c.type.is_decimal for c in page.columns])

    def tracer(self):
        from trino_tpu_torch.utils.tracing import TRACER

        return TRACER

    def kernels_module(self):
        from trino_tpu_torch.ops import kernels

        return kernels

    def info(self) -> dict:
        c = self.session._scan_cache
        return {"scan_cache": {"entries": len(c.entries), "bytes": c.bytes, "hits": c.hits,
                               "misses": c.misses, "evictions": c.evictions},
                "plan_cache": {"lookups": self.plan_lookups, "hits": self.plan_hits}}

    def left_memory_path(self, lo: float, hi: float) -> int:
        """Queries of [lo, hi] (epoch seconds) that streamed or spilled."""
        return sum(1 for t in self.out_of_core if lo <= t <= hi)

    def stop(self) -> None:
        self.session = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()
