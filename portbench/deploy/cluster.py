"""A cluster: one coordinator that schedules and two workers, with real
HTTP between them (`trino_tpu_torch.testing.DistributedQueryRunner`, all
three servers in the benchmark's process, so their spans land in one
tracer and their device work in one profile).  Each query is fragmented,
its tasks posted to the workers, and its pages exchanged as serialized
frames; clients send SQL through the statement protocol
(`StatementClient`).  Both workers share the one card, each with half of
it as its device pool.

A worker's fragment larger than the session's memory limit streams in
tiles on the card: that is the configuration's stated path.  A query
counts in `left_memory_path` when any of its tasks spilled off the card
(read from the tasks' kernel profiles: an `outOfCore` path other than
`stream`)."""
from __future__ import annotations

import gc

import torch

from portbench.core import rows as R


def spilled(task_stats) -> bool:
    """Whether a query's tasks show a path off the card (a spill)."""
    for t in task_stats or []:
        path = (t.get("kernelProfile") or {}).get("outOfCore")
        if path and path != "stream":
            return True
    return False


class Deployment:
    def __init__(self, config: dict, build_dir: str, device: str = "cuda"):
        self.config = config
        self.build_dir = build_dir
        self.device = device
        self.runner = None

    def start(self) -> None:
        from trino_tpu_torch.ops import kernels
        from trino_tpu_torch.testing import DistributedQueryRunner

        kernels.set_build_dir(self.build_dir)
        catalogs = (("tpch", "tpch", {"tpch.scale-factor": self.config["scale_factor"]}),)
        self.runner = DistributedQueryRunner(
            workers=int(self.config["workers"]), catalogs=catalogs,
            properties=dict(self.config.get("session", {})), device=self.device)

    def clients(self, n: int):
        from trino_tpu_torch.client.client import StatementClient

        return [self._client(StatementClient(self.runner.coordinator.uri)) for _ in range(n)]

    @staticmethod
    def _client(client):
        def run(sql: str) -> list:
            columns, rows = client.execute(sql)
            return R.canonical(rows, [c["type"].startswith("decimal") for c in columns])

        return run

    def _queries(self):
        return list(self.runner.coordinator.coordinator.queries.values())

    def tracer(self):
        from trino_tpu_torch.utils.tracing import TRACER

        return TRACER

    def kernels_module(self):
        from trino_tpu_torch.ops import kernels

        return kernels

    def info(self) -> dict:
        tiles = sum(sum((t.get("kernelProfile") or {}).get("streamedTiles", {}).values())
                    for q in self._queries() for t in q.task_stats or [])
        return {"worker_tasks": [w.task_manager.tasks_created for w in self.runner.workers],
                "queries": len(self._queries()), "streamed_tiles": tiles}

    def left_memory_path(self, lo: float, hi: float) -> int:
        """Queries created in [lo, hi] (epoch seconds) whose tasks spilled."""
        return sum(1 for q in self._queries()
                   if lo <= q.created <= hi and spilled(q.task_stats))

    def stop(self) -> None:
        self.runner.stop()
        self.runner = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()
