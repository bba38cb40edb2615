"""Distributed query scheduler (pipelined mode).

Counterpart of trino_tpu/server/scheduler.py, with the host walls of
each run (``timings``: task dispatch, the root's fetch and decode, the
task stats reads).

Reference parity: execution/scheduler/PipelinedQueryScheduler.java:157 —
all stages scheduled at once; split placement over alive workers mirrors
NodeScheduler/UniformNodeSelector round-robin; per-(stage,node) remote tasks
are created via the task API (HttpRemoteTask.sendUpdate:722 POST
/v1/task/{taskId} with fragment+splits+outputBuffers); the root stage's
output is pulled back through the exchange client (server/protocol/Query
pulling from the root OutputBuffer).

Task/buffer wiring:
  - SOURCE fragments: one task per alive worker, splits round-robin
  - HASH fragments: one task per alive worker (FIXED_HASH_DISTRIBUTION)
  - SINGLE fragments (and the root): one task on one worker
  - producer buffer count = consumer task count when output is hash;
    broadcast/single producers expose one buffer (0) that every consumer
    (or the single consumer) reads — BroadcastOutputBuffer semantics
"""
from __future__ import annotations

import json
import time
import urllib.request
import uuid
from typing import Dict, List, Optional, Tuple

from ..catalog import CatalogManager
from ..exec.exchange_client import ExchangeClient
from ..exec.partitioner import concat_pages
from ..page import Page
from ..plan import nodes as P
from ..plan.fragment import (
    ARBITRARY,
    HASH,
    SOURCE,
    PlanFragment,
    fragment_plan,
)
from ..serde import encode_value, plan_to_json
from ..utils.metrics import REGISTRY
from ..utils.tracing import TRACER

SPLITS_PER_NODE = 4


class SchedulerError(RuntimeError):
    pass


class TaskHandle:
    def __init__(self, task_id: str, uri: str):
        self.task_id = task_id
        self.uri = uri


def _post_json(url: str, doc: dict, timeout: float = 30.0):
    headers = {"Content-Type": "application/json"}
    # propagate the caller's trace context (W3C Trace Context): the worker
    # parents its task span under the coordinator's query span
    tp = TRACER.current_traceparent()
    if tp:
        headers["traceparent"] = tp
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(), headers=headers
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def assign_splits(
    catalogs: CatalogManager, f: PlanFragment, ntasks: int
) -> List[Dict[int, list]]:
    """Round-robin split placement over a stage's tasks (NodeScheduler /
    UniformNodeSelector role); single-task fragments scan everything.
    Shared by the pipelined and fault-tolerant schedulers."""
    per_task: List[Dict[int, list]] = [dict() for _ in range(ntasks)]
    for scan_idx, (catalog, table, constraint) in f.scan_tables.items():
        conn = catalogs.get(catalog)
        if f.partitioning == SOURCE:
            desired = max(ntasks * SPLITS_PER_NODE, 1)
            splits = conn.split_manager().get_splits(
                table, desired, constraint
            )
            for i, sp in enumerate(splits):
                per_task[i % ntasks].setdefault(scan_idx, []).append(sp)
        else:
            splits = conn.split_manager().get_splits(table, 1, constraint)
            per_task[0].setdefault(scan_idx, []).extend(splits)
    return per_task


def source_buffer_index(src_frag: PlanFragment, task_index: int) -> int:
    """Which producer buffer a consumer task reads: its own index for
    hash/arbitrary repartitioning, buffer 0 for single/broadcast."""
    return (
        task_index
        if src_frag.output_partitioning in (HASH, ARBITRARY)
        else 0
    )


class DistributedScheduler:
    """Schedules one query's fragments onto the alive workers."""

    def __init__(
        self,
        catalogs: CatalogManager,
        workers: List[Tuple[str, str]],
        properties: Optional[dict] = None,
        memory_view=None,
        node_manager=None,
    ):
        if not workers:
            raise SchedulerError("no alive workers")
        self.catalogs = catalogs
        self.workers = workers
        self.properties = properties or {}
        # optional ClusterMemoryManager: single-task placement prefers
        # the node with the most free pool bytes and avoids blocked
        # nodes (NodeScheduler memory-aware selection)
        self.memory_view = memory_view
        # optional NodeManager: announced device-health snapshots route
        # work away from DEGRADED nodes and off QUARANTINED ones
        self.node_manager = node_manager

    def _device_states(self) -> Dict[str, dict]:
        if self.node_manager is None:
            return {}
        try:
            return self.node_manager.device_states()
        except Exception:
            return {}

    @staticmethod
    def _health_rank(device: Optional[dict]) -> int:
        """ACTIVE/unknown=2 > DEGRADED=1 > QUARANTINED=0.  Unknown ranks
        with ACTIVE: a node that never announced device health predates
        the supervisor and is presumed fine."""
        state = (device or {}).get("state", "ACTIVE")
        return {"QUARANTINED": 0, "DEGRADED": 1}.get(state, 2)

    def _lifecycle_states(self) -> Dict[str, str]:
        if self.node_manager is None:
            return {}
        fn = getattr(self.node_manager, "lifecycle_states", None)
        if fn is None:
            return {}
        try:
            return fn()
        except Exception:
            return {}

    def _schedulable_workers(self) -> List[Tuple[str, str]]:
        """Workers eligible for placement, re-resolved per stage from the
        node manager when one is attached: DRAINING/DRAINED/SUSPECT/GONE
        nodes drop out mid-query and LATE JOINERS become schedulable for
        new stages without a restart.  QUARANTINED devices (all devices
        out, no CPU fallback) are excluded too.  There is NO silent
        fallback — when every node is excluded the query fails with a
        structured error naming each exclusion, instead of quietly
        re-admitting nodes known to be unhealthy."""
        pool = list(self.workers)
        alive_fn = getattr(self.node_manager, "alive", None)
        if alive_fn is not None:
            try:
                pool = list(alive_fn())
            except Exception:
                pool = list(self.workers)
        lifecycle = self._lifecycle_states()
        device = self._device_states()
        ok: List[Tuple[str, str]] = []
        excluded: List[str] = []
        for w in pool:
            state = lifecycle.get(w[0], "ACTIVE")
            if state != "ACTIVE":
                excluded.append(f"{w[0]}={state}")
            elif self._health_rank(device.get(w[0])) <= 0:
                excluded.append(f"{w[0]}=QUARANTINED")
            else:
                ok.append(w)
        seen = {w[0] for w in pool}
        for w in self.workers:
            if w[0] not in seen:
                excluded.append(
                    f"{w[0]}={lifecycle.get(w[0], 'NOT_ALIVE')}"
                )
        if not ok:
            raise SchedulerError(
                "NO_NODES_AVAILABLE: every worker is unschedulable "
                f"(excluded: {', '.join(sorted(excluded)) or 'none known'})"
            )
        return ok

    def _pick_single_worker(self, query_id: str) -> Tuple[str, str]:
        pool = self._schedulable_workers()
        device = self._device_states()
        nodes: Dict[str, dict] = {}
        if self.memory_view is not None:
            try:
                nodes = {
                    n.get("nodeId"): n
                    for n in self.memory_view.nodes_view()
                }
            except Exception:
                nodes = {}

        def headroom(w: Tuple[str, str]) -> int:
            snap = nodes.get(w[0])
            if not snap:
                return -1  # no snapshot yet: only if nothing better
            if snap.get("blocked"):
                return -2  # a blocked node can't host new work
            return sum(
                int(p.get("free", 0))
                for p in (snap.get("pools") or {}).values()
            )

        # device health dominates memory headroom: a DEGRADED node (CPU
        # fallback) ranks below ANY ACTIVE node regardless of free bytes;
        # unschedulable nodes never reach this ranking at all
        best = max(
            (self._health_rank(device.get(w[0])), headroom(w))
            for w in pool
        )
        if best[1] < 0 and len(pool) == len(self.workers) and best[0] >= 2:
            # no memory signal and no health signal: hash-spread pick
            return pool[hash(query_id) % len(pool)]
        candidates = [
            w for w in pool
            if (self._health_rank(device.get(w[0])), headroom(w)) == best
        ]
        return candidates[hash(query_id) % len(candidates)]

    # ------------------------------------------------------------------
    def run(self, plan: P.Output, query_id: Optional[str] = None) -> Page:
        query_id = query_id or f"q_{uuid.uuid4().hex[:12]}"
        fragments = fragment_plan(plan)
        by_id = {f.id: f for f in fragments}
        consumer: Dict[int, int] = {}
        for f in fragments:
            for sf in f.source_fragments:
                consumer[sf] = f.id

        # task placement (stage width)
        ntasks: Dict[int, int] = {}
        placement: Dict[int, List[Tuple[str, str]]] = {}
        for f in fragments:
            if f.partitioning in (SOURCE, HASH, ARBITRARY):
                placement[f.id] = self._schedulable_workers()
            else:  # SINGLE; memory-aware pick, hash spread as fallback
                placement[f.id] = [self._pick_single_worker(query_id)]
            ntasks[f.id] = len(placement[f.id])

        # buffer counts: hash output -> one buffer per consumer task
        nbuffers: Dict[int, int] = {}
        for f in fragments:
            if f.output_partitioning in (HASH, ARBITRARY):
                nbuffers[f.id] = ntasks[consumer[f.id]]
            else:
                nbuffers[f.id] = 1

        tasks: Dict[int, List[TaskHandle]] = {}
        created: List[TaskHandle] = []
        # host walls of this run: dispatching the tasks, pulling and
        # decoding the root's frames, reading the tasks' stats
        self.timings = {"scheduleS": 0.0, "rootFetchS": 0.0, "rootBytes": 0,
                        "rootDeserializeS": 0.0, "taskStatsS": 0.0}
        t0 = time.perf_counter()
        try:
            # children before consumers: cuts happen bottom-up, so source
            # fragments always have smaller ids; root (0) is scheduled last
            order = sorted((f for f in fragments if f.id != 0),
                           key=lambda f: f.id) + [by_id[0]]
            for f in order:
                tasks[f.id] = self._schedule_fragment(
                    query_id, f, placement[f.id], nbuffers[f.id], tasks,
                    by_id,
                )
                created.extend(tasks[f.id])
            root_task = tasks[0][0]
            self.timings["scheduleS"] = time.perf_counter() - t0
            client = ExchangeClient(traceparent=TRACER.current_traceparent())
            pages = client.fetch_sources(
                {0: [{"uri": root_task.uri, "task": root_task.task_id,
                      "buffer": 0}]}
            )[0]
            self.timings.update(rootFetchS=client.last_fetch_wall_s,
                                rootBytes=client.last_fetch_bytes,
                                rootDeserializeS=client.last_deserialize_s)
            t_stats = time.perf_counter()
            if not pages:
                raise SchedulerError("root task produced no pages")
            # per-task stats rollup (OperatorStats -> TaskStats ->
            # QueryStats hierarchy analog) surfaced at /v1/query/{id}
            self.last_task_stats = []
            for t in created:
                try:
                    with urllib.request.urlopen(
                        f"{t.uri}/v1/task/{t.task_id}", timeout=5.0
                    ) as resp:
                        info = json.loads(resp.read())
                    self.last_task_stats.append(
                        {"taskId": t.task_id, "uri": t.uri,
                         **(info.get("stats") or {})}
                    )
                except Exception:
                    pass
            self.timings["taskStatsS"] = time.perf_counter() - t_stats
            return concat_pages(pages)
        finally:
            for t in created:
                try:
                    req = urllib.request.Request(
                        f"{t.uri}/v1/task/{t.task_id}", method="DELETE"
                    )
                    urllib.request.urlopen(req, timeout=5.0).read()
                except Exception:
                    pass

    # ------------------------------------------------------------------
    def _schedule_fragment(
        self,
        query_id: str,
        f: PlanFragment,
        workers: List[Tuple[str, str]],
        out_buffers: int,
        tasks: Dict[int, List[TaskHandle]],
        by_id: Dict[int, PlanFragment],
    ) -> List[TaskHandle]:
        n = len(workers)
        splits_per_task = assign_splits(self.catalogs, f, n)

        frag_json = plan_to_json(f.root)
        handles: List[TaskHandle] = []
        for i, (node_id, uri) in enumerate(workers):
            task_id = f"{query_id}.{f.id}.{i}"
            sources: Dict[str, list] = {}
            for sf in f.source_fragments:
                src_frag = by_id[sf]
                locs = [
                    {
                        "uri": up.uri,
                        "task": up.task_id,
                        "buffer": source_buffer_index(src_frag, i),
                    }
                    for up in tasks[sf]
                ]
                sources[str(sf)] = locs
            doc = {
                "fragment": frag_json,
                "splits": {
                    str(k): [encode_value(s) for s in v]
                    for k, v in splits_per_task[i].items()
                },
                "output": {
                    "partitioning": f.output_partitioning,
                    "keys": list(f.output_keys),
                    "nbuffers": out_buffers,
                },
                "sources": sources,
                "properties": self.properties,
            }
            _post_json(f"{uri}/v1/task/{task_id}", doc)
            REGISTRY.counter(
                "trino_tpu_scheduler_dispatch_total",
                "Remote task creations dispatched to workers",
            ).inc()
            handles.append(TaskHandle(task_id, uri))
        return handles
