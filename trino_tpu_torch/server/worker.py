"""Worker server: task API, fragment execution, output buffers, announcer.

Counterpart of trino_tpu/server/worker.py for the pipelined path.  A
worker runs on one device (``device``: CUDA unless the caller passes
"cpu") and builds its memory manager, device supervisor and fragment
executors there.  It has no CPU fallback: a fragment that faults fails
its task with DeviceFaultError (the error rides the task status and the
exchange to the coordinator and its client), the card is quarantined
and the node announces QUARANTINED until the canary passes.  A worker
of a multi-host cluster has ``local_devices`` logical shards on its
device: under ``cross_host_mesh`` a slice-eligible fragment runs over
all of them (parallel/mesh_executor.CrossHostFragmentExecutor), through
the same supervisor, memory pool and launch counts.  Under
fault-tolerant execution a task's output frames go to its spool
directory (``spool_path``) instead of the worker's memory, and its
inputs are read back from the producers' spools.

Reference parity:
  - POST /v1/task/{taskId} create-or-update with fragment+splits+buffers
    (server/TaskResource.java:136 -> SqlTaskManager.updateTask:479)
  - GET  /v1/task/{taskId} task status (TaskState.java:21 states)
  - GET  /v1/task/{taskId}/results/{bufferId}/{token} page pull with
    long-poll + completion marker (TaskResource:  getResults; served from
    OutputBuffer variants — here: per-buffer lists of serialized frames)
  - DELETE /v1/task/{taskId} abort
  - worker announcement to the coordinator's discovery endpoint
    (airlift discovery "trino" service announcements, DiscoveryNodeManager)
  - fault injection (execution/FailureInjector.java:39,61 wired into
    TaskResource.injectFailure:183): the seeded FaultInjector
    (utils/faults.py) drives every chaos site — task_run/task_stall at
    task start, exchange_fetch/spool_read inside the exchange client,
    spool_write_corrupt on the FTE spool write, heartbeat in the
    announcer.  Tasks carrying a ``fault_injection`` property share one
    injector per spec (per worker), so nth-call rules count across a
    query; POST /v1/task/{taskId}/fail keeps its taskId-addressed
    one-shot semantics through the same harness.

Execution: each task runs on its own thread; the fragment runs on the
worker's device (exec/fragment_exec.py) or over its shards; output pages
are hash/broadcast partitioned into buffers (exec/partitioner.py) and
served as binary frames.
"""
from __future__ import annotations

import json
import os
import threading
import time
import traceback
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import torch

from .. import device as D
from ..catalog import CatalogManager
from ..exec.exchange_client import ExchangeClient, RemoteTaskError
from ..exec.fragment_exec import FragmentExecutor
from ..exec.partitioner import (
    chunk_page,
    partition_page,
    partition_page_round_robin,
)
from ..ops import kernels as kn
from ..serde import decode_value, plan_from_json, serialize_page
from ..spi import Split
from ..utils.faults import FaultInjector
from ..utils.metrics import REGISTRY
from ..utils.tracing import TRACER

TASK_STATES = (
    "PLANNED", "RUNNING", "FLUSHING", "FINISHED", "CANCELED", "ABORTED",
    "FAILED",
)


class TaskExecution:
    """One task: fragment + splits + output buffers (SqlTask analog)."""

    def __init__(self, task_id: str, doc: dict):
        self.task_id = task_id
        self.doc = doc
        self.state = "PLANNED"
        self.error: Optional[str] = None
        # buffer id -> list of serialized page frames
        self.buffers: Dict[int, List[bytes]] = {}
        self.complete = False
        self.lock = threading.Lock()
        self.created = time.time()
        self.stats: Dict[str, int] = {}


class TaskManager:
    """Executes tasks against this worker's catalogs (SqlTaskManager)."""

    def __init__(
        self,
        catalogs: CatalogManager,
        memory_manager=None,
        supervisor=None,
        device=None,
        local_devices: int = 1,
    ):
        self.catalogs = catalogs
        self.device = D.resolve(device)
        # logical shards on this worker's device: a slice-eligible
        # fragment of a cross_host_mesh query runs over all of them
        self.local_devices = int(local_devices)
        self.memory_manager = memory_manager
        # node-level device supervisor: every fragment on this worker
        # dispatches through it, so quarantine outlives any one task
        self.supervisor = supervisor
        self.tasks: Dict[str, TaskExecution] = {}
        # set by WorkerServer once its listen port is bound: exchange
        # fetches targeting any other URI count as cross-host traffic
        self.own_uri = ""
        # cumulative placements: /v1/task DELETEs pop finished tasks out
        # of ``tasks``, so "did this node ever get work" needs a counter
        # that survives cleanup (drain + late-joiner assertions key on it)
        self.tasks_created = 0
        self.lock = threading.Lock()
        # worker-level injector: serves the /v1/task/{id}/fail endpoint's
        # taskId-addressed modes and operator-configured sites (heartbeat)
        self.fault_injector = FaultInjector()
        # per-spec injectors for tasks shipping a fault_injection
        # property: all tasks of a query share the spec, hence the
        # injector, hence one deterministic call counter per worker
        self._injectors: Dict[str, FaultInjector] = {}
        # bounded ring of completed-task OperatorStats summaries: rides
        # the announce loop to the coordinator's live straggler detector
        from collections import deque

        self.recent_opstats: deque = deque(maxlen=64)

    def create_or_update(self, task_id: str, doc: dict) -> TaskExecution:
        with self.lock:
            t = self.tasks.get(task_id)
            if t is not None:
                return t  # idempotent re-POST (HttpRemoteTask retries)
            t = TaskExecution(task_id, doc)
            self.tasks[task_id] = t
            self.tasks_created += 1
        threading.Thread(target=self._run, args=(t,), daemon=True).start()
        return t

    def inject_failure(self, task_id: str, mode: str):
        self.fault_injector.set_task_mode(task_id, mode)

    def _injector_for(self, spec) -> FaultInjector:
        if not spec:
            return self.fault_injector
        key = spec if isinstance(spec, str) else json.dumps(
            spec, sort_keys=True
        )
        with self.lock:
            inj = self._injectors.get(key)
            if inj is None:
                inj = self._injectors[key] = FaultInjector.from_spec(spec)
            return inj

    def abort(self, task_id: str):
        t = self.tasks.get(task_id)
        if t:
            with t.lock:
                if t.state not in ("FINISHED", "FAILED"):
                    t.state = "ABORTED"
                    t.error = "task aborted"

    def delete(self, task_id: str):
        self.abort(task_id)
        with self.lock:
            self.tasks.pop(task_id, None)

    def _spool(self, t: TaskExecution, spool_path: str, inj):
        """FTE mode: durable spool instead of in-memory serving
        (spi/exchange ExchangeSink; survives this worker's death).  The
        frames serialized from the device pages (one copy down a page)
        go to the spool as they are; consumers read only the spool, so
        the RAM copy is dropped."""
        from ..exchange.filesystem import SpoolHandle

        with t.lock:
            bufs = t.buffers
        if inj.enabled():
            # chaos site: flip a bit in a spool-bound frame AFTER
            # serialization — the commit still happens, so the
            # corruption is only detectable by the read-side CRC
            bufs = {
                bid: [
                    inj.corrupt("spool_write_corrupt", fr, key=t.task_id)
                    for fr in frames
                ]
                for bid, frames in bufs.items()
            }
        t_w = time.perf_counter()
        with TRACER.span("spool_write", path=spool_path):
            SpoolHandle(spool_path).write_buffers(bufs)
        t.stats["spoolWriteS"] = time.perf_counter() - t_w
        t.stats["spoolWriteBytes"] = sum(
            len(f) for fs in bufs.values() for f in fs)
        with t.lock:
            t.buffers = {}

    def _make_executor(self, plan, config, splits_by_scan, remote_pages, dfs):
        """The fragment executor of one task, on this worker's device.
        When the session asks for the cross-host mesh (``cross_host_mesh``)
        and this worker has more than one local shard, a slice-eligible
        fragment runs as this host's slice over its shards; any other
        fragment (final merges, Sort, Window, writers, ...) takes the
        one-device FragmentExecutor, so a mixed plan is still one query.
        A slice that fails fails the task: nothing re-runs it."""
        config["device"] = self.device
        want = config.get("cross_host_mesh", False)
        if isinstance(want, str):
            want = want.strip().lower() not in ("false", "0", "no", "off", "")
        if want and self.local_devices > 1:
            from ..parallel.mesh_executor import (
                CrossHostFragmentExecutor,
                slice_eligible,
            )

            if slice_eligible(plan):
                return CrossHostFragmentExecutor(
                    self.catalogs, config, splits_by_scan, remote_pages, dfs,
                    mesh=[self.device] * self.local_devices,
                )
        return FragmentExecutor(
            self.catalogs, config, splits_by_scan, remote_pages, dfs
        )

    # ------------------------------------------------------------------
    def _run(self, t: TaskExecution):
        with t.lock:
            if t.state != "PLANNED":
                return
            t.state = "RUNNING"
        REGISTRY.counter(
            "trino_tpu_task_created_total", "Tasks accepted by this worker"
        ).inc()
        # the coordinator's traceparent rides the task doc: this thread
        # has no local span stack, so the task span joins the query trace
        # through the W3C context (the Dapper cross-process edge)
        traceparent = t.doc.get("traceparent")
        try:
            with TRACER.span(
                "task", traceparent=traceparent, task_id=t.task_id
            ) as task_span:
                self._run_inner(t, task_span)
        finally:
            # export (when an exporter is attached) without waiting for the
            # coordinator: worker spans must survive task teardown
            TRACER.flush()

    def _run_inner(self, t: TaskExecution, task_span):
        try:
            doc = t.doc
            config = dict(doc.get("properties") or {})
            inj = self._injector_for(config.get("fault_injection"))
            mode = self.fault_injector.take_task_mode(t.task_id)
            if mode is not None:
                if mode.startswith("STALL"):
                    # straggler injection (FailureInjector TASK_MANAGEMENT
                    # _TIMEOUT analog): sleep, then run normally — the
                    # speculative scheduler should win with a backup attempt
                    import time as _time

                    _time.sleep(float(mode.split(":", 1)[1]))
                else:
                    raise RuntimeError(f"injected task failure ({mode})")
            if inj.fires("task_run", key=t.task_id):
                raise RuntimeError(
                    "injected task failure "
                    f"(fault_injection site task_run, task {t.task_id})"
                )
            inj.stall("task_stall", key=t.task_id)
            # worker-LEVEL chaos (constructor fault_injection, not the
            # session-shipped spec): node-churn sites that only make
            # sense scoped to one victim process
            winj = self.fault_injector
            if winj.fires("worker_death", key=t.task_id):
                # seeded kill -9 analog: vanish mid-task with no
                # cleanup, no spool flush, no FAILED state — the
                # coordinator must discover the death via heartbeats
                os._exit(137)
            winj.stall("task_stall", key=t.task_id)
            plan = plan_from_json(doc["fragment"])
            splits_by_scan: Dict[int, List[Split]] = {}
            for k, sps in (doc.get("splits") or {}).items():
                splits_by_scan[int(k)] = [decode_value(s) for s in sps]
            sources = doc.get("sources") or {}
            client = ExchangeClient(
                retries=config.get("exchange_retry_attempts"),
                retry_budget_s=config.get("exchange_retry_budget_s"),
                fault_injector=inj if inj.enabled() else None,
                traceparent=task_span.traceparent,
                own_uri=self.own_uri,
            )
            remote_pages = client.fetch_sources(
                {int(fid): list(locs) for fid, locs in sources.items()}
            )
            with t.lock:
                if t.state == "ABORTED":
                    return
            dfs = None
            if config.get("dynamic_filtering", True):
                from ..exec.dynamic_filter import collect_dynamic_filters

                dfs = collect_dynamic_filters(plan, remote_pages)
            if self.memory_manager is not None:
                # node-level arbitration: fragments of every query on
                # this worker reserve host + HBM bytes from one manager,
                # tagged by query id (task ids are {query}.{frag}.{i})
                config["memory_manager"] = self.memory_manager
                config["query_id"] = t.task_id.rsplit(".", 2)[0]
                if inj.enabled():
                    self.memory_manager.fault_injector = inj
            config["task_id"] = t.task_id
            if self.supervisor is not None:
                # same sharing rule as memory: one supervisor per node,
                # configured by whichever task runs next (session props
                # are uniform across a query's tasks); a fault fails the
                # task, nothing re-runs on the CPU
                self.supervisor.configure(config)
                if inj.enabled():
                    self.supervisor.fault_injector = inj
                config["device_supervisor"] = self.supervisor
            if config.get("operator_stats"):
                # per-operator timeline: forces the eager (non-jitted)
                # path so _TraceCtx can bracket every operator visit
                config["collect_node_stats"] = True
            ex = self._make_executor(plan, config, splits_by_scan, remote_pages, dfs)
            # blocked-on-exchange: the wall this task spent pulling its
            # remote source pages before any operator could run
            ex.blocked_exchange_s = float(
                getattr(client, "last_fetch_wall_s", 0.0)
            )
            import time as _time

            _t0 = _time.time()
            with TRACER.span("fragment_execute", task_id=t.task_id), \
                    kn.counting_launches() as launches:
                page = ex.execute(plan)
            wall_s = _time.time() - _t0
            with t.lock:
                if t.state == "ABORTED":
                    # the executor freed its reservation when its run
                    # ended; the page's tensors go with this frame
                    return
            from ..obs import opstats as _opstats

            frames = (
                _opstats.frames_from_plan(
                    plan, ex.node_stats,
                    blocked_memory_s=ex.blocked_memory_s,
                    blocked_exchange_s=ex.blocked_exchange_s,
                )
                if ex.node_stats else []
            )
            op_rollup = _opstats.task_rollup(
                frames, wall_s=wall_s,
                blocked_memory_s=ex.blocked_memory_s,
                blocked_exchange_s=ex.blocked_exchange_s,
            )
            op_rollup["outputRows"] = page.count
            t.stats = {
                # the exchange in: the remote sources' frame bytes, the
                # wall spent pulling them and the part of it decoding
                "exchangeBytes": int(client.last_fetch_bytes),
                "blockedExchangeS": ex.blocked_exchange_s,
                "deserializeS": float(client.last_deserialize_s),
                # fault-tolerant mode: the part of it read from spool files
                "spoolReadBytes": int(client.last_spool_bytes),
                "spoolReadS": float(client.last_spool_read_s),
                "dynamicFilterRowsPruned": ex.df_rows_pruned,
                "scanBytes": ex.scan_bytes,
                "outputRows": page.count,
                "wallMillis": int(wall_s * 1000),
                # per-kernel compile wall / recompiles / padding — rides
                # the existing stats rollup back to the coordinator
                "kernelProfile": getattr(ex, "kernel_profile", None),
                # this task's CUDA kernel launches, by wrapper name
                "kernelLaunches": dict(launches),
                # this worker process's device peak so far (None on the CPU)
                "devicePeakBytes": (
                    int(torch.cuda.max_memory_allocated(self.device))
                    if self.device.type == "cuda" else None),
                # pipeline -> task OperatorStats rollup (frames only when
                # operator_stats forced the instrumented eager path)
                "operatorStats": op_rollup,
            }
            # stage-rollup summaries piggyback on the next announcement
            # round (the coordinator's live straggler detector input)
            self.recent_opstats.append({
                "taskId": t.task_id,
                "wallS": wall_s,
                "outputRows": int(page.count),
                "blockedExchangeS": ex.blocked_exchange_s,
                "blockedMemoryS": ex.blocked_memory_s,
            })
            t_part = time.perf_counter()
            out = doc.get("output") or {}
            part = out.get("partitioning", "single")
            nbuffers = int(out.get("nbuffers", 1))
            keys = list(out.get("keys") or [])
            if part == "hash" and nbuffers > 1:
                parts = partition_page(page, keys, nbuffers)
            elif part == "arbitrary" and nbuffers > 1:
                # round-robin redistribution (RandomExchanger /
                # ArbitraryOutputBuffer): no key affinity, pure balance
                parts = partition_page_round_robin(page, nbuffers)
            else:
                # single and broadcast: everything in buffer 0 (broadcast
                # consumers all read buffer 0 — BroadcastOutputBuffer)
                parts = [page]
            t_ser = time.perf_counter()
            frames = {
                bid: [serialize_page(c) for c in chunk_page(p)]
                for bid, p in enumerate(parts)
            }
            # the exchange out: partitioning and serializing the output
            t.stats["partitionS"] = t_ser - t_part
            t.stats["serializeS"] = time.perf_counter() - t_ser
            t.stats["outputBytes"] = sum(
                len(f) for fs in frames.values() for f in fs)
            with t.lock:
                if t.state == "ABORTED":
                    return
                t.state = "FLUSHING"
                t.buffers.update(frames)
                for bid in range(len(parts), nbuffers):
                    t.buffers[bid] = []
            # the output lives on as frames: free its device pages before
            # the spool write, which may take seconds
            del page, parts
            spool_path = doc.get("spool_path")
            if spool_path:
                self._spool(t, spool_path, inj)
            with t.lock:
                if t.state == "ABORTED":
                    return
                t.complete = True
                t.state = "FINISHED"
        except Exception as e:  # propagated to consumers + coordinator
            REGISTRY.counter(
                "trino_tpu_task_failed_total", "Tasks that ended FAILED"
            ).inc()
            with t.lock:
                if t.state != "ABORTED":
                    t.state = "FAILED"
                    if isinstance(e, RemoteTaskError):
                        t.error = str(e)
                    else:
                        t.error = f"{type(e).__name__}: {e}"
                    t.traceback = traceback.format_exc()


class _WorkerHandler(BaseHTTPRequestHandler):
    worker: "WorkerServer" = None

    def log_message(self, fmt, *args):
        pass

    def _json(self, code: int, doc: dict, headers: Optional[dict] = None):
        body = json.dumps(doc).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _binary(self, code: int, body: bytes, headers: dict):
        self.send_response(code)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # ------------------------------------------------------------------
    def do_POST(self):
        parts = self.path.strip("/").split("/")
        tm = self.worker.task_manager
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            if self.worker.state != "ACTIVE":
                # drain the request body first or the connection wedges
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                self._json(
                    409,
                    {"error": "worker is not ACTIVE "
                              f"(state {self.worker.state})"},
                )
                return
            n = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(n))
            # W3C trace context arrives as an HTTP header (scheduler
            # dispatch); stash it on the doc for the task thread
            tp = self.headers.get("traceparent")
            if tp and "traceparent" not in doc:
                doc["traceparent"] = tp
            t = tm.create_or_update(parts[2], doc)
            self._json(200, {"taskId": t.task_id, "state": t.state})
            return
        if parts == ["v1", "memory", "kill"]:
            # coordinator low-memory-killer verdict: wake this node's
            # blocked reservations of the victim with QueryKilledError
            n = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(n) or b"{}")
            self.worker.memory_manager.kill(
                doc.get("queryId", ""), doc.get("reason", "killed")
            )
            self._json(200, {"killed": doc.get("queryId", "")})
            return
        if (
            len(parts) == 4
            and parts[:2] == ["v1", "task"]
            and parts[3] == "fail"
        ):
            n = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(n) or b"{}")
            tm.inject_failure(parts[2], doc.get("mode", "TASK_FAILURE"))
            self._json(200, {"injected": parts[2]})
            return
        self._json(404, {"error": "not found"})

    def do_PUT(self):
        if self.path == "/v1/info/state":
            n = int(self.headers.get("Content-Length", 0))
            want = json.loads(self.rfile.read(n) or b'""')
            if want == "DRAINING":
                # graceful decommission: refuse new tasks, finish running
                # ones (spools flush before a task FINISHES), then
                # announce DRAINED and stay up until terminated
                self.worker.start_drain()
                self._json(200, {"state": self.worker.state})
                return
            if want != "SHUTTING_DOWN":
                self._json(400, {"error": f"unsupported state {want}"})
                return
            # respond before initiating shutdown: the drain may stop the
            # HTTP server before this response flushes otherwise
            self.worker.state = "SHUTTING_DOWN"
            self._json(200, {"state": self.worker.state})
            self.wfile.flush()
            self.worker.start_graceful_shutdown()
            return
        self._json(404, {"error": "not found"})

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        w = self.worker
        if self.path == "/metrics":
            body = REGISTRY.render_prometheus().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/v1/info":
            device = w.supervisor.snapshot()
            state = w.state
            if state == "ACTIVE" and device["state"] != "ACTIVE":
                # a sick device downgrades the advertised node state
                # (QUARANTINED refuses work until the canary passes)
                state = device["state"]
            self._json(200, {
                "nodeId": w.node_id,
                "nodeVersion": {"version": "trino-tpu 0.1"},
                "environment": w.device.type,
                "coordinator": False,
                "state": state,
                "device": device,
                "topology": w.topology,
                "uptime": f"{time.time() - w.started:.0f}s",
            })
            return
        if self.path == "/v1/memory":
            self._json(200, w.memory_manager.snapshot())
            return
        if self.path == "/v1/status":
            self._json(200, {
                "nodeId": w.node_id,
                "state": w.state,
                "activeTasks": sum(
                    1
                    for t in w.task_manager.tasks.values()
                    if t.state in ("PLANNED", "RUNNING", "FLUSHING")
                ),
                "totalTasks": len(w.task_manager.tasks),
                "lifetimeTasks": w.task_manager.tasks_created,
            })
            return
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            t = w.task_manager.tasks.get(parts[2])
            if t is None:
                self._json(404, {"error": "no such task"})
                return
            self._json(200, {
                "taskId": t.task_id,
                "state": t.state,
                "error": t.error,
                "stats": t.stats,
            })
            return
        if len(parts) == 6 and parts[:2] == ["v1", "task"] and parts[3] == "results":
            self._serve_results(parts[2], int(parts[4]), int(parts[5]))
            return
        self._json(404, {"error": "not found"})

    def _serve_results(self, task_id: str, buffer_id: int, token: int):
        """Long-poll page pull (HttpPageBufferClient GET)."""
        w = self.worker
        deadline = time.time() + 1.0
        while True:
            t = w.task_manager.tasks.get(task_id)
            if t is None:
                self._json(404, {"error": "no such task"})
                return
            with t.lock:
                state = t.state
                if state == "FAILED" or state == "ABORTED":
                    err = (t.error or "task failed").encode()
                    self._binary(410, err, {"X-Task-State": state})
                    return
                if t.complete:
                    frames = t.buffers.get(buffer_id, [])
                    if token < len(frames):
                        body = frames[token]
                        last = token + 1 >= len(frames)
                        self._binary(200, body, {
                            "X-Task-State": state,
                            "X-Next-Token": str(token + 1),
                            "X-Buffer-Complete": "true" if last else "false",
                        })
                    else:
                        self._binary(200, b"", {
                            "X-Task-State": state,
                            "X-Buffer-Complete": "true",
                        })
                    return
            if time.time() > deadline:
                self._binary(204, b"", {"X-Task-State": state})
                return
            time.sleep(0.01)

    def do_DELETE(self):
        parts = self.path.strip("/").split("/")
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            self.worker.task_manager.delete(parts[2])
            self._json(200, {})
            return
        self._json(404, {"error": "not found"})


class WorkerServer:
    """One worker node (TestingTrinoServer worker-role analog)."""

    def __init__(
        self,
        catalogs: CatalogManager,
        coordinator_uri: Optional[str] = None,
        port: int = 0,
        announce_interval: float = 0.25,
        fault_injection=None,
        memory_bytes: Optional[int] = None,
        device_memory_bytes: Optional[int] = None,
        host: Optional[str] = None,
        process_index: Optional[int] = None,
        device=None,
        local_devices: Optional[int] = None,
    ):
        from ..memory import LocalMemoryManager
        from ..memory.pools import detect_device_bytes

        self.device = D.resolve(device)
        # logical shards on this worker's device (the cross-host mesh's
        # slice width): by default one a visible card, one on the CPU
        if local_devices is None:
            local_devices = (max(int(torch.cuda.device_count()), 1)
                             if self.device.type == "cuda" else 1)
        self.local_devices = int(local_devices)
        self.node_id = f"worker-{uuid.uuid4().hex[:8]}"
        # multi-host identity is OPT-IN: only a worker explicitly placed
        # in a cluster topology (host id / process index from the
        # bootstrap harness) announces itself as a host-sized capacity
        # unit; plain workers never trip the HOST_GONE machinery
        self.topology: Optional[dict] = None
        if host is not None or process_index is not None:
            from ..distributed import local_topology

            self.topology = local_topology(
                host=host, process_index=process_index,
                local_devices=self.local_devices,
            )
        self.memory_manager = LocalMemoryManager(
            memory_bytes if memory_bytes is not None else (8 << 30),
            device_bytes=(
                device_memory_bytes
                if device_memory_bytes is not None
                else detect_device_bytes(device=self.device)
            ),
            node_id=self.node_id,
        )
        from ..runtime import DeviceSupervisor

        self.supervisor = DeviceSupervisor(node_id=self.node_id,
                                           device=self.device)
        self.task_manager = TaskManager(
            catalogs,
            memory_manager=self.memory_manager,
            supervisor=self.supervisor,
            device=self.device,
            local_devices=self.local_devices,
        )
        if fault_injection:
            # operator-configured chaos (heartbeat drops etc.) rides the
            # worker-level injector, alongside the /fail endpoint modes
            self.task_manager.fault_injector = FaultInjector.from_spec(
                fault_injection
            )
        self.started = time.time()
        handler = type("Handler", (_WorkerHandler,), {"worker": self})
        # match the coordinator's raised listen backlog: a task fan-out
        # from many concurrent queries connects in bursts
        server_cls = type(
            "WorkerHTTPServer", (ThreadingHTTPServer,),
            {"request_queue_size": 128},
        )
        self.httpd = server_cls(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.task_manager.own_uri = self.uri
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self.coordinator_uri = coordinator_uri
        self.announce_interval = announce_interval
        self._stop = threading.Event()
        self.announcer = threading.Thread(target=self._announce_loop, daemon=True)
        # lifecycle (NodeState analog): ACTIVE -> DRAINING -> DRAINED
        # (graceful decommission, keeps announcing) or ACTIVE ->
        # SHUTTING_DOWN (GracefulShutdownHandler: drain then stop)
        self.state = "ACTIVE"

    @property
    def uri(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "WorkerServer":
        self.thread.start()
        if self.coordinator_uri:
            self.announcer.start()
        return self

    def stop(self):
        self._stop.set()
        self.httpd.shutdown()
        # a stopped worker refuses connections at once, as a dead process
        # does: a listening socket nobody serves would hold every caller
        # (a consumer's fetch, the scheduler's POST) to its socket timeout
        self.httpd.server_close()

    def start_drain(self):
        """PUT /v1/info/state DRAINING (NodeState.DRAINING analog):
        refuse new tasks, keep ANNOUNCING (unlike SHUTTING_DOWN — the
        coordinator must watch this node walk DRAINING -> DRAINED), wait
        for running tasks to finish (each commits/flushes its spool
        before reaching FINISHED), then advertise DRAINED.  The process
        stays up serving spools/results until the operator terminates
        it; the coordinator escalates the ensuing silence to GONE."""
        if self.state != "ACTIVE":
            return
        self.state = "DRAINING"

        def drain():
            deadline = time.time() + 30.0
            while time.time() < deadline:
                active = sum(
                    1
                    for t in self.task_manager.tasks.values()
                    if t.state in ("PLANNED", "RUNNING", "FLUSHING")
                )
                if active == 0:
                    break
                time.sleep(0.05)
            # telemetry durability barrier: DRAINED is a promise that
            # this node's spans, dispatch ring, and incident journal are
            # on disk: the operator terminates the process right after
            self._flush_telemetry()
            self.state = "DRAINED"

        threading.Thread(target=drain, daemon=True).start()

    def _flush_telemetry(self):
        """Flush every telemetry sink before advertising DRAINED (or
        shutting the listener down): exporter-buffered spans, the
        flight-recorder mmap ring, and the incident-journal segments."""
        try:
            TRACER.flush()
        except Exception:  # noqa: BLE001 — flush must not block a drain
            pass
        try:
            rec = getattr(self.supervisor, "flight_recorder", None)
            if rec is not None:
                rec.sync()
        except Exception:  # noqa: BLE001
            pass
        try:
            from ..obs import journal

            journal.sync()
        except Exception:  # noqa: BLE001
            pass
        try:
            from ..obs import compile_observatory

            compile_observatory.sync()
        except Exception:  # noqa: BLE001
            pass

    def start_graceful_shutdown(self):
        """PUT /v1/info/state SHUTTING_DOWN: drain then stop (the
        reference's GracefulShutdownHandler)."""
        self.state = "SHUTTING_DOWN"
        self._stop.set()  # stop announcing: scheduler drops this node

        def drain():
            time.sleep(0.2)  # let in-flight responses flush
            deadline = time.time() + 30.0
            while time.time() < deadline:
                active = sum(
                    1
                    for t in self.task_manager.tasks.values()
                    if t.state in ("PLANNED", "RUNNING", "FLUSHING")
                )
                if active == 0:
                    break
                time.sleep(0.05)
            self._flush_telemetry()
            self.httpd.shutdown()

        threading.Thread(target=drain, daemon=True).start()

    # ------------------------------------------------------------------
    def _compile_snapshot(self):
        """This node's compile-observatory piggyback for one
        announcement round (None on any failure: announcing must never
        die on a telemetry bug)."""
        try:
            from ..obs import compile_observatory

            return compile_observatory.get_observatory().announce_snapshot()
        except Exception:  # noqa: BLE001
            return None

    def _announce_loop(self):
        while not self._stop.is_set():
            winj = self.task_manager.fault_injector
            if winj.fires("heartbeat", key=self.node_id) or winj.fires(
                "announce_drop", key=self.node_id
            ):
                # injected missed announcement: the coordinator's
                # failure detector sees this node go silent (node-churn
                # chaos uses announce_drop to model loss WITHOUT death —
                # pings keep succeeding, so SUSPECT must recover)
                self._stop.wait(self.announce_interval)
                continue
            try:
                # quarantined devices re-probe on the announcer cadence:
                # recovery is discovered even while no tasks arrive
                self.supervisor.maybe_probe()
                # rebuilt every round: the announcement piggybacks this
                # node's live pool snapshot for the coordinator-side
                # ClusterMemoryManager (heartbeat memory view) and the
                # device-health snapshot for scheduler routing
                body = json.dumps({
                    "nodeId": self.node_id,
                    "uri": self.uri,
                    # lifecycle announcements drive the coordinator's
                    # node state machine (DRAINING/DRAINED visibility)
                    "state": self.state,
                    "memory": self.memory_manager.snapshot(),
                    "device": self.supervisor.snapshot(),
                    # completed-task wall/row rollups for the
                    # coordinator's live straggler detector
                    "opstats": list(self.task_manager.recent_opstats),
                    # compile-observatory piggyback: per-cause counts,
                    # shape-census sketch, and new ledger events since
                    # the last round (coordinator merges engine-wide)
                    "compiles": self._compile_snapshot(),
                    # multi-host slice identity (None for plain workers)
                    "topology": self.topology,
                }).encode()
                req = urllib.request.Request(
                    f"{self.coordinator_uri}/v1/announcement",
                    data=body,
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=2.0).read()
            except Exception:
                pass  # coordinator not up yet / transient
            self._stop.wait(self.announce_interval)
