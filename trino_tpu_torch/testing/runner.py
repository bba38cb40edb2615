"""DistributedQueryRunner: N servers in one process with real transport.

Reference parity: testing/trino-testing/.../DistributedQueryRunner.java:94 —
one coordinator + N workers as real HTTP servers on ephemeral ports in a
single process, real discovery announcements, real page exchanges; the
standard way the reference tests its multi-node story.

Counterpart of trino_tpu/testing/runner.py (without SubprocessCoordinator
and the autoscaler hook, which come with recovery and the autoscaler).  Every
server runs on one device (``device``: CUDA unless the caller passes
"cpu").  On the card, the in-process workers share it: each worker's
device pool is the card's memory divided by the runner's in-process
workers.  A subprocess worker opens its own CUDA context on the same
card and loads the kernel libraries the package's build directory
already holds.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

from .. import device as D
from ..catalog import CatalogManager
from ..client.client import StatementClient
from ..connectors.blackhole import BlackholeConnectorFactory
from ..connectors.memory import MemoryConnectorFactory
from ..connectors.tpcds import TpcdsConnectorFactory
from ..connectors.tpch import TpchConnectorFactory
from ..memory.pools import detect_device_bytes
from ..server.coordinator import CoordinatorServer
from ..server.worker import WorkerServer
from ..session import Session

DEFAULT_CATALOGS: Tuple[Tuple[str, str, dict], ...] = (
    ("tpch", "tpch", {"tpch.scale-factor": 0.01}),
)


def _build_catalogs(catalogs: Sequence[Tuple[str, str, dict]]) -> CatalogManager:
    cm = CatalogManager()
    cm.register_factory(TpchConnectorFactory())
    cm.register_factory(TpcdsConnectorFactory())
    cm.register_factory(MemoryConnectorFactory())
    cm.register_factory(BlackholeConnectorFactory())
    try:
        from ..connectors.hive import HiveConnectorFactory

        cm.register_factory(HiveConnectorFactory())
    except ImportError:
        pass
    for name, connector, config in catalogs:
        cm.create_catalog(name, connector, config)
    return cm


def spawn_subprocess_worker(
    coordinator_uri: str,
    catalog_spec: Sequence[Tuple[str, str, dict]],
    fault_injection: Optional[dict] = None,
    process_index: Optional[int] = None,
    host: Optional[str] = None,
    device=None,
    device_memory_bytes: Optional[int] = None,
) -> Tuple[subprocess.Popen, str, str]:
    """Spawn one worker as a real child process (worker_main.py) and
    block until it prints its announce line; returns (Popen, node_id,
    uri).  Shared by the in-process runner and SubprocessCoordinator —
    the caller decides how to wait for discovery adoption.

    ``process_index``/``host`` turn the child into a host-sized capacity
    unit of a cluster: it announces a topology the coordinator tracks
    (HOST_GONE on loss).  The child runs on ``device`` (CUDA unless
    "cpu") and imports this package from its checkout whatever the
    working directory."""
    dev = D.resolve(device)
    cmd = [
        sys.executable, "-m", "trino_tpu_torch.server.worker_main",
        "--coordinator", coordinator_uri,
        "--device", dev.type,
        "--catalogs", json.dumps(
            [[n, c, cfg] for n, c, cfg in catalog_spec]
        ),
    ]
    if fault_injection:
        cmd += ["--fault-injection", json.dumps(fault_injection)]
    if host is not None:
        cmd += ["--host", str(host)]
    if process_index is not None:
        cmd += ["--process-index", str(process_index)]
    if device_memory_bytes is not None:
        cmd += ["--device-memory-bytes", str(int(device_memory_bytes))]
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=env,
    )
    line = proc.stdout.readline()  # blocks until the worker is up
    if not line:
        proc.kill()
        raise RuntimeError(
            f"subprocess worker exited before announcing (rc={proc.poll()})"
        )
    doc = json.loads(line)
    return proc, doc["nodeId"], doc["uri"]


class DistributedQueryRunner:
    """Coordinator + N workers, all in-process, real HTTP between them."""

    def __init__(
        self,
        workers: int = 2,
        catalogs: Sequence[Tuple[str, str, dict]] = DEFAULT_CATALOGS,
        properties: Optional[dict] = None,
        startup_timeout: float = 10.0,
        resource_groups: Optional[dict] = None,
        device=None,
    ):
        self.device = D.resolve(device)
        self.session = Session(config=properties, device=self.device)
        self._catalog_spec = [
            (name, connector, dict(config))
            for name, connector, config in catalogs
        ]
        for name, connector, config in catalogs:
            self.session.create_catalog(name, connector, config)
        self.coordinator = CoordinatorServer(
            self.session, distributed=True,
            resource_groups=resource_groups, device=self.device,
        ).start()
        self.workers: List[WorkerServer] = []
        # real child processes (worker_main.py), killable with SIGKILL:
        # list of (Popen, node_id, uri)
        self.subprocess_workers: List[tuple] = []
        # monotone process-index allocator for host-sized capacity units
        self._next_process_index = 0
        # the in-process workers share one card: each gets its share
        card = detect_device_bytes(device=self.device)
        self.worker_device_bytes = (
            None if card is None else card // max(int(workers), 1)
        )
        for _ in range(workers):
            w = WorkerServer(
                _build_catalogs(catalogs), self.coordinator.uri,
                device=self.device,
                device_memory_bytes=self.worker_device_bytes,
            ).start()
            self.workers.append(w)
        self._wait_for_workers(workers, startup_timeout)
        self.client = StatementClient(self.coordinator.uri)

    def _wait_for_workers(self, n: int, timeout: float):
        deadline = time.time() + timeout
        nm = self.coordinator.coordinator.node_manager
        while time.time() < deadline:
            if len(nm.alive()) >= n:
                return
            time.sleep(0.05)
        raise RuntimeError(
            f"only {len(nm.alive())}/{n} workers announced in {timeout}s"
        )

    # ------------------------------------------------------------------
    def execute(self, sql: str):
        """Returns (columns, rows) via the real statement protocol."""
        return self.client.execute(sql)

    def rows(self, sql: str) -> List[tuple]:
        _, rows = self.execute(sql)
        return [tuple(r) for r in rows]

    def alive_workers(self) -> int:
        return len(self.coordinator.coordinator.node_manager.alive())

    def kill_worker(self, index: int = -1) -> WorkerServer:
        w = self.workers.pop(index)
        w.stop()
        return w

    # -- real-process churn (chaos harness) ----------------------------
    def add_subprocess_worker(
        self,
        fault_injection: Optional[dict] = None,
        startup_timeout: float = 60.0,
        process_index: Optional[int] = None,
        host: Optional[str] = None,
        device_memory_bytes: Optional[int] = None,
    ) -> tuple:
        """Spawn a worker as a real child process (worker_main.py) and
        wait until it announces.  Unlike the in-process workers this one
        can be SIGKILLed for true kill -9 chaos: no drain, no goodbye,
        its sockets refuse instantly.  Returns (Popen, node_id, uri).

        With a ``process_index`` (and optional ``host``) identity the
        child joins as a host-sized capacity unit, announcing a topology
        the coordinator's ClusterTopology tracks.  It runs on the
        runner's device; ``device_memory_bytes`` is its device pool
        (the card's memory when None)."""
        if process_index is not None:
            self._next_process_index = max(
                self._next_process_index, process_index + 1
            )
            if host is None:
                host = f"host{process_index}"
        proc, node_id, uri = spawn_subprocess_worker(
            self.coordinator.uri, self._catalog_spec, fault_injection,
            process_index=process_index, host=host, device=self.device,
            device_memory_bytes=device_memory_bytes,
        )
        nm = self.coordinator.coordinator.node_manager
        deadline = time.time() + startup_timeout
        while time.time() < deadline:
            if any(n == node_id for n, _ in nm.alive()):
                break
            time.sleep(0.05)
        else:
            proc.kill()
            raise RuntimeError(
                f"subprocess worker {node_id} never announced in "
                f"{startup_timeout}s"
            )
        entry = (proc, node_id, uri)
        self.subprocess_workers.append(entry)
        return entry

    def sigkill_subprocess_worker(self, index: int = -1) -> tuple:
        """kill -9 a subprocess worker: the process dies mid-whatever,
        with no chance to drain or announce.  Returns its entry."""
        entry = self.subprocess_workers.pop(index)
        proc = entry[0]
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        return entry

    def stop(self):
        for w in self.workers:
            w.stop()
        for proc, _, _ in self.subprocess_workers:
            try:
                proc.kill()
            except Exception:
                pass
            proc.wait()
        self.subprocess_workers = []
        self.coordinator.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

