"""DistributedQueryRunner: N servers in one process with real transport.

Reference parity: testing/trino-testing/.../DistributedQueryRunner.java:94 —
one coordinator + N workers as real HTTP servers on ephemeral ports in a
single process, real discovery announcements, real page exchanges; the
standard way the reference tests its multi-node story.

Counterpart of trino_tpu/testing/runner.py.  Every server runs on one
device (``device``: CUDA unless the caller passes "cpu").  On the card,
the in-process workers share it: each worker's device pool is the card's
memory divided by the runner's in-process workers (and, once the
autoscaler is on, by those plus its ``max_workers`` subprocess workers).
A subprocess worker opens its own CUDA context on the same card and
loads the kernel libraries the package's build directory already holds;
it runs no nvcc.  ``SubprocessCoordinator`` is a coordinator the OS can
kill -9 (the recovery harness), with subprocess workers on its device.
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


# the checkout holding this package: child processes import it from here
# whatever their working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_subprocess_worker(
    coordinator_uri: str,
    catalog_spec: Sequence[Tuple[str, str, dict]],
    fault_injection: Optional[dict] = None,
    local_devices: Optional[int] = None,
    process_index: Optional[int] = None,
    host: Optional[str] = None,
    device=None,
    device_memory_bytes: Optional[int] = None,
) -> Tuple[subprocess.Popen, str, str]:
    """Spawn one worker as a real child process (worker_main.py) and
    block until it prints its announce line; returns (Popen, node_id,
    uri).  Shared by the in-process runner and SubprocessCoordinator —
    the caller decides how to wait for discovery adoption.

    ``local_devices``/``process_index``/``host`` turn the child into a
    host-sized capacity unit of a multi-host cluster: the process runs
    ``local_devices`` logical shards on its device and announces a
    topology the coordinator tracks (HOST_GONE on loss).  The child runs
    on ``device`` (CUDA unless "cpu") and imports this package from its
    checkout whatever the working directory."""
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
    if local_devices is not None:
        cmd += ["--local-devices", str(int(local_devices))]
    if device_memory_bytes is not None:
        cmd += ["--device-memory-bytes", str(int(device_memory_bytes))]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
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
        local_devices: Optional[int] = None,
        process_index: Optional[int] = None,
        host: Optional[str] = None,
        device_memory_bytes: Optional[int] = None,
    ) -> tuple:
        """Spawn a worker as a real child process (worker_main.py) and
        wait until it announces.  Unlike the in-process workers this one
        can be SIGKILLed for true kill -9 chaos: no drain, no goodbye,
        its sockets refuse instantly.  Returns (Popen, node_id, uri).

        With ``local_devices`` (and optional ``process_index``/``host``
        identity) the child joins as a host-sized capacity unit: a
        process running that many logical shards on the runner's
        device, announcing a topology the coordinator's ClusterTopology
        tracks.  ``local_devices`` without a process index takes the
        next one (host ``host{i}``).  ``device_memory_bytes`` is its
        device pool (the card's memory when None)."""
        if local_devices is not None and process_index is None:
            process_index = self._next_process_index
        if process_index is not None:
            self._next_process_index = max(
                self._next_process_index, process_index + 1
            )
            if host is None:
                host = f"host{process_index}"
        proc, node_id, uri = spawn_subprocess_worker(
            self.coordinator.uri, self._catalog_spec, fault_injection,
            local_devices=local_devices, process_index=process_index,
            host=host, device=self.device,
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

    def enable_autoscaler(self, local_devices=None, **overrides):
        """Turn on the coordinator autoscaler with this runner's
        subprocess-worker spawner as the scale-out path: new capacity
        arrives as real child processes on the runner's device (late
        joiners, schedulable the moment they announce) and scale-in
        drains through the node lifecycle.  Returns the Autoscaler.

        ``local_devices`` makes the capacity unit HOST-sized: every
        admitted worker is a process running that many logical shards,
        with a fresh process index (a scale-out admits a host, a
        scale-in drains and retires one).

        The card's memory is shared out again first: the in-process
        workers and up to ``max_workers`` subprocess workers each get
        ``card // (in-process + max_workers)`` of device pool, so
        together they never exceed the card."""
        co = self.coordinator.coordinator
        max_workers = int(overrides.get("max_workers")
                          or co.session.properties.get("autoscale_max_workers") or 4)
        card = detect_device_bytes(device=self.device)
        share = None if card is None else card // (len(self.workers) + max_workers)
        if share is not None:
            for w in self.workers:
                w.memory_manager.device.size = min(
                    w.memory_manager.device.size, share)
        self.autoscale_device_bytes = share

        def scale_out():
            return self.add_subprocess_worker(local_devices=local_devices,
                                              device_memory_bytes=share)

        return co.enable_autoscaler(scale_out=scale_out, **overrides)

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


class SubprocessCoordinator:
    """A coordinator the OS can actually kill (coordinator_main.py).

    The crash-recovery harness: the coordinator runs as a real child
    process, so SIGKILL vaporizes its in-memory query state machine
    mid-flight — only the mmap'd WAL in ``coordinator_recovery_dir``
    survives.  ``restart()`` re-spawns it on the SAME port with the same
    properties, which is exactly the production recovery contract:
    surviving subprocess workers (spawned against the fixed URI)
    re-announce within a heartbeat, the WAL replays, FTE queries resume
    from committed spools, and clients polling query-id-addressed
    nextUris reconnect through the restart grace.  The coordinator and
    its workers run on ``device`` (CUDA unless "cpu"); each worker's
    device pool is ``worker_device_bytes`` (the card's memory when None).
    """

    def __init__(
        self,
        catalogs: Sequence[Tuple[str, str, dict]] = DEFAULT_CATALOGS,
        properties: Optional[dict] = None,
        port: int = 0,
        fault_injection: Optional[dict] = None,
        startup_timeout: float = 120.0,
        device=None,
        worker_device_bytes: Optional[int] = None,
    ):
        self.device = D.resolve(device)
        self.worker_device_bytes = worker_device_bytes
        self._catalog_spec = [
            (name, connector, dict(config))
            for name, connector, config in catalogs
        ]
        self.properties = dict(properties or {})
        self.fault_injection = fault_injection
        self.startup_timeout = float(startup_timeout)
        # (Popen, node_id, uri) of workers spawned via add_worker; they
        # outlive a coordinator kill (that's the point) and re-announce
        # to the same URI once it rebinds
        self.subprocess_workers: List[tuple] = []
        self.proc: Optional[subprocess.Popen] = None
        self.uri = ""
        self.port = int(port)
        self.node_id = ""
        self._spawn(self.port, fault_injection)

    def _spawn(self, port: int, fault_injection: Optional[dict]):
        cmd = [
            sys.executable, "-m", "trino_tpu_torch.server.coordinator_main",
            "--port", str(port), "--device", self.device.type,
            "--catalogs", json.dumps(
                [[n, c, cfg] for n, c, cfg in self._catalog_spec]
            ),
            "--properties", json.dumps(self.properties),
        ]
        if fault_injection:
            cmd += ["--fault-injection", json.dumps(fault_injection)]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env,
        )
        line = self.proc.stdout.readline()  # blocks until it binds
        if not line:
            self.proc.kill()
            raise RuntimeError(
                "subprocess coordinator exited before announcing "
                f"(rc={self.proc.poll()})"
            )
        doc = json.loads(line)
        self.uri, self.port = doc["uri"], int(doc["port"])
        self.node_id = doc["nodeId"]

    # ------------------------------------------------------------------
    def status(self) -> dict:
        import urllib.request

        with urllib.request.urlopen(
            f"{self.uri}/v1/status", timeout=5.0
        ) as resp:
            return json.loads(resp.read())

    def wait_for_workers(self, n: int, timeout: float = 60.0):
        """Poll /v1/status until ``n`` workers are ACTIVE (the
        coordinator is out-of-process, so its node manager is only
        reachable over HTTP)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                if self.status().get("activeWorkers", 0) >= n:
                    return
            except Exception:
                pass
            time.sleep(0.1)
        raise RuntimeError(
            f"fewer than {n} workers announced to {self.uri} "
            f"in {timeout}s"
        )

    def add_worker(
        self, fault_injection: Optional[dict] = None,
        startup_timeout: float = 60.0,
    ) -> tuple:
        """Spawn a subprocess worker against this coordinator and wait
        until discovery adopts it.  Returns (Popen, node_id, uri)."""
        entry = spawn_subprocess_worker(
            self.uri, self._catalog_spec, fault_injection,
            device=self.device,
            device_memory_bytes=self.worker_device_bytes,
        )
        self.subprocess_workers.append(entry)
        self.wait_for_workers(
            len(self.subprocess_workers), startup_timeout
        )
        return entry

    def sigkill(self) -> int:
        """kill -9 the coordinator: no drain, no flush beyond the mmap'd
        WAL pages, every client socket refuses instantly.  Workers stay
        up.  Returns the pid that died."""
        pid = self.proc.pid
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()
        return pid

    def restart(
        self, fault_injection: Optional[dict] = None,
        startup_timeout: Optional[float] = None,
    ) -> "SubprocessCoordinator":
        """Re-spawn on the SAME port with the same properties (recovery
        dir included).  A fresh fault-injection spec replaces the old
        one — the restarted coordinator usually must NOT re-arm the
        crash site that killed its predecessor."""
        if self.proc is not None and self.proc.poll() is None:
            self.sigkill()
        deadline = time.time() + (startup_timeout or self.startup_timeout)
        last_err = None
        while True:
            # the dying process's socket may linger in the kernel for a
            # beat even after SIGKILL; same-port rebind retries briefly
            try:
                self._spawn(self.port, fault_injection)
                return self
            except RuntimeError as e:
                last_err = e
                if time.time() >= deadline:
                    raise
                time.sleep(0.2)

    def stop(self):
        for proc, _, _ in self.subprocess_workers:
            try:
                proc.kill()
            except Exception:
                pass
            proc.wait()
        self.subprocess_workers = []
        if self.proc is not None:
            try:
                self.proc.kill()
            except Exception:
                pass
            self.proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
