"""Cluster topology: who owns which slice of the cluster's devices.

Counterpart of trino_tpu/distributed/topology.py.  A cluster is a set of
worker processes discovered via announcements, each owning its local
shards (``--local-devices``; by default its CUDA cards):

  - ``bootstrap()`` places the process in the cluster.  Hosts exchange
    rows through the HTTP and spool exchanges, never through a device
    collective, so there is no global device list to join: without a
    distributed coordinator address it returns the local topology, and
    with one it raises (the JAX package's jax.distributed.initialize
    has no counterpart here).
  - ``local_topology()`` is one process's announcement document; it
    counts ``torch.cuda.device_count()`` cards (1 on the CPU) unless told
    its shard count.
  - ``ClusterTopology`` is the coordinator-side registry built from
    worker announcements: which node is which process, on which host,
    with how many local devices.  The HOST_GONE fault path reads the
    cluster's shape from here.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import threading
from typing import Dict, List, Optional

# the topology document carried in worker announcements and surfaced in
# system.runtime.nodes: lowerCamelCase wire fields
TOPOLOGY_FIELDS = (
    "host",
    "processIndex",
    "localDevices",
    "globalDevices",
    "processCount",
)


@dataclasses.dataclass
class HostSlice:
    """One process's slice of the global mesh, as announced."""

    node_id: str
    uri: str
    host: str
    process_index: int
    local_devices: int

    def to_doc(self) -> dict:
        return {
            "host": self.host,
            "processIndex": self.process_index,
            "localDevices": self.local_devices,
        }


def local_topology(
    host: Optional[str] = None,
    process_index: Optional[int] = None,
    local_devices: Optional[int] = None,
) -> dict:
    """This process's topology document (the announcement payload).

    Explicit arguments (the subprocess harness / CLI flags) win; absent
    those, the process is process 0 of 1 with its visible CUDA cards
    (one device when there is no card: the CPU).
    """
    if process_index is None:
        process_index = 0
    if local_devices is None:
        import torch

        try:
            local_devices = max(int(torch.cuda.device_count()), 1)
        except Exception:
            local_devices = 1
    return {
        "host": host or socket.gethostname(),
        "processIndex": process_index,
        "localDevices": local_devices,
        "globalDevices": local_devices,
        "processCount": 1,
    }


def bootstrap(coordinator_address: Optional[str] = None) -> dict:
    """This process's place in the cluster: its local topology document.

    A distributed coordinator address (passed, or in
    ``TRINO_TPU_DIST_COORDINATOR``) asks for one device list spanning
    every host, which the port does not build: each host runs its
    fragments over its own shards and rows cross hosts through the
    exchanges.  Such an address raises rather than being ignored."""
    addr = coordinator_address or os.environ.get("TRINO_TPU_DIST_COORDINATOR")
    if addr:
        raise RuntimeError(
            f"bootstrap: a distributed coordinator address ({addr}) asks for "
            "a device list spanning every host, which this package does not "
            "build; its hosts exchange rows over HTTP and the spool.  Start "
            "each host as a worker (worker_main --local-devices N) against "
            "the cluster's coordinator instead"
        )
    return local_topology()


class ClusterTopology:
    """Coordinator-side registry of host slices, fed by announcements.

    Thread-safe: announcements arrive on HTTP handler threads while the
    scheduler and autoscaler read the shape concurrently.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._slices: Dict[str, HostSlice] = {}

    def register(self, node_id: str, uri: str, topology: Optional[dict]):
        """Record (or refresh) a node's announced slice.  Nodes that
        announce without topology (pre-multi-host workers) are simply
        not host-sized units — they never appear here."""
        if not topology:
            return
        try:
            hs = HostSlice(
                node_id=node_id,
                uri=uri,
                host=str(topology.get("host", "")),
                process_index=int(topology.get("processIndex", 0)),
                local_devices=int(topology.get("localDevices", 1)),
            )
        except (TypeError, ValueError):
            return
        with self._lock:
            self._slices[node_id] = hs

    def forget(self, node_id: str) -> Optional[HostSlice]:
        with self._lock:
            return self._slices.pop(node_id, None)

    def slice_for(self, node_id: str) -> Optional[HostSlice]:
        with self._lock:
            return self._slices.get(node_id)

    def slices(self) -> List[HostSlice]:
        with self._lock:
            return sorted(
                self._slices.values(), key=lambda s: s.process_index
            )

    def process_count(self) -> int:
        with self._lock:
            return len(self._slices)

    def global_device_count(self) -> int:
        """Total devices across every registered slice — the size the
        one global logical mesh would have."""
        with self._lock:
            return sum(s.local_devices for s in self._slices.values())

    def hosts(self) -> List[str]:
        with self._lock:
            return sorted({s.host for s in self._slices.values()})
