"""Memory management of the port.

Counterpart of trino_tpu/memory/ (reference parity: the memory/ package
around ClusterMemoryManager.java:91):

- pools.LocalMemoryManager — per-node general/reserved host pools plus
  a device tier; revoke -> block -> clean-error reservations
- cluster.ClusterMemoryManager — coordinator view fed by heartbeat
  snapshots; enforces query_max_total_memory_bytes and runs the killer
- killer.LowMemoryKiller — pluggable victim-selection policies
- admission.MemoryAdmissionController — FIFO gate that queues queries
  until their estimated peak fits
"""
from .admission import MemoryAdmissionController
from .cluster import CLUSTER_OOM_MESSAGE, ClusterMemoryManager
from .killer import (
    LowMemoryKiller,
    TotalReservationLowMemoryKiller,
    TotalReservationOnBlockedNodesLowMemoryKiller,
    create_killer,
)
from .pools import (
    DEVICE_POOL,
    GENERAL_POOL,
    RESERVED_POOL,
    LocalMemoryManager,
    QueryKilledError,
    detect_device_bytes,
)

__all__ = [
    "CLUSTER_OOM_MESSAGE",
    "ClusterMemoryManager",
    "DEVICE_POOL",
    "GENERAL_POOL",
    "LocalMemoryManager",
    "LowMemoryKiller",
    "MemoryAdmissionController",
    "QueryKilledError",
    "RESERVED_POOL",
    "TotalReservationLowMemoryKiller",
    "TotalReservationOnBlockedNodesLowMemoryKiller",
    "create_killer",
    "detect_device_bytes",
]
