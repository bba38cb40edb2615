"""Cluster runtime: the topology registry of host-sized units.

Counterpart of trino_tpu/distributed/ (topology.py).
"""
from .topology import (  # noqa: F401
    TOPOLOGY_FIELDS,
    ClusterTopology,
    HostSlice,
    bootstrap,
    local_topology,
)
