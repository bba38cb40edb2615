"""Cluster runtime: the topology registry of host-sized units.

Counterpart of trino_tpu/distributed/ (topology.py; ``bootstrap`` and
the cross-host mesh wait for the cross-host slice).
"""
from .topology import (  # noqa: F401
    TOPOLOGY_FIELDS,
    ClusterTopology,
    HostSlice,
    local_topology,
)
