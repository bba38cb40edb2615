"""Memory management of the port: one node's pools (pools.py).

Counterpart of trino_tpu/memory/, for the single-node path: the
LocalMemoryManager with its general, reserved and device pools.  The
cluster view, the low-memory killer and admission wait for the server
slice.
"""
from .pools import (
    DEVICE_POOL,
    GENERAL_POOL,
    RESERVED_POOL,
    LocalMemoryManager,
    QueryKilledError,
    detect_device_bytes,
)

__all__ = [
    "DEVICE_POOL",
    "GENERAL_POOL",
    "LocalMemoryManager",
    "QueryKilledError",
    "RESERVED_POOL",
    "detect_device_bytes",
]
