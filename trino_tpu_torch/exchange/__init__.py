"""Counterpart of trino_tpu/exchange (copied): the spooled exchange of
fault-tolerant execution."""
from .filesystem import FileSystemExchangeManager, SpoolHandle

__all__ = ["FileSystemExchangeManager", "SpoolHandle"]
